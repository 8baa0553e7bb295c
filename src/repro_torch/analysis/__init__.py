"""Analysis of the port's steps: the analytic FLOP / byte model and the
roofline (copies of the reference's), the H100's link term, and the
collective counter that stands in for the reference's HLO parse."""
from repro_torch.analysis import analytic, collectives, links, roofline  # noqa: F401
