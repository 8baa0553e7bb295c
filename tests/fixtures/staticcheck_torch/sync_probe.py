"""A probe of torch hot-path hazards the JAX checker cannot see: the
reference's checker reports nothing here, the port's one finding on
each line marked ``expect:``."""
import torch


# staticcheck: hotpath
def tick(graphs):
    x = torch.ones(8, device="cuda")
    n = int(torch.argmax(x)[0])  # expect: hot-sync
    host = x.cpu()  # expect: hot-sync
    torch.cuda.synchronize()  # expect: hot-sync
    if (x > 0).any():  # expect: hot-sync
        n += 1
    idx = x.nonzero()  # expect: hot-sync
    pos = x[x > 0]  # expect: hot-sync
    for _ in range(2):
        graphs.append(torch.cuda.CUDAGraph())  # expect: capture-hazard
    return n, host, idx, pos


def replay_all(cap, xs):
    outs = []
    for x in xs:
        cap.inputs["x"].copy_(x)
        cap.replay()
        outs.append(cap.output)  # expect: graph-output-alias
    return torch.stack(outs)


# staticcheck: hotpath
def noise(x):
    return x + torch.rand(x.shape, device=x.device)  # expect: generator-discipline
