"""The weights of a run, drawn by the benchmark from the seed on the
device in one call and handed alike to the program and to the reference.

Leaves are taken in sorted name order from one standard normal draw:
a kernel of two or more dimensions is scaled by 1 / sqrt(fan_in) (torch's
[out, in, ...] layout; a sparse kernel's [K, Cin, Cout]: K * Cin), a norm's
scale is 1 + 0.1 z and every other vector 0.1 z. BN running statistics
start at mean 0 and variance 1.
"""

import math

import torch


def fan_in(shape):
    n = math.prod(shape)
    return n // shape[-1] if len(shape) == 3 else n // shape[0]


def draw(param_shapes, buffer_shapes, seed, device):
    """{name: tensor} for every parameter and float buffer named in the two
    {name: shape} maps."""
    names = sorted(param_shapes)
    total = sum(math.prod(param_shapes[n]) for n in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name in names:
        shape = tuple(param_shapes[name])
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            v = v * (1.0 / math.sqrt(fan_in(shape)))
        elif name.rsplit(".", 1)[-1] == "weight":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.clone()
    for name, shape in buffer_shapes.items():
        fill = 1.0 if name.endswith("running_var") else 0.0
        out[name] = torch.full(tuple(shape), fill, device=device)
    return out


def shapes_of(model):
    """({parameter name: shape}, {float buffer name: shape}) of a module."""
    params = {n: tuple(p.shape) for n, p in model.named_parameters()}
    bufs = {n: tuple(b.shape) for n, b in model.named_buffers()
            if b.is_floating_point()}
    return params, bufs
