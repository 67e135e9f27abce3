"""Integer operations and bytes of the int8 forward's kernels, counted from
shapes, frozen from ``plumekit_torch/experiments/int8_conv_times.py``: Q1,
the 3×3 conv with its requant, and Q2, the 2×2 stride-2 transposed conv
with its requant. Each input byte is counted read once and each output byte
written once. The bound of a kernel is the larger of its operations at the
data sheet's 1,979 int8 TOPS and its bytes at 3,350 GB/s."""

from __future__ import annotations

from benchmark.yardstick.flops import decoder_nodes, effective_level

PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def conv_cases(cfg, tile: int):
    """(c_skip, c_in, c_out, side, int8 out) of every 3×3 conv of one int8
    forward at ``tile``² tiles, in launch order."""
    if cfg.arch == "unetpp":
        return unetpp_conv_cases(cfg, tile)
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    cases = []
    for i in range(cfg.depth + 1):
        cin = cfg.in_channels if i == 0 else f[i - 1]
        cases += [(0, cin, f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, True)]
    for i in reversed(range(cfg.depth)):
        cases += [(f[i], f[i], f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, i != 0)]
    return cases


def unetpp_conv_cases(cfg, tile: int):
    """:func:`conv_cases` of the UNet++: node X[i][j]'s first conv reads the
    j same-scale planes and the upsample; the top row's second convs write
    fp32 where a head reads them."""
    level = effective_level(cfg)
    f = [cfg.base_features * 2**i for i in range(level + 1)]
    cases = []
    for i in range(level + 1):
        cin = cfg.in_channels if i == 0 else f[i - 1]
        cases += [(0, cin, f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, True)]
    for i, j in decoder_nodes(level):
        fp32_out = i == 0 and (j == level or cfg.deep_supervision)
        cases += [(j * f[i], f[i], f[i], tile >> i, True),
                  (0, f[i], f[i], tile >> i, not fp32_out)]
    return cases


def ops_and_bytes(case, batch):
    """Integer operations and bytes moved once (inputs, weights, a, b and
    the output) of one conv over ``batch`` tiles."""
    c_skip, cin, cout, side, int8_out = case
    k = c_skip + cin
    px = batch * side * side
    return (2 * 9 * k * cout * px,
            px * k + 9 * k * cout + 8 * cout + px * cout * (1 if int8_out
                                                            else 4))


def upsample_cases(cfg, tile: int):
    """(c_in, c_out, side of the input) of every transposed conv of one
    int8 forward, in launch order."""
    f = [cfg.base_features * 2**i for i in range(cfg.depth + 1)]
    if cfg.arch == "unetpp":
        return [(f[i + 1], f[i], tile >> (i + 1))
                for i, j in decoder_nodes(effective_level(cfg))]
    return [(f[cfg.depth - u], f[cfg.depth - 1 - u], tile >> (cfg.depth - u))
            for u in range(cfg.depth)]


def upsample_ops_and_bytes(case, batch):
    """Integer operations and bytes moved once (input, kernel, sw, bias and
    the int8 output) of one transposed conv over ``batch`` tiles."""
    cin, cout, side = case
    px = batch * side * side
    return (2 * px * cin * 4 * cout,
            px * cin + 4 * cin * cout + 8 * cout + 4 * px * cout)


def bound(n_ops, n_bytes):
    """(bound_ms, bound_by) at the data sheet's int8 and memory rates."""
    by_ops = n_ops / PEAK_INT8_OPS_PER_S * 1e3
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")
