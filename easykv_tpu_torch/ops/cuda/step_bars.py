"""The bars that hold a one-kernel decode step (K14, `fused_decode_step`;
K15, `fused_decode_step_batch`) to its plain version on the card.
chip_smoke.py (phases 2 and 5) and the card-only tests
(tests/test_torch_gpu.py) hold the kernels to the same bars.

K14 rounds each product input through a two-plane int8 feed, K15 through a
bf16 feed, so a difference of a few ulps before the rounding can move a
product by a whole step of the feed, and such steps add up through the
layers. A fixed bar (k14_limit) holds at L=2 for K14; where it does not
(K14 at L=32, every K15 case), the bar is the larger of k14_limit and twice
the plain version's own spread under the kernel's kind of difference,
measured on the same arguments: k14_ulp_spread for K14, k15_spread for K15.
"""
from __future__ import annotations

import torch

from . import fused_decode_batch as k15_fd
from .fused_decode import PRODUCTS, fused_decode_step_plain, step_plain
from .fused_decode_batch import fused_decode_step_batch, fused_decode_step_batch_plain

STEP_OUTPUTS = ("h", "kn", "vn", "probs", "p_new")


def k14_limit(ref: torch.Tensor) -> torch.Tensor:
    """Limit on |kernel - plain| for each output: 1e-3 of the output's
    largest |value| (the JAX package's bar for K14's feed against its scan:
    the two-plane feed rounds each product input, so a one-ulp difference
    before the rounding moves the input by a step of the feed,
    max|X_g| / 127^2), plus one bf16 ulp of the value for the bf16 outputs
    (h, kn, vn), whose two f32 values may round to adjacent bf16 values."""
    lim = 1e-3 * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        lim = lim + 2**-7 * ref.float().abs()
    return lim


def step_shares(got, ref, spread=None, spread_name="one-ulp spread"):
    """(worst share of its limit over the outputs, max |err|, one text per
    output) of `got` against the plain version's `ref`: k14_limit, or,
    given `spread` (k14_ulp_spread, k15_spread), the larger of k14_limit
    and twice the output's spread."""
    line, worst, err = [], 0.0, 0.0
    for name, a, b in zip(STEP_OUTPUTS, got, ref):
        e = (a.float() - b.float()).abs()
        lim = k14_limit(b)
        if spread is not None:
            lim = torch.clamp(lim, min=2 * spread[name])
        ratio = (e / lim).max().item()
        worst, err = max(worst, ratio), max(err, e.max().item())
        line.append(f"{name} {e.max().item():.3e} ({ratio:.2f}"
                    + ("" if spread is None else f"; {spread_name} {spread[name]:.3e}") + ")")
    return worst, err, line


def k14_ulp_spread(layers, cfg, args, draws=4):
    """How far the plain K14's outputs move when its input h0, taken to
    f32, moves by one f32 ulp in a seeded half of its elements: the
    largest |move| of each output over `draws` draws. The kernel adds in
    other orders than its plain version, so the two differ by ulps before
    every rounding of the two-plane feed, and at depth by what those
    roundings make of them through the layers: this is the function's own
    spread under such noise, measured on the same arguments."""
    k, v, pos, h0, q_pos, *scales = args
    x = h0.float()
    base = fused_decode_step_plain(layers, cfg, k, v, pos, x, q_pos, *scales)
    spread = dict.fromkeys(STEP_OUTPUTS, 0.0)
    for draw in range(draws):
        g = torch.Generator(device=x.device).manual_seed(draw)
        up = torch.rand(x.shape, generator=g, device=x.device) < 0.5
        x1 = torch.where(up, torch.nextafter(x, torch.full_like(x, float("inf"))), x)
        moved = fused_decode_step_plain(layers, cfg, k, v, pos, x1, q_pos, *scales)
        for name, a, b in zip(STEP_OUTPUTS, moved, base):
            spread[name] = max(spread[name], (a - b).abs().max().item())
    return spread


def k15_shuffled_product(x, w, dt, gen):
    """The plain K15 product with each scale group's rows added in a seeded
    random order (the rows of the carrier and of both input halves permuted
    alike): the same function, its sums in another order."""
    p, gs3 = w["q4a"], w["gs3"]
    kh, gch = p.shape[0], gs3.shape[0] // 2
    G = kh // gch
    perm = (torch.rand((gch, G), generator=gen, device=p.device).argsort(dim=1)
            + G * torch.arange(gch, device=p.device)[:, None]).flatten()
    x = torch.cat([x[:, :kh][:, perm], x[:, kh:][:, perm]], dim=1)
    return k15_fd._product(x, {"q4a": p[perm], "gs3": gs3}, dt)


def nudge(x, n, gen):
    """x (f32) with each element moved by a binomial(n, 1/2) count of f32
    ulps, in a seeded direction of its own."""
    to = torch.where(torch.rand(x.shape, generator=gen, device=x.device) < 0.5,
                     float("inf"), float("-inf"))
    for _ in range(n):
        step = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
        x = torch.where(step, torch.nextafter(x, to), x)
    return x


def k15_permuted_slots(args, gen):
    """(K15's arguments with the cache slots in a seeded random order, the
    order that puts a probs row back): the attention's sums over the slots
    (the softmax denominator, PV) then add in another order."""
    k, v, pos, h0, q_pos, *scales = args
    perm = torch.randperm(pos.shape[-1], generator=gen, device=pos.device)
    return ((k[..., perm, :], v[..., perm, :], pos[..., perm], h0, q_pos,
             *(t[..., perm] for t in scales)), perm.argsort())


# How many f32 ulps (binomial(n, 1/2)) k15_spread moves each element of a
# product's input by, beside the reordered sums, read on the card by
# tools/torch_k15_ulps.py (each kernel step against the plain one on the
# kernel's own input; PERF.md): K15's RMSNorm outputs (wqkv, wgu) lie a mean
# of at most 0.88 ulps (largest 3) from the plain ones, so n = 2 (a mean
# of 1); its SwiGLU (wd) lies 0 ulps from it; its attention output (wo)
# differs by the order of its sums over the slots, which k15_permuted_slots
# draws instead (0.82-0.89 of the kernel's flips of the wo feed). The
# reordered product sums move about half as far as the kernel's
# tensor-core sums do, so the spread errs small: the bar it sets is, if
# anything, tighter than the kernel's own kind of difference.
ULPS = {"wqkv": 2, "wo": 0, "wgu": 2, "wd": 0}


def k15_spread(layers, cfg, args, rope_pos=None, draws=4):
    """How far the plain K15's outputs move when its sums add in other
    orders (each product's rows within their scale groups,
    k15_shuffled_product; the attention's slots, k15_permuted_slots) and
    each element of each product's input moves by a binomial(ULPS[product],
    1/2) count of f32 ulps (nudge), as the kernel's sums and its RMSNorm and
    SwiGLU steps differ from the plain version's: the largest |move| of
    each output over `draws` seeded draws, on the same arguments. The feed
    rounds each product's input to bf16 and the arithmetic layout's dots
    cancel (A.p is ~16x the product), so such differences flip some bf16
    inputs of the next product by a step of 2^-8. This is the function's
    own spread under the kernel's kind of difference."""
    h0 = args[3]
    base = fused_decode_step_batch_plain(layers, cfg, *args, rope_pos=rope_pos)
    spread = dict.fromkeys(STEP_OUTPUTS, 0.0)
    for draw in range(draws):
        gen = torch.Generator(device=h0.device).manual_seed(draw)
        calls = [0]

        def product(x, w):
            n = ULPS[PRODUCTS[calls[0] % len(PRODUCTS)]]    # step_plain's order a layer
            calls[0] += 1
            return k15_shuffled_product(nudge(x, n, gen), w, h0.dtype, gen)

        (k, v, pos, _, q_pos, *scales), back = k15_permuted_slots(args, gen)
        moved = step_plain(layers, cfg, k, v, pos, h0, q_pos, *(scales or (None, None)),
                           rope_pos, product)
        moved = moved[:3] + (moved[3][..., back],) + moved[4:]
        for name, a, b in zip(STEP_OUTPUTS, moved, base):
            spread[name] = max(spread[name], (a.float() - b.float()).abs().max().item())
    return spread


def lanes_rs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / sqrt(mean(x^2) + eps) of each row of x (B, D) f32, (B, 1), with
    the sum of squares added as K15's first norm adds it (rms_rows over
    h0): lane l of a warp adds the squares of elements l, l + 32, ... in
    order, the 32 lane sums add as a butterfly (xor 16, 8, 4, 2, 1), all in
    f32. The order is the same at every batch size; torch's mean over a row
    is not (its reduction's split depends on the tensor's shape)."""
    B, D = x.shape
    sq = torch.nn.functional.pad(x * x, (0, -D % 32)).reshape(B, -1, 32)
    s = sq[:, 0]
    for i in range(1, sq.shape[1]):
        s = s + sq[:, i]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ o]
    return 1.0 / torch.sqrt(s[:, :1] / D + eps)


def rms_lanes(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm of x (B, D) f32 by w in K15's order of its sums (lanes_rs)."""
    return x * lanes_rs(x, eps) * w.to(torch.float32)


def k15_feed_share(layers, cfg, args, rope_pos=None, feed=None):
    """(share of layer 0's kn elements, of its vn elements) that K15 (or,
    with `feed`, the plain version with its feed rounded to that dtype)
    gives bit-equal to the plain version with K15's order of the first
    norm's sums (rms_lanes): layer 0's K and V rows come from one product
    of the normed h0, so a kernel that rounds the feed as the plain version
    does matches nearly all of them."""
    k, v, pos, h0, q_pos, *scales = args
    scales = scales or (None, None)
    ref = step_plain(layers, cfg, k, v, pos, h0, q_pos, *scales, rope_pos,
                     lambda x, w: k15_fd._product(x, w, h0.dtype), rms_lanes)
    if feed is None:
        got = fused_decode_step_batch(layers, cfg, *args, rope_pos=rope_pos)
    else:
        got = step_plain(layers, cfg, k, v, pos, h0, q_pos, *scales, rope_pos,
                         lambda x, w: k15_fd._product(x, w, feed), rms_lanes)
    return tuple((got[i][0] == ref[i][0]).float().mean().item() for i in (1, 2))
