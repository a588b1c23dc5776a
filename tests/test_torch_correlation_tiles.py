"""A CPU rehearsal of kernel K2's tiled form (``csrc/correlation.cu``).

The kernel cannot run here, so this file mirrors its index arithmetic in
plain PyTorch, tile by tile and level by level: the 8x8 query tile's window
origins, their union box (a 1-pixel axis 1 wide), the choice between
staging the box (at most ``MAX_BOX[radius]`` pixels) and the per-pixel form,
the box gathered with zero fill, the product [64 queries, D] x [D, U] laid out
as the kernel lays it out ([64][U rounded up to 8], row of query q at q * Up,
box pixel (row, col) at row * bw + col) with NaN wherever the kernel leaves
an entry unwritten (past U, and the n-tiles of 8 box pixels that no query of
an m-tile of 16 reads), and each query's taps blended from its own entries. The mirror is held to ``lookup_lazy_plain`` (within 1e-5:
fp32 sums in other orders on values up to ~3) at shapes whose tiles cross
every edge and corner, with a 1x1 and a 1-wide level, at r = 3 and r = 4, in
one call that mixes staged and per-pixel tiles, and on integer coordinates
(fx = fy = 0). ``tile_plan``, which the card's smoke run reads to report the
share of staged tiles, must make the mirror's choices, and the constants the
mirror assumes must be the kernel's.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_visual_slam_torch.ops import correlation, correlation_cuda

torch.set_num_threads(1)

SOURCE = Path(correlation_cuda.__file__).resolve().parents[1] / "csrc" / "correlation.cu"
TILE = 8


def _origin(c: torch.Tensor, n: int, radius: int):
    """The kernel's window_origin on one axis: (x0 int64, fx float32)."""
    if n == 1:
        return torch.zeros(c.shape, dtype=torch.int64), torch.zeros_like(c)
    fl = torch.floor(c)
    return fl.clamp(-1e6, 1e6).to(torch.int64) - radius, c - fl


def _blend(v00, v01, v10, v11, fx, fy):
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)


def _mirror(fmap1, levels, coords, radius):
    """(out [B, H1, W1, L * taps], staged [L][B, tiles_y, tiles_x] bool)."""
    B, H1, W1, D = fmap1.shape
    side, win = 2 * radius + 2, 2 * radius + 1
    taps = win * win
    cap = correlation_cuda.MAX_BOX[radius]
    scale = 1.0 / math.sqrt(D)
    ty_n, tx_n = -(-H1 // TILE), -(-W1 // TILE)
    out = torch.full((B, H1, W1, len(levels) * taps), float("nan"))
    tap = torch.arange(taps)
    ti, tj = tap // win, tap % win  # dx = i - r (grid column), dy = j - r (grid row)
    staged_all = []
    for level, f2 in enumerate(levels):
        hl, wl = f2.shape[1:3]
        sx, sy = int(wl > 1), int(hl > 1)
        staged = torch.zeros((B, ty_n, tx_n), dtype=torch.bool)
        for b in range(B):
            for ty in range(ty_n):
                for tx in range(tx_n):
                    y1 = torch.arange(ty * TILE, min(ty * TILE + TILE, H1))
                    x1 = torch.arange(tx * TILE, min(tx * TILE + TILE, W1))
                    yy, xx = torch.meshgrid(y1, x1, indexing="ij")
                    yy, xx = yy.reshape(-1), xx.reshape(-1)
                    q = (yy - ty * TILE) * TILE + (xx - tx * TILE)  # the kernel's query index
                    c = coords[b, yy, xx] / 2**level
                    x0, fx = _origin(c[:, 0], wl, radius)
                    y0, fy = _origin(c[:, 1], hl, radius)
                    bx0 = int(x0.min()) if sx else 0
                    by0 = int(y0.min()) if sy else 0
                    bw = int(x0.max()) - bx0 + side if sx else 1
                    bh = int(y0.max()) - by0 + side if sy else 1
                    if bw <= cap and bh <= cap and bw * bh <= cap:
                        staged[b, ty, tx] = True
                        gy = by0 + torch.arange(bh)
                        gx = bx0 + torch.arange(bw)
                        inside = ((gy >= 0) & (gy < hl))[:, None] & ((gx >= 0) & (gx < wl))[None]
                        box = f2[b, gy.clamp(0, hl - 1)][:, gx.clamp(0, wl - 1)]
                        box = torch.where(inside[..., None], box, torch.zeros(()))
                        U = bw * bh
                        up = -(-U // 8) * 8
                        a = torch.zeros((TILE * TILE, D))
                        a[q] = fmap1[b, yy, xx]
                        prod = torch.full((TILE * TILE, up), float("nan"))
                        prod[:, :U] = a @ box.reshape(U, D).T * scale
                        # Each m-tile (16 queries) computes only the n-tiles
                        # (8 box pixels) that its queries' grids touch.
                        r0, c0 = (y0 - by0) * sy, (x0 - bx0) * sx
                        lo = r0 * bw + c0
                        hi = (r0 + (side if sy else 1) - 1) * bw + c0 + (side if sx else 1)
                        for m in range(TILE * TILE // 16):
                            mine = (q >= 16 * m) & (q < 16 * m + 16)
                            if not mine.any():
                                prod[16 * m:16 * m + 16] = float("nan")
                                continue
                            nlo, nhi = int(lo[mine].min()) // 8, -(-int(hi[mine].max()) // 8)
                            prod[16 * m:16 * m + 16, :nlo * 8] = float("nan")
                            prod[16 * m:16 * m + 16, nhi * 8:] = float("nan")
                        entries, width = prod.reshape(-1), bw
                        base = (q * up)[:, None]
                        c0 = (x0[:, None] - bx0 + ti[None]) * sx
                        r0 = (y0[:, None] - by0 + tj[None]) * sy
                        c1, r1 = c0 + sx, r0 + sy
                    else:  # the per-pixel form: each query's own grid of dots
                        zero = torch.zeros((len(q), side), dtype=torch.int64)
                        gy = y0[:, None] + torch.arange(side)[None] if sy else zero
                        gx = x0[:, None] + torch.arange(side)[None] if sx else zero
                        inside = ((gy >= 0) & (gy < hl))[:, :, None] & (
                            (gx >= 0) & (gx < wl))[:, None, :]
                        rows = f2[b, gy.clamp(0, hl - 1)[:, :, None], gx.clamp(0, wl - 1)[:, None, :]]
                        dots = (rows * fmap1[b, yy, xx][:, None, None]).sum(-1) * scale
                        entries = torch.where(inside, dots, torch.zeros(())).reshape(-1)
                        width = side
                        base = (torch.arange(len(q)) * side * side)[:, None]
                        c0, r0 = ti[None].expand(len(q), -1), tj[None].expand(len(q), -1)
                        c1, r1 = c0 + 1, r0 + 1

                    def read(r, c_):
                        return entries[base + r * width + c_]

                    v = _blend(read(r0, c0), read(r0, c1), read(r1, c0), read(r1, c1),
                               fx[:, None], fy[:, None])
                    out[b, yy, xx, level * taps:(level + 1) * taps] = v
        staged_all.append(staged)
    return out, staged_all


def _grid(B, H, W):
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    return torch.stack([xs, ys], -1).expand(B, H, W, 2).clone()


def _case(kind, B, H, W, D, seed):
    rng = np.random.default_rng(seed)
    f1 = torch.from_numpy(rng.standard_normal((B, H, W, D)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((B, H, W, D)).astype(np.float32))
    grid = _grid(B, H, W)
    if kind == "edges":  # a smooth flow out of the map's centre: windows past every edge
        centre = torch.tensor([(W - 1) / 2, (H - 1) / 2])
        flow = 0.1 * (grid - centre) + torch.tensor([0.37, -0.21])
    elif kind == "smooth":
        flow = torch.tensor([3.3, -2.7]) + 0.02 * grid
    elif kind == "integer":  # fx = fy = 0 at level 0, 0 or 0.5 above
        flow = torch.tensor([8.0, -4.0])
    else:  # "mixed": tiles alternate a smooth flow and +-12 px random targets
        noise = torch.from_numpy(rng.uniform(-12, 12, (B, H, W, 2)).astype(np.float32))
        checker = ((grid[..., 0] // TILE + grid[..., 1] // TILE) % 2 == 1)[..., None]
        flow = torch.where(checker, noise, torch.tensor([1.6, 0.4]) + 0.02 * grid)
    levels = correlation.build_corr_pyramid(f1, f2, 4, memory_efficient=True)[2]
    return f1, levels, grid + flow


CASES = {
    "edges, r=3, tiles cut at the bottom and right": ("edges", 2, 13, 19, 32, 3),
    "a 1x1 fourth level, r=3": ("smooth", 2, 9, 13, 32, 3),
    "a 1-wide fourth level, r=4": ("smooth", 1, 40, 8, 16, 4),
    "staged and per-pixel tiles in one call, r=3": ("mixed", 2, 16, 24, 32, 3),
    "staged and per-pixel tiles in one call, r=4": ("mixed", 1, 16, 24, 16, 4),
    "integer coordinates, r=4": ("integer", 1, 17, 21, 16, 4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_form_mirror_matches_plain_lookup(name):
    kind, B, H, W, D, radius = CASES[name]
    f1, levels, coords = _case(kind, B, H, W, D, seed=len(name))
    got, staged = _mirror(f1, levels, coords, radius)
    want = correlation.lookup_lazy_plain(f1, levels, coords, radius)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    plan = correlation_cuda.tile_plan(coords, [t.shape[1:3] for t in levels], radius)
    for mine, theirs in zip(staged, plan):
        assert torch.equal(mine, theirs["staged"])
    shares = [float(s.float().mean()) for s in staged]
    if kind == "mixed":  # both forms ran, on every level where windows can diverge
        assert 0 < shares[0] < 1 and 0 < shares[1] < 1
    else:
        assert all(s == 1.0 for s in shares), shares


def test_mirror_constants_are_the_kernels():
    src = SOURCE.read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == TILE
    assert correlation_cuda.TILE == TILE
    for radius, cap in correlation_cuda.MAX_BOX.items():
        found = re.search(rf"struct Box<{radius}> {{ static constexpr int kMaxU = (\d+),", src)
        assert int(found.group(1)) == cap
