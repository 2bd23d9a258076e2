"""The reference's own tree over a triangle soup, and the nearest hit of
a batch of rays through it.

The tree is built here and owes nothing to the program's builders: the
triangles are sorted by the Morton code of their centroids, cut into
leaves of ``LEAF`` consecutive triangles, and the leaves are the bottom
level of a complete binary tree stored as a heap (node ``n`` has children
``2n + 1`` and ``2n + 2``), each node's box the union of its children's.
The walk is depth first with a stack per ray, all rays a step at a time,
nearer child first.  Each leaf triangle is tested in the Baldwin–Weber
form the port's packed tables use (JCGT 2016; the operands worked out
here from the triangles by the arithmetic of ``spira_tpu_torch/accel/
pairs.py:_bw_operands``, and the test of ``kernels/bvh_megakernel.py:
_leaf_hits`` at commit 86df806), so that a ray grazing an edge takes the
triangle the program's walks take.  The nearest hit does not depend on the
tree: a program that walks another tree finds the same triangle but for
exact ties.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .vec import T_MIN

LEAF = 8
_FAR = 1e30
#: rays left walking when the walk hands the rest to brute force: the
#: last rays of a walk are few and take many steps, each a round of small
#: launches, while a test against every triangle is one batched pass
TAIL = 4096
#: rays a brute-force pass holds
BRUTE_RAYS = 256


@dataclass
class Tree:
    lo: torch.Tensor  # (nodes, 3)
    hi: torch.Tensor  # (nodes, 3)
    first_leaf: int  # heap index of leaf 0
    depth: int  # levels below the root
    order: torch.Tensor  # (leaves * LEAF,) triangle of each slot, -1 none
    bw: torch.Tensor  # (T, 12) Baldwin-Weber operands, the walk's precision


def _morton(q):
    """30-bit Morton codes of (T, 3) integer cells in [0, 1024)."""
    code = np.zeros(q.shape[0], np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


def bw_operands(v0, e1, e2, nrm):
    """The Baldwin-Weber constants ``[n(3), n.v0, A(3), a3, B(3), b3]`` of
    (T, 3) float32 triangle arrays; a degenerate triangle gets A = B = 0
    and a3 = b3 = -1, so that u < 0 rejects it."""
    n = np.cross(e1, e2)
    n2 = (n * n).sum(axis=1, keepdims=True)
    safe = np.where(n2 > 0.0, n2, 1.0)
    a = np.cross(e2, n) / safe
    b = np.cross(n, e1) / safe
    a3 = -(v0 * a).sum(axis=1, keepdims=True)
    b3 = -(v0 * b).sum(axis=1, keepdims=True)
    degen = n2 <= 0.0
    a = np.where(degen, 0.0, a)
    b = np.where(degen, 0.0, b)
    a3 = np.where(degen, -1.0, a3)
    b3 = np.where(degen, -1.0, b3)
    dn = (nrm * v0).sum(axis=1, keepdims=True)
    return np.concatenate([nrm, dn, a, a3, b, b3], axis=1).astype(np.float32)


def build(tris, dtype=None) -> Tree:
    """The tree over ``tris`` (``v0``, ``e1``, ``e2``, ``normal`` (T, 3)
    tensors), on their device; the walk runs in ``dtype`` (default: the
    tensors')."""
    v0, e1, e2 = tris["v0"], tris["e1"], tris["e2"]
    dtype = dtype or v0.dtype
    dev = v0.device
    a = v0.float().cpu().numpy()
    b = a + e1.float().cpu().numpy()
    c = a + e2.float().cpu().numpy()
    lo_t = np.minimum(np.minimum(a, b), c)
    hi_t = np.maximum(np.maximum(a, b), c)
    n_tri = a.shape[0]
    cen = 0.5 * (lo_t.astype(np.float64) + hi_t)
    span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
    q = np.clip(((cen - cen.min(0)) / span * 1023.0).astype(np.int64), 0,
                1023)
    order = np.argsort(_morton(q), kind="stable")
    n_leaf = max(1, -(-n_tri // LEAF))
    depth = max(0, int(np.ceil(np.log2(n_leaf))))
    slots = (1 << depth) * LEAF
    order_p = np.full(slots, -1, np.int64)
    order_p[:n_tri] = order
    lo = np.full((slots, 3), np.inf, np.float32)
    hi = np.full((slots, 3), -np.inf, np.float32)
    lo[:n_tri] = lo_t[order]
    hi[:n_tri] = hi_t[order]
    lo = lo.reshape(-1, LEAF, 3).min(1)
    hi = hi.reshape(-1, LEAF, 3).max(1)
    levels_lo, levels_hi = [lo], [hi]
    while levels_lo[0].shape[0] > 1:
        levels_lo.insert(0, levels_lo[0].reshape(-1, 2, 3).min(1))
        levels_hi.insert(0, levels_hi[0].reshape(-1, 2, 3).max(1))
    lo = np.concatenate(levels_lo)
    hi = np.concatenate(levels_hi)
    empty = ~np.isfinite(lo[:, 0])
    lo[empty] = _FAR
    hi[empty] = _FAR

    def t(x):
        return torch.as_tensor(x, device=dev)

    bw = bw_operands(a, e1.float().cpu().numpy(), e2.float().cpu().numpy(),
                     tris["normal"].float().cpu().numpy())
    return Tree(lo=t(lo).to(dtype), hi=t(hi).to(dtype),
                first_leaf=(1 << depth) - 1, depth=depth, order=t(order_p),
                bw=t(bw).to(dtype))


def _entry(lo, hi, o, inv, best):
    """(hit, entry distance) of each ray's box."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tn <= torch.minimum(tf, best), tn


def _leaf(tree, leaf, o, d, best):
    """Nearest hit among each ray's leaf triangles that beats ``best``:
    (won, t, triangle)."""
    slot = leaf[:, None] * LEAF + torch.arange(LEAF, device=o.device)
    prim = tree.order[slot]
    return _test(tree.bw[prim.clamp(min=0)], prim, o, d, best, prim >= 0)


def _test(f, prim, o, d, best, valid):
    """Baldwin-Weber test of each ray against its row of triangles
    ``prim`` (rays, k), whose operands ``f`` are (rays or 1, k, 12) and
    ``valid`` masks the row's padding: (won, t, triangle) of the first
    nearest that beats ``best``."""
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    nbx, nby, nbz = f[..., 0], f[..., 1], f[..., 2]
    den = nbx * dx + nby * dy + nbz * dz
    num = f[..., 3] - (nbx * ox + nby * oy + nbz * oz)
    r0 = 1.0 / den
    tt = num * (r0 * (2.0 - den * r0))
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    uu = f[..., 4] * px + f[..., 5] * py + f[..., 6] * pz + f[..., 7]
    vv = f[..., 8] * px + f[..., 9] * py + f[..., 10] * pz + f[..., 11]
    ok = (valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > T_MIN) & (tt < best[:, None]))
    k = torch.argmin(torch.where(ok, tt, torch.inf), dim=1, keepdim=True)
    return (ok.gather(1, k)[:, 0], tt.gather(1, k)[:, 0],
            prim.gather(1, k)[:, 0])


def _brute(tree, o, d, best):
    """Nearest hit of each ray among every triangle that beats ``best``:
    (won, t, triangle), the first triangle on ties."""
    won, tt, pp = [], [], []
    idx = torch.arange(tree.bw.shape[0], device=o.device)[None]
    for a in range(0, o.shape[0], BRUTE_RAYS):
        b = min(o.shape[0], a + BRUTE_RAYS)
        ok, t, prim = _test(tree.bw[None], idx.expand(b - a, -1), o[a:b],
                            d[a:b], best[a:b], idx >= 0)
        won.append(ok)
        tt.append(t)
        pp.append(prim)
    return torch.cat(won), torch.cat(tt), torch.cat(pp)


def nearest(tree, o, d, best, active=None):
    """Nearest triangle of each ray (o, d: (N, 3); best: (N,) the
    distance to beat; ``active``: (N,) bool, others keep ``best``):
    (t (N,), triangle (N,) int64, -1 where none)."""
    n = o.shape[0]
    dev = o.device
    with torch.no_grad():
        o = o.detach().to(tree.lo.dtype)
        d = d.detach().to(tree.lo.dtype)
        inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)
        t = best.detach().to(tree.lo.dtype).clone()
        prim = torch.full((n,), -1, dtype=torch.long, device=dev)
        stack = torch.empty((n, tree.depth + 2), dtype=torch.long,
                            device=dev)
        stack[:, 0] = 0
        sp = torch.ones(n, dtype=torch.long, device=dev)
        live = torch.arange(n, device=dev)
        if active is not None:
            live = live[active]
        while live.numel():
            sp[live] -= 1
            node = stack[live, sp[live]]
            o_l, inv_l = o[live], inv[live]
            hit, _ = _entry(tree.lo[node], tree.hi[node], o_l, inv_l,
                            t[live])
            is_leaf = node >= tree.first_leaf
            sel = (hit & is_leaf).nonzero()[:, 0]
            if sel.numel():
                g = live[sel]
                won, tw, pw = _leaf(tree, node[sel] - tree.first_leaf,
                                    o_l[sel], d[g], t[g])
                g, tw, pw = g[won], tw[won], pw[won]
                t[g] = tw
                prim[g] = pw
            sel = (hit & ~is_leaf).nonzero()[:, 0]
            if sel.numel():
                g = live[sel]
                left = 2 * node[sel] + 1
                right = left + 1
                _, tl = _entry(tree.lo[left], tree.hi[left], o_l[sel],
                               inv_l[sel], t[g])
                _, tr = _entry(tree.lo[right], tree.hi[right], o_l[sel],
                               inv_l[sel], t[g])
                near_left = tl <= tr
                far = torch.where(near_left, right, left)
                near = torch.where(near_left, left, right)
                stack[g, sp[g]] = far
                stack[g, sp[g] + 1] = near
                sp[g] += 2
            live = live[sp[live] > 0]
            if 0 < live.numel() <= TAIL:
                won, tw, pw = _brute(tree, o[live], d[live], t[live])
                g = live[won]
                t[g] = tw[won]
                prim[g] = pw[won]
                break
    return t, prim
