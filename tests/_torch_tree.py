"""The launches of csrc/batch_inv.cuh replayed on CPU tensors, for
tests/test_torch_batch_inverse_kernel.py and
tests/test_torch_affine_kernel.py.

`replay` runs every launch of a `kernels.batch_inverse_geometry` plan as
the kernel's threads run it: the block's leaves into its stage in rounds
of T neighbours (leaf q T + t on thread t), each thread's register
subtree from the stage in the kernel's loop order (its leaves 2^d t + 2h
+ j, a node of level lo + 1 as j closes a pair, of level lo + 2 as h
does), the block's shared levels, the root's chain on warp 0 (a
squaring a bit of p - 2 from the top, a product where the bit is set),
then the way down: the stage loaded again where the launch did not go
up, the shared levels, each child's inverse from its parent's and its
sibling's value, the register subtree, a leaf's inverse in the stage in
the place of its value once its sibling has read that, and the stage
out in rounds. All the threads of a launch run at once on the lanes of
(L, m) tensors; the multiply is `ops/rows.mont_mul_rows`, which the
kernels' word-wide multiply equals bit for bit (tests/test_torch_mul_wide.py).
The scratch is a tensor a level; the replay counts every write of a
node's value going up and of an inverse in a node's place coming down.
"""

import functools

import numpy as np
import torch

from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.ops import inverse, rows


def mont_one(curve) -> torch.Tensor:
    return rows.const_rows(curve.r_mod_p, curve, torch.zeros(
        curve.num_limbs, 1, dtype=torch.int32))


def mul_of(curve):
    return lambda a, b: rows.mont_mul_rows(a, b, curve)


@functools.lru_cache(maxsize=None)
def _chain(curve, root: tuple) -> torch.Tensor:
    L = curve.num_limbs
    x = torch.tensor(root, dtype=torch.int32).reshape(L, 1)
    e = curve.p - 2
    acc = mont_one(curve)
    for i in range(e.bit_length() - 1, -1, -1):
        r = rows.mont_mul_rows(acc, acc, curve)
        acc = rows.mont_mul_rows(r, x, curve) if (e >> i) & 1 else r
    return acc


def chain_of(curve):
    """The root's chain as warp 0 runs it, from the Montgomery one.
    Cached by the root's limbs: every split of one input has one root,
    and a chain of rows multiplies takes seconds here."""
    return lambda root: _chain(curve, tuple(root.reshape(-1).tolist()))


def replay(geo, L: int, one, mul, chain, leaf, sink) -> dict:
    """Every launch of `geo`. one: (L, 1) limbs of the Montgomery one;
    mul(a, b) and chain(root) the arithmetic; leaf(f) -> (limbs, zero)
    of the elements f < K; sink(f, inv, zero) takes their inverses.
    Returns the write counts: `values[l]` of each node of level l going
    up, `inverses[l]` of each inverse written in a node's place, `zero`
    of each element's flag."""
    K, Kp = geo.K, geo.Kp
    nodes = [torch.full((L, Kp >> l), -1, dtype=torch.int32)
             for l in range(geo.levels + 1)]
    values = [np.zeros(Kp >> l, np.int64) for l in range(geo.levels + 1)]
    inverses = [np.zeros(Kp >> l, np.int64) for l in range(geo.levels + 1)]
    zero = torch.zeros(K, dtype=torch.bool)
    zero_writes = np.zeros(K, np.int64)

    def put(l, i, v):
        nodes[l][:, i] = v
        np.add.at(values[l], i.numpy(), 1)

    for ln in geo.launches:
        lo, n, d = ln.lo, ln.n, ln.d
        up = n - d
        T = 1 << up
        base = torch.arange(ln.blocks, dtype=torch.int64)[:, None] << n
        tnode = torch.arange(ln.blocks * T, dtype=torch.int64)
        # thread t's first leaf in its block
        tleaf = ((tnode & (T - 1)) << d).reshape(ln.blocks, T)
        H, J = (2 if d == 2 else 1), (2 if d >= 1 else 1)
        at = lambda i: i[None].expand(L, -1, -1)

        def leaves_of(i):
            """The block's leaves i (a (blocks, m) index) as the launch's
            leaf numbers."""
            return (base + i).reshape(-1)

        if ln.roles & kernels.TREE_UP:
            # the stage: the block's leaves, in rounds of T neighbours
            stage = torch.empty((L, ln.blocks, 1 << n), dtype=torch.int32)
            for q in range(1 << d):
                i = q * T + torch.arange(T)[None, :].expand(ln.blocks, T)
                f = leaves_of(i)
                if lo > 0:
                    x = nodes[lo][:, f]
                else:
                    x = one.expand(L, len(f)).clone()
                    inb = f < K
                    if bool(inb.any()):
                        w, z = leaf(f[inb])
                        zero[f[inb]] = z
                        np.add.at(zero_writes, f[inb].numpy(), 1)
                        x[:, inb] = torch.where(z, one, w)
                    put(0, f, x)
                stage.scatter_(2, at(i), x.reshape(L, ln.blocks, T))
            for h in range(H):
                for j in range(J):
                    i = tleaf + 2 * h + j
                    x = torch.gather(stage, 2, at(i)).reshape(L, -1)
                    if j == 0:
                        a = x
                    else:
                        a = mul(a, x)
                        put(lo + 1, leaves_of(i) >> 1, a)
                if h == 0:
                    b = a
                else:
                    b = mul(b, a)
                    put(lo + 2, tnode, b)
            S = b.reshape(L, ln.blocks, T)
            for s in range(1, up + 1):
                S = mul(S[..., 0::2], S[..., 1::2])
                put(lo + d + s, torch.arange(S[0].numel()), S.reshape(L, -1))
        if ln.roles & kernels.TREE_ROOT:
            S = chain(S.reshape(L, 1)).reshape(L, 1, 1)
        if ln.roles & kernels.TREE_DOWN:
            if not ln.roles & kernels.TREE_UP:
                S = nodes[lo + n][:, :ln.blocks].reshape(L, ln.blocks, 1)
                stage = nodes[lo][:, :ln.blocks << n].reshape(
                    L, ln.blocks, 1 << n).clone()
            for s in range(up, 0, -1):
                m = S.shape[2]
                c0 = ((torch.arange(ln.blocks)[:, None] << (up - s + 1))
                      + 2 * torch.arange(m)[None, :])
                v = nodes[lo + d + s - 1]
                left = mul(S, v[:, c0 + 1])
                right = mul(S, v[:, c0])
                S = torch.stack([left, right], dim=3).reshape(
                    L, ln.blocks, 2 * m)
            a = S.reshape(L, -1)
            for h in range(H):
                b = (mul(a, nodes[lo + 1][:, (tnode << 1) + (h ^ 1)])
                     if d == 2 else a)
                i0 = tleaf + 2 * h if d >= 1 else tleaf
                v0 = torch.gather(stage, 2, at(i0)).reshape(L, -1)
                for j in range(J):
                    if d >= 1:
                        x = (torch.gather(stage, 2, at(i0 + 1)).reshape(L, -1)
                             if j == 0 else v0)
                        r = mul(b, x)
                    else:
                        r = b
                    stage.scatter_(2, at(i0 + j), r.reshape(L, ln.blocks, T))
            for q in range(1 << d):
                i = q * T + torch.arange(T)[None, :].expand(ln.blocks, T)
                f = leaves_of(i)
                r = torch.gather(stage, 2, at(i)).reshape(L, -1)
                if lo > 0:
                    nodes[lo][:, f] = r
                    np.add.at(inverses[lo], f.numpy(), 1)
                else:
                    inb = f < K
                    if bool(inb.any()):
                        sink(f[inb], r[:, inb], zero[f[inb]])
    return dict(values=values, inverses=inverses, zero=zero_writes)


def tree_inverse(a: torch.Tensor, curve, geo):
    """`kernels.batch_inverse`'s launches on (L, K) limbs: the inverses
    (canonical limbs, zeroed where the element was zero), the write
    counts of `replay` and each element's count of sinks."""
    L = curve.num_limbs
    flat = a.to(torch.int32).reshape(L, -1)
    out = torch.full_like(flat, -1)
    sunk = np.zeros(flat.shape[1], np.int64)

    def leaf(f):
        c = rows.canon_rows(flat[:, f], curve)
        return c, inverse.is_zero_val(c, curve)

    def sink(f, inv, zero):
        out[:, f] = torch.where(zero, torch.zeros_like(inv), inv)
        np.add.at(sunk, f.numpy(), 1)

    counts = replay(geo, L, mont_one(curve), mul_of(curve), chain_of(curve),
                    leaf, sink)
    return out.reshape(a.shape), counts, sunk


def tree_affine(p: torch.Tensor, curve, geo):
    """`kernels.to_affine`'s launches on a stacked (3, L, K) tensor: the
    leaves z = Z one and the flag inf = z is 0 or p; the ends X zinv and
    Y zinv reduced once and zeroed where inf. Returns (x, y, inf)."""
    L = curve.num_limbs
    px, py, pz = (c.to(torch.int32) for c in p)
    one = mont_one(curve)
    ax, ay = torch.full_like(px, -1), torch.full_like(py, -1)
    inf = torch.zeros(px.shape[1], dtype=torch.bool)

    def leaf(f):
        z = rows.mont_mul_rows(pz[:, f], one, curve)
        return z, inverse.is_zero_val(z, curve)

    def sink(f, zinv, zero):
        inf[f] = zero
        for c, out in ((px, ax), (py, ay)):
            v = inverse.reduce_once(rows.mont_mul_rows(c[:, f], zinv, curve),
                                    curve)
            out[:, f] = torch.where(zero, torch.zeros_like(v), v)

    replay(geo, L, one, mul_of(curve), chain_of(curve), leaf, sink)
    return ax, ay, inf
