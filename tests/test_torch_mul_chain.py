"""The carry chains of csrc/mul_wide.cuh, run instruction by instruction
as the asm blocks are written, on an explicit carry flag.

`chains()` reads the PTX text of every `MSM_MW_CHAIN` and
`MSM_MW_MERGE` block from the header itself (its string macros expanded
as the preprocessor expands them) and the operands that the block's asm
statement binds to its %n, in their order, and `run()` executes a
block's instructions on 32-bit words held in uint64 arrays, one lane an
element, each %n the word its operand names: `.cc` forms set the carry flag,
`madc` and `addc` read it, and a block starts with no flag (so a chain
that reads a carry from another asm statement fails). A block drops its
last carry, which must be zero in every lane. `mont_chains` is
`MulWide::mont` over those blocks, in the header's order, on
t = E + 2^32 O: each product row the O chain over a's odd words (after
the add that the last division left) and the E chain over its even
words, each reduction row the same over p's, the renaming E' = O,
O' = E >> 64, the last RB bits, the merge. It must give `mul_words`
(tests/test_torch_mul_wide.py, the 64-bit form) and `rows.mont_mul_rows`
bit for bit on TINY62, BN254_S12, BN254_S13, BLS12_377_S12 and
BLS12_377_S13, over the canonical range, at the edge values (up to 54p
and 2^(L w) - 1) and on lazy `padd_rows` outputs; and a block with a
planted dropped carry must fail."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from tpu_msm_torch import constants as tc
from tpu_msm_torch.ops import rows

from test_torch_mul_wide import (NAMES, Words, edge_values, lazy_from_padd,
                                 limbs, mul_words, pack, random_canonical,
                                 unpack)

torch.set_num_threads(1)

CURVES = {name: tc.CURVES[name] for name in NAMES}
HEADER = (pathlib.Path(__file__).resolve().parents[1] / "tpu_msm_torch"
          / "csrc" / "mul_wide.cuh")
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
T_WORDS, X_WORDS = 14, 7           # kChainT, kChainX


def _defines(text: str) -> dict:
    """name -> (parameter or None, body) of every #define."""
    text = text.replace("\\\n", " ")
    out = {}
    for m in re.finditer(r"^#define\s+(\w+)(\(([\w, ]+)\))?\s+(.*)$", text,
                         re.M):
        out[m[1]] = (m[3], m[4].strip())
    return out


def _expand(tokens: str, defs: dict) -> str:
    """The string that a sequence of string literals, string macros and
    MSM_MW_C(n) calls expands to."""
    out = []
    for m in re.finditer(r'("(?:[^"\\]|\\.)*")|(\w+)(\((\w+)\))?', tokens):
        if m[1]:
            out.append(ast.literal_eval(m[1]))
            continue
        param, body = defs[m[2]]
        if param:
            body = body.replace("#" + param, f'"{m[4]}"')
        out.append(_expand(body, defs))
    return "".join(out)


def _program(asm: str) -> list:
    prog = []
    for ins in filter(None, (s.strip() for s in asm.split(";"))):
        op, args = ins.split(None, 1)
        prog.append((op, [int(a[1:]) if a.startswith("%")
                          else ("imm", int(a))
                          for a in (x.strip() for x in args.split(","))]))
    return prog


def _operands(text: str, defs: dict) -> list:
    """The names that an asm statement's operand list binds, in order:
    "+r"(U[3]) -> 'U[3]'; macro names expanded."""
    out = []
    for item in re.findall(r'"[+=]?r"\(([^()]*)\)|(\w+)', text):
        out += [item[0]] if item[0] else _operands(defs[item[1]][1], defs)
    return out


def chains(text: str = None) -> dict:
    """The header's asm blocks: ('chain', K, R, A) and ('merge', N, Z) ->
    (instructions, output names, input names), an instruction
    (opcode, [operand, ...]) with operands int numbers or ('imm', value),
    the names as the block's asm statement binds them (outputs first)."""
    text = HEADER.read_text() if text is None else text
    defs = _defines(text)
    body = text.replace("\\\n", " ")
    binds = {}
    for kind in ("CHAIN", "MERGE"):
        _, macro = defs[f"MSM_MW_{kind}"]
        m = re.search(r"asm volatile\(TEXT\s*:(.*?):(.*?)\);", macro)
        binds[kind] = (_operands(m[1], defs), _operands(m[2], defs))
    out = {}
    for m in re.finditer(r"^MSM_MW_(CHAIN|MERGE)\(((?:\d+, )*\d+),"
                         r"\s*((?:[^()]|\([^()]*\))*)\)$", body, re.M):
        key = (m[1].lower(),) + tuple(int(v) for v in m[2].split(", "))
        assert key not in out, key
        out[key] = (_program(_expand(m[3], defs)),) + binds[m[1]]
    return out


def run(block, values: dict) -> dict:
    """One asm block on the words `values` (name -> uint64 array of 32-bit
    words) that its operands bind; returns the outputs it leaves."""
    prog, outs, ins = block
    regs = [values[n] for n in outs + ins]
    cf = None                                  # no flag at the block's start

    def val(a):
        return np.uint64(a[1]) if isinstance(a, tuple) else regs[a]

    def carry():
        assert cf is not None, "a carry read before any .cc in the block"
        return cf

    for op, args in prog:
        parts = op.split(".")
        d = args[0]
        assert not isinstance(d, tuple) and d < len(outs), (op, d)
        if parts[0] in ("mad", "madc"):
            prod = val(args[1]) * val(args[2])
            half = prod & M32 if parts[1] == "lo" else prod >> S32
            s = half + val(args[3]) + (carry() if parts[0] == "madc" else 0)
        elif parts[0] in ("add", "addc"):
            s = val(args[1]) + val(args[2]) + (carry() if parts[0] == "addc"
                                               else 0)
        else:
            raise AssertionError(f"instruction the model does not know: {op}")
        assert parts[-1] == "u32", op
        regs[d] = s & M32
        if "cc" in parts:
            cf = s >> S32
    # the block drops its last carry: it must be zero
    assert cf is not None and not cf.any(), "a chain dropped a carry"
    return dict(zip(outs, regs))


def words(name: str, v: list) -> dict:
    return {f"{name}[{k}]": w for k, w in enumerate(v)}


def chain(prog, key, U, x, y, e0, xw):
    """Chain<K, R, A>::run(U, x, y, e0, xw): returns (U, e0)."""
    got = run(prog[("chain",) + key], {**words("U", U), **words("x", x),
                                       "y": y, "e0": e0, "xw": xw})
    return [got[f"U[{k}]"] for k in range(T_WORDS)], got["e0"]


def merge(prog, key, E, O, xw):
    """Merge<N, Z>::run(E, O, xw): returns E."""
    got = run(prog[("merge",) + key], {**words("U", E), **words("O", O),
                                       "xw": xw})
    return [got[f"U[{k}]"] for k in range(T_WORDS)]


def mont_chains(a: list, b: list, K: Words, prog: dict) -> list:
    """MulWide::mont of csrc/mul_wide.cuh over the blocks `prog`:
    t = E + 2^32 O."""
    N, NF, NP, RB = K.N, K.NF, K.NP, K.RB
    zero = np.zeros_like(a[0])
    pad = lambda v, n=X_WORDS: list(v) + [zero] * (n - len(v))
    ae, ao = pad(a[0::2]), pad(a[1::2])
    pe = pad([np.full_like(zero, p) for p in K.p[0::2]])
    po = pad([np.full_like(zero, p) for p in K.p[1::2]])
    E, O, x = [zero] * T_WORDS, [zero] * T_WORDS, zero
    top = N + 1 if RB else N + 2                 # words of E
    for i in range(N):
        O, E[0] = chain(prog, (N // 2, 1, 1), O, ao, b[i], E[0], x)
        E, _ = chain(prog, ((N + 1) // 2, 0 if RB else 2, 0), E, ae, b[i],
                     zero, zero)
        if i < NF:
            m = (E[0] * K.n0) & M32
            E, _ = chain(prog, (NP // 2, 2, 0), E, pe, m, zero, zero)
            O, _ = chain(prog, (NP // 2, 1, 0), O, po, m, zero, zero)
            assert not E[0].any()                 # the low word cancels
            x, E, O = E[1], O, E[2:] + [zero, zero]
        assert not any(w.any() for w in E[top:] + O[top - 1:])
    if RB:
        m = (E[0] * K.n0) & np.uint64((1 << RB) - 1)
        E, _ = chain(prog, (NP // 2, 2, 0), E, pe, m, zero, zero)
        O, _ = chain(prog, (NP // 2, 1, 0), O, po, m, zero, zero)
        E = merge(prog, (N, 0), E, O, zero)
        return [(E[k] >> np.uint64(RB)) | ((E[k + 1] << np.uint64(32 - RB))
                                          & M32) for k in range(N)]
    return merge(prog, (N, 1), E, O, x)[:N]


def stream(b: np.ndarray, K: Words) -> list:
    """`MulWide::Stream`: b's words one at a time, each from the canonical
    limbs that start in it (Field::canon's int32 ripple, a limb at a time)
    and the high bits of the limb that straddles into it."""
    carry = np.zeros(b.shape[1:], np.int32)
    high = np.zeros(b.shape[1:], np.uint64)
    out = []
    for i in range(K.N):
        w, high = high, np.zeros_like(high)
        for j in range(K.L):
            bit = K.w * j
            off = bit & 31
            if bit >> 5 != i:
                continue
            s = b[j] + carry
            limb = (s & ((1 << K.w) - 1)).astype(np.uint64)
            carry = s >> K.w
            w = (w | (limb << np.uint64(off))) & M32
            if off + K.w > 32:
                high = limb >> np.uint64(32 - off)
        out.append(w)
    return out


def mul_chains(a: np.ndarray, b: np.ndarray, curve, prog=None) -> np.ndarray:
    """`mul_wide` of csrc/mul_wide.cuh on (L, n) int32 limbs, its rows
    the header's carry chains, b's words from `stream`."""
    K = Words(curve)
    prog = chains() if prog is None else prog
    return unpack(mont_chains(pack(a, K), stream(b, K), K, prog), K)


@pytest.mark.parametrize("name", NAMES)
def test_stream_is_pack(name):
    """b's words a row at a time are pack()'s, on lazy limbs from real
    padd_rows outputs, with negative limbs, and at the edge values."""
    curve = CURVES[name]
    K = Words(curve)
    e = edge_values(curve)
    for b in (lazy_from_padd(curve, np.random.default_rng(4), 64),
              limbs(e, curve)):
        assert all(np.array_equal(x, y)
                   for x, y in zip(stream(b, K), pack(b, K), strict=True))


def check(a: np.ndarray, b: np.ndarray, curve) -> None:
    got = mul_chains(a, b, curve)
    assert got.dtype == np.int32
    assert np.array_equal(got, mul_words(a, b, Words(curve)))
    assert np.array_equal(got, rows.mont_mul_rows(
        torch.from_numpy(a), torch.from_numpy(b), curve).numpy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_chains_random_canonical(name, seed):
    curve = CURVES[name]
    rng = np.random.default_rng(200 + seed)
    check(random_canonical(curve, rng, 512), random_canonical(curve, rng, 512),
          curve)


@pytest.mark.parametrize("name", NAMES)
def test_chains_edges(name):
    """Every pair of 0, 1, p - 1, p, 2p - 1, 32p, 54p and 2^(L w) - 1."""
    curve = CURVES[name]
    e = edge_values(curve)
    check(limbs([x for x in e for _ in e], curve),
          limbs([y for _ in e for y in e], curve), curve)


@pytest.mark.parametrize("name", NAMES)
def test_chains_lazy_padd_outputs(name):
    curve = CURVES[name]
    a = lazy_from_padd(curve, np.random.default_rng(17), 96)
    check(a, np.roll(a, 7, axis=1), curve)
    check(a, a, curve)


@pytest.mark.parametrize("name", NAMES)
def test_chains_encode_by_r2_words(name):
    """encode_mont's multiply by the pre-packed words of R^2 on the
    chains: to_mont_rows bit for bit."""
    curve = CURVES[name]
    K = Words(curve)
    x = random_canonical(curve, np.random.default_rng(5), 64)
    x[:, :3] = limbs([0, 1, curve.p - 1], curve)
    got = unpack(mont_chains(pack(x, K), [np.full(64, v) for v in K.r2], K,
                             chains()), K)
    assert np.array_equal(got, rows.to_mont_rows(torch.from_numpy(x),
                                                 curve).numpy())


def test_chain_blocks_are_the_profiles():
    """The header holds exactly the blocks the five profiles take: each
    chain K 64-bit multiply-adds of x[k] y into words 2 k, 2 k + 1 of its
    accumulator U, the first without a carry in (or after the A block's
    add of xw to e0), then its R ripple words; each merge adds O one word
    up into E through word N (and xw into E[0] with Z)."""
    prog = chains()
    need = set()
    for curve in CURVES.values():
        K = Words(curve)
        need |= {("chain", (K.N + 1) // 2, 0 if K.RB else 2, 0),
                 ("chain", K.N // 2, 1, 1), ("chain", K.NP // 2, 2, 0),
                 ("chain", K.NP // 2, 1, 0), ("merge", K.N, 0 if K.RB else 1)}
    assert set(prog) == need
    for key, (ins, outs, inputs) in prog.items():
        names = outs + inputs
        at = lambda a: names[a] if isinstance(a, int) else a
        text = [(op, [at(a) for a in args]) for op, args in ins]
        if key[0] == "merge":
            _, n, z = key
            want = [["U[0]", "U[0]", "xw"]] * z + [
                [f"U[{d}]", f"U[{d}]", f"O[{d - 1}]"] for d in range(1, n + 1)]
            assert [a for _, a in text] == want
            assert [op for op, _ in text] == (
                ["add.cc.u32"] + ["addc.cc.u32"] * (len(want) - 1))
            continue
        _, k, r, a = key
        if a:
            assert text[0] == ("add.cc.u32", ["e0", "e0", "xw"])
            text = text[1:]
        for j, (op, args) in enumerate(text[:2 * k]):
            assert op == ("mad" if j == 0 and not a else "madc") + (
                ".lo.cc.u32" if j % 2 == 0 else ".hi.cc.u32")
            assert args == [f"U[{j}]", f"x[{j // 2}]", "y", f"U[{j}]"]
        assert text[2 * k:] == [("addc.cc.u32", [f"U[{d}]", f"U[{d}]",
                                                 ("imm", 0)])
                                for d in range(2 * k, 2 * k + r)]


# A dropped carry planted in the header's text: each must fail, by a wrong
# product or by a chain that drops a nonzero carry.
PLANTS = {
    "a chain, carry in of its first high half": (
        'MSM_MW_P0 "mad.lo.cc.u32 %0, %15, %22, %0;\\n\\t" \\\n' + " " * 18
        + '"madc.hi.cc.u32', 'MSM_MW_P0 "mad.lo.cc.u32 %0, %15, %22, %0;'
        '\\n\\t" \\\n' + " " * 18 + '"mad.hi.cc.u32'),
    "a chain, carry in of its second pair": (
        'MSM_MW_P1 "madc.lo.cc.u32', 'MSM_MW_P1 "mad.lo.cc.u32'),
    "the A chain, the carry of the add into O": (
        'MSM_MW_Q0 "madc.lo.cc.u32', 'MSM_MW_Q0 "mad.lo.cc.u32'),
    "a ripple word that takes no carry in": (
        '#define MSM_MW_C(n) "addc.cc.u32', '#define MSM_MW_C(n) "add.cc.u32'),
    "the A chain's add bound to another word": (
        '#define MSM_MW_A "add.cc.u32 %14, %14, %23;',
        '#define MSM_MW_A "add.cc.u32 %14, %14, %22;'),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
@pytest.mark.parametrize("name", ["tiny62", "bn254_s12", "bls12_377_s12"])
def test_chains_a_dropped_carry_fails(name, plant):
    curve = CURVES[name]
    old, new = PLANTS[plant]
    text = HEADER.read_text()
    assert text.count(old) == 1
    prog = chains(text.replace(old, new))
    rng = np.random.default_rng(9)
    a, b = (random_canonical(curve, rng, 256) for _ in range(2))
    e = edge_values(curve)
    a = np.concatenate([a, limbs([x for x in e for _ in e], curve)], axis=1)
    b = np.concatenate([b, limbs([y for _ in e for y in e], curve)], axis=1)
    try:
        got = mul_chains(a, b, curve, prog)
    except AssertionError:
        return                                # a chain dropped a carry
    assert not np.array_equal(got, mul_words(a, b, Words(curve)))
