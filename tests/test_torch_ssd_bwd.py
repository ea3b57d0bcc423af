"""The bf16 SSD backward kernel's numeric design (``ssd_bwd_bf16_kernel`` of
``csrc/ssd_scan_bwd.cu``), emulated on the CPU.

The kernel cuts each head's P state rows into blocks of 32 and walks the
chunks of a (P block, head, batch) with every product on the tensor cores:
bf16 operands, fp32 accumulators.  x, dy, B and C are bf16 already; the
operands it forms in fp32 are each either split into a bf16 high part and
the bf16 rounding of what that leaves (two products) or rounded to bf16
once.  Each P block writes fp32 partials of dB, dC and d cs, summed in a
fixed order (P blocks, then the heads of a group); a chunk's last token
takes sum_i u_i + e^{cs_L} <dS, S> as <dS, S'>, S' the state the chunk ends
in (the next chunk's entry state as kept).  :func:`ssd_bwd_emulated`
repeats that arithmetic in fp32 at the same rounding points; the tests hold
it against ``ref.ssd_chunked_bwd_ref`` in float64 at mamba2's real decay,
within half the card's gate (3e-2 (1 + |w|) for every gradient), and show
for each operand the kernel splits that rounding it once misses the gate.

Run as a script, it prints each rounding choice's error.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

GATE = 3e-2                # the card's bf16 gate: |got - want| / (1 + |want|)
BOUND = GATE / 2           # what the emulated design must hold
PB = 32                    # the kernel's P block
# the operands the kernel forms in fp32: the decayed C B^T (att), the decayed
# dy x^T (g2), the state gradient's copy (ds), the recomputed entry state
# (state), x w of the forward walk (xw) and e^{cs} dy of the dS update (edy)
OPERANDS = ("att", "g2", "ds", "state", "xw", "edy")
SPLIT = OPERANDS                     # the kernel splits all six
NAMES = ("dx", "da", "db", "dc", "dinit")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, so that test workers running in parallel do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _op(v, split):
    """An fp32 operand as the kernel feeds it to the tensor cores: hi + lo
    (two products, summed in the fp32 accumulator) or hi alone."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _mm(lhs, rhs):
    """sum over the parts of lhs or rhs (one of them split) of their fp32
    products, in order"""
    out = 0.0
    for a in lhs:
        for b in rhs:
            out = out + a @ b
    return out


def ssd_bwd_emulated(xb, a, bmat, cmat, chunk, init_state, dy, dfinal, *,
                     split=SPLIT):
    """The bf16 kernel's backward, model layout, in fp32 with its rounding
    points: (dxb, da, dbmat, dcmat, dinit) as ``ref.ssd_chunked_bwd_ref``
    returns them.  ``split`` names the operands (of :data:`OPERANDS`) split
    into bf16 hi + lo; the others are rounded to bf16 once."""
    b, t, h, p = xb.shape
    g, n = bmat.shape[2], bmat.shape[3]
    r = h // g
    x = xb.float().transpose(1, 2)                          # b h t p
    dyf = dy.float().transpose(1, 2)
    bm = bmat.float().transpose(1, 2)                       # b g t n
    cm = cmat.float().transpose(1, 2)
    af = a.float().transpose(1, 2)                          # b h t
    nc = -(-t // chunk)
    nblk = -(-p // PB)
    db_parts = torch.zeros((nblk, b, h, t, n))
    dc_parts = torch.zeros((nblk, b, h, t, n))
    dcs_parts = torch.zeros((nblk, b, h, t))
    dx = torch.zeros((b, h, t, p))
    dinit = torch.zeros((b, h, p, n))
    for k in range(nblk):
        ps = slice(k * PB, min((k + 1) * PB, p))
        xk, dyk = x[..., ps], dyf[..., ps]
        bh = bm.repeat_interleave(r, 1)
        ch = cm.repeat_interleave(r, 1)
        cuts = [slice(c * chunk, min((c + 1) * chunk, t)) for c in range(nc)]
        css = [torch.cumsum(af[..., sl], -1) for sl in cuts]
        # the forward walk: each chunk's entry state, kept as the kernel
        # keeps it (the operand of dy S)
        s = (torch.zeros((b, h, xk.shape[-1], n)) if init_state is None
             else init_state.float()[:, :, ps])
        states = []
        for sl, cs in zip(cuts, css):
            states.append(s)
            w = torch.exp(cs[..., -1:] - cs)
            xw = _op((xk[:, :, sl] * w[..., None]).transpose(-1, -2),
                     "xw" in split)
            s = torch.exp(cs[..., -1])[..., None, None] * s \
                + _mm(xw, (bh[:, :, sl],))
        ds = (torch.zeros_like(s) if dfinal is None
              else dfinal.float()[:, :, ps])
        # the state each chunk ends in, as the kernel reads it: the next
        # chunk's entry state as kept, the last one's the final state (fp32)
        ends = [sum(_op(v, "state" in split)) for v in states[1:]] + [s]
        for c in reversed(range(nc)):
            sl, cs, s = cuts[c], css[c], states[c]
            q = cs.shape[-1]
            xc, dyc, bc, cc = xk[:, :, sl], dyk[:, :, sl], bh[:, :, sl], \
                ch[:, :, sl]
            low = torch.tril(torch.ones((q, q), dtype=torch.bool))
            strict = torch.tril(low, diagonal=-1)
            d = torch.where(low, torch.exp(torch.where(
                low, cs[..., :, None] - cs[..., None, :], 0.0)), 0.0)
            cb = cc @ bc.transpose(-1, -2)
            dyx = dyc @ xc.transpose(-1, -2)
            att, g2 = cb * d, dyx * d
            m = torch.where(strict, att * dyx, 0.0)
            w = torch.exp(cs[..., -1:] - cs)
            ecs = torch.exp(cs)
            dsop = _op(ds, "ds" in split)
            inter = _mm((bc,), tuple(v.transpose(-1, -2) for v in dsop))
            dx[:, :, sl, ps] = _mm(tuple(v.transpose(-1, -2) for v in
                                         _op(att, "att" in split)), (dyc,)) \
                + w[..., None] * inter
            u = w * (xc * inter).sum(-1)
            g2op = _op(g2, "g2" in split)
            db_parts[k, :, :, sl] = \
                w[..., None] * _mm((xc,), dsop) \
                + _mm(tuple(v.transpose(-1, -2) for v in g2op), (cc,))
            v = _mm((dyc,), _op(s, "state" in split))
            dc_parts[k, :, :, sl] = ecs[..., None] * v + _mm(g2op, (bc,))
            dcs = m.sum(-1) - m.sum(-2) + ecs * (cc * v).sum(-1) - u
            # sum_i u_i + e^{cs_L} <dS, S> = <dS, S'>, S' the state the
            # chunk ends in (S' = e^{cs_L} S + (x w)^T B)
            dcs[..., -1] += (ds * ends[c]).sum((-2, -1))
            dcs_parts[k, :, :, sl] = dcs
            edy = _op((dyc * ecs[..., None]).transpose(-1, -2), "edy" in split)
            ds = torch.exp(cs[..., -1])[..., None, None] * ds \
                + _mm(edy, (cc,))
        dinit[:, :, ps] = ds

    def in_order(parts, heads):
        """the partials summed over P blocks, then (``heads``) over the heads
        of each group, in order"""
        out = parts[0]
        for k in range(1, nblk):
            out = out + parts[k]
        if not heads:
            return out
        out = out.reshape(b, g, r, t, -1)
        tot = out[:, :, 0]
        for i in range(1, r):
            tot = tot + out[:, :, i]
        return tot

    dcs = in_order(dcs_parts, False)
    da = torch.zeros_like(dcs)
    for sl in (slice(c * chunk, min((c + 1) * chunk, t)) for c in range(nc)):
        da[..., sl] = dcs[..., sl].flip(-1).cumsum(-1).flip(-1)
    db = in_order(db_parts, True).transpose(1, 2)
    dc = in_order(dc_parts, True).transpose(1, 2)
    return (dx.transpose(1, 2).to(xb.dtype), da.transpose(1, 2),
            db.to(bmat.dtype), dc.to(cmat.dtype), dinit)


def real_decay_case(seed, b, t, h, p, n, init):
    """Model layout: mamba2's decay a = dt A (dt = softplus(N(0, 1) +
    dt_bias), A = -linspace(1, 16, H), down to about -1.6 a token), xb =
    N(0, 1) dt, B and C N(0, 1), one group, dy N(0, 1), all bf16; with
    ``init`` a starting state 0.5 N(0, 1) and dfinal N(0, 1) (fp32)."""
    rng = np.random.default_rng(seed)
    dt0 = np.exp(rng.random(h) * (np.log(1e-1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) + dt_bias))
    a = torch.from_numpy((dt * -np.linspace(1.0, 16.0, h)).astype(np.float32))
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    xb = bf(rng.standard_normal((b, t, h, p)) * dt[..., None])
    bm = bf(rng.standard_normal((b, t, 1, n)))
    cm = bf(rng.standard_normal((b, t, 1, n)))
    dy = bf(rng.standard_normal((b, t, h, p)))
    f32 = lambda v: torch.from_numpy(v.astype(np.float32))
    s0 = f32(0.5 * rng.standard_normal((b, h, p, n))) if init else None
    df = f32(rng.standard_normal((b, h, p, n))) if init else None
    return xb, a, bm, cm, s0, dy, df


def emulated_errors(seed, b, t, h, p, n, init, split=SPLIT):
    """{gradient: max |error| / (1 + |w|)} of the emulation against
    ``ssd_chunked_bwd_ref`` in float64 at chunk 64."""
    xb, a, bm, cm, s0, dy, df = real_decay_case(seed, b, t, h, p, n, init)
    got = ssd_bwd_emulated(xb, a, bm, cm, 64, s0, dy, df, split=split)
    d = lambda v: None if v is None else v.double()
    want = ref.ssd_chunked_bwd_ref(d(xb), d(a), d(bm), d(cm), 64, d(s0),
                                   d(dy), d(df))
    return {name: float(((g.double() - w).abs() / (1 + w.abs())).max())
            for name, g, w in zip(NAMES, got, want)}


def test_emulation_with_every_operand_split_is_the_plain_backward():
    """At a small size (two groups, P 40: a full and a padded P block,
    ragged chunks), the emulation equals the float64 plain backward to
    1e-3 (1 + |w|) (the check that it computes the same function, before
    its rounding is judged)."""
    xb, a, bm, cm, s0, dy, df = real_decay_case(3, 2, 100, 4, 40, 24, True)
    bm = torch.cat([bm, bm.flip(1)], 2)          # two groups
    cm = torch.cat([cm, cm.flip(1)], 2)
    got = ssd_bwd_emulated(xb, a, bm, cm, 32, s0, dy, df, split=OPERANDS)
    d = lambda v: v.double()
    want = ref.ssd_chunked_bwd_ref(d(xb), d(a), d(bm), d(cm), 32, d(s0),
                                   d(dy), d(df))
    for name, g, w in zip(NAMES, got, want):
        # dx, dB and dC are rounded to bf16 as the kernel writes them
        tol = 4e-3 if g.dtype == torch.bfloat16 else 1e-3
        assert float(((g.double() - w).abs() / (1 + w.abs())).max()) < tol, \
            name


@pytest.mark.parametrize("n", [128, 64])
@pytest.mark.parametrize("init", [False, True])
def test_bf16_backward_rounding_points_within_half_the_gate(n, init):
    """The kernel's rounding points (all six fp32 operands split into bf16
    hi + lo; fp32 accumulators; partials summed in P-block, then head
    order) at mamba2's decay, T 512,
    P 64 (two P blocks), chunk 64, N 128 (mamba2-1.3b) and 64 (zamba2-2.7b),
    with and without init and dfinal: every gradient within 1.5e-2 (1 + |w|)
    of the float64 plain backward."""
    errs = emulated_errors(21, 1, 512, 4, 64, n, init)
    assert max(errs.values()) <= BOUND, errs


@pytest.mark.parametrize("operand,n,init", [
    ("att", 128, True),       # dx
    ("g2", 64, True),         # dB (at N 128: 2.7e-2)
    ("ds", 128, True),        # dx
    ("state", 128, True),     # da
    ("xw", 128, False),       # da (with a starting state: 2.1e-2)
    ("edy", 128, True),       # dx
])
def test_rounding_a_split_operand_once_misses_the_gate(operand, n, init):
    """Each split is needed: with one operand rounded to bf16 once (the
    others split, as the kernel has them), some gradient misses the card's
    gate 3e-2 (1 + |w|) at one of the training widths, mamba2-1.3b's N 128
    or zamba2-2.7b's N 64 (the comment names it)."""
    split = tuple(o for o in SPLIT if o != operand)
    errs = emulated_errors(21, 1, 512, 4, 64, n, init, split=split)
    assert max(errs.values()) > GATE, errs


# ---------------------------------------------------------------------------
# the profiler's kernel families (launch/profile.py)
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FAMILY = (("ssd_bwd_", "ssd_scan_bwd"), ("ssd_scan_", "ssd_scan"),
          ("flash_", "flash_attention"), ("stage_merge", "stage_merge"),
          ("adam_update", "adam"), ("sumsq_", "adam"))


def port_kernels():
    """(name, templated) of every ``__global__`` function in csrc/*.cu."""
    found = []
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"(template\s*<[^>]*>\s*)?__global__\s+void\s+"
                             r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                             text):
            found.append((m.group(2), m.group(1) is not None))
    return found


def test_profile_families_pin_every_port_kernel():
    """Every kernel of csrc/, as the profiler names it (anonymous namespace,
    template arguments, parameters), falls in its own family, never in
    ``other`` with PyTorch's element-wise passes, and ``_OURS`` keeps its
    name; the SSD backward's kernels in ``ssd_scan_bwd``."""
    from repro_torch.launch import profile as PR
    kernels = port_kernels()
    names = {n for n, _ in kernels}
    assert {"ssd_bwd_bf16_kernel", "ssd_bwd_f32_kernel",
            "ssd_bwd_sum_kernel", "ssd_scan_bf16_kernel",
            "flash_fwd_bf16_kernel", "adam_update_kernel"} <= names
    assert len(kernels) == 15
    for name, templated in kernels:
        sig = (f"void (anonymous namespace)::{name}<128>((anonymous "
               f"namespace)::Params)" if templated else
               f"(anonymous namespace)::{name}((anonymous namespace)::Params)")
        want = next(f for prefix, f in FAMILY if name.startswith(prefix))
        assert PR._family(sig) == want, (name, PR._family(sig))
        assert PR._OURS.search(sig).group(1) == name
    assert PR._family("void at::native::vectorized_elementwise_kernel<4>"
                      "(int)") == "other"


if __name__ == "__main__":
    torch.set_num_threads(4)
    for label, split in [("the kernel's splits (all six)", SPLIT),
                         ("nothing split", ())] + [
            (f"{o} once, the rest split", tuple(s for s in SPLIT if s != o))
            for o in SPLIT]:
        for n, init in ((128, True), (128, False), (64, True)):
            errs = emulated_errors(21, 1, 512, 4, 64, n, init, split=split)
            print(f"{label:30s} N {n:3d} init {init!s:5s} "
                  + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
