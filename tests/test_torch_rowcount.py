"""A CPU product's rows do not depend on how many rows share the call
(``repro_torch.models.common._einsum``).

MKL's SGEMM gives a row of a call of a few rows (1-3 on one thread, up
to 11 on two) or a column of a call under 12 columns other bits than the
same row of a larger call.  ``_einsum`` pads each operand's free dims to
16 rows on the CPU.  Here every row count from 1 to 20 of the serving
path's weight and attention products, at paper-edge smoke widths
(d_model 64, 4 / 2 heads of 16, d_ff 128, vocab_pad 256, a 64-row cache)
and the MoE combine's token columns, is held bit for bit to the same
rows of a 32-row call, at one and two torch threads, and to the rows of
``jnp.einsum``'s 32-row call (every contraction here is at most 128
long, where torch's large calls and XLA's dot agree).  The 2-D weight
products are also held to ``jnp.einsum`` at the same row count: XLA's
dot gives those rows the same bits at every count.  Its batched dots do
not: XLA's own rows of the scores differ from its 32-row call at every
count below it, of the values at 1-8 rows, of the MoE combine at 1."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro_torch.models.common import _einsum  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FULL = 32
ROWS = range(1, 21)

# (equation, a's shape, b's shape) with "m" the swept dim: the QKV, output,
# MLP and head products of a decode step (m slots) and a verify or
# prefill chunk (m tokens), the chunk attention's scores and values (m
# query tokens against a 64-row cache), and the MoE combine (m tokens as
# the product's columns)
CASES = {
    "qkv_slots": ("bsd,dk->bsk", ("m", 1, 64), (64, 128)),
    "qkv_chunk": ("bsd,dk->bsk", (1, "m", 64), (64, 128)),
    "wo": ("bsk,kd->bsd", ("m", 1, 64), (64, 64)),
    "mlp_in": ("bsd,df->bsf", (1, "m", 64), (64, 256)),
    "mlp_out": ("bsf,fd->bsd", ("m", 1, 128), (128, 64)),
    "head": ("bsd,dv->bsv", (2, "m", 64), (64, 256)),
    "head_rows": ("bd,dv->bv", ("m", 64), (64, 256)),
    "scores": ("bqkgh,bskh->bkgqs", (2, "m", 2, 2, 16), (2, 64, 2, 16)),
    "values": ("bkgqs,bskh->bqkgh", (2, 2, 2, "m", 64), (2, 64, 2, 16)),
    "moe_combine": ("ecd,tec->td", (4, 8, 64), ("m", 4, 8)),
}
# the products whose rows XLA's dot computes alike at every row count
XLA_ROW_STABLE = {"qkv_slots", "qkv_chunk", "wo", "mlp_in", "mlp_out",
                  "head", "head_rows"}


def _operands(case):
    """(eq, a, b at FULL rows, the swept dim of a, of b (None where the
    operand has none) and of the output)."""
    eq, sa, sb = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    full = [tuple(FULL if d == "m" else d for d in s) for s in (sa, sb)]
    a, b = (rng.standard_normal(s).astype(np.float32) for s in full)
    (la, lb), lo = eq.split("->")[0].split(","), eq.split("->")[1]
    label = la[sa.index("m")] if "m" in sa else lb[sb.index("m")]
    return (eq, a, b, la.find(label) if "m" in sa else None,
            lb.find(label) if "m" in sb else None, lo.index(label))


def _cut(x, dim, m):
    return x if dim is None else np.take(x, np.arange(m), axis=dim)


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_do_not_depend_on_the_row_count(case, threads):
    eq, a, b, da, db, out_dim = _operands(case)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        full = _einsum(eq, torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(full, np.asarray(jnp.einsum(eq, a, b)),
                                      err_msg=f"{case} vs jnp")
        for m in ROWS:
            am, bm = _cut(a, da, m), _cut(b, db, m)
            got = _einsum(eq, torch.from_numpy(am),
                          torch.from_numpy(bm)).numpy()
            want = _cut(full, out_dim, m)
            assert got.shape == want.shape, (case, m)
            np.testing.assert_array_equal(got, want, err_msg=f"{case} m={m}")
            if case in XLA_ROW_STABLE:
                np.testing.assert_array_equal(
                    got, np.asarray(jnp.einsum(eq, am, bm)),
                    err_msg=f"{case} m={m} vs jnp")
    finally:
        torch.set_num_threads(before)


def test_the_padding_is_the_cpus_alone():
    """On the meta device (the op counter's and the dry run's traces)
    ``_einsum`` is ``torch.einsum``: the operands reach it unpadded."""
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        seen.append(tuple(tuple(o.shape) for o in ops))
        return real(eq, *ops)

    torch.einsum = spy
    try:
        a = torch.empty((1, 3, 64), device="meta")
        w = torch.empty((64, 128), device="meta")
        assert _einsum("bsd,dk->bsk", a, w).shape == (1, 3, 128)
        _einsum("bsd,dk->bsk", torch.zeros(a.shape), torch.zeros(w.shape))
    finally:
        torch.einsum = real
    assert seen == [((1, 3, 64), (64, 128)), ((1, 16, 64), (64, 128))]
