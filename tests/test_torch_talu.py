"""The port's copies of the Q-function micro-ops (``repro_torch.core.qfunc``)
and the TALU cycle simulator (``repro_torch.core.talu``): the reference's
``tests/test_qfunc_talu.py`` cases run against them, and every Table III
cell, the simulator's measures and the vector unit equal the reference's.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import formats as jformats  # noqa: E402
from repro.core import talu as j_talu  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import posit_ref, qfunc  # noqa: E402
from repro_torch.core.talu import (TABLE3, TALU, CycleCounter,  # noqa: E402
                                   VectorUnit)
from _torch_threads import torch_threads  # noqa: E402,F401

BYTES = np.arange(256)
A = np.repeat(BYTES, 256)
B = np.tile(BYTES, 256)

# (Table III config, simulator kind, format name, bits, Table III op):
# the reference's test_table3_reproduced_exactly cells
CELLS = [
    ("P(8,0)", "posit_decode", "posit8_0", None, "decode"),
    ("P(8,2)", "posit_decode", "posit8_2", None, "decode"),
    ("P(16,0)", "posit_decode", "posit16_0", None, "decode"),
    ("P(16,2)", "posit_decode", "posit16_2", None, "decode"),
    ("P(8,0)", "posit_mul", "posit8_0", None, "mul"),
    ("P(8,2)", "posit_mul", "posit8_2", None, "mul"),
    ("P(16,0)", "posit_mul", "posit16_0", None, "mul"),
    ("P(16,2)", "posit_mul", "posit16_2", None, "mul"),
    ("P(8,0)", "posit_add", "posit8_0", None, "add"),
    ("P(8,2)", "posit_add", "posit8_2", None, "add"),
    ("P(16,0)", "posit_add", "posit16_0", None, "add"),
    ("P(16,2)", "posit_add", "posit16_2", None, "add"),
    ("INT4", "int_mul", None, 4, "mul"),
    ("INT8", "int_mul", None, 8, "mul"),
    ("INT16", "int_mul", None, 16, "mul"),
    ("INT4", "int_add", None, 4, "add"),
    ("INT8", "int_add", None, 8, "add"),
    ("INT16", "int_add", None, 16, "add"),
    ("FP8", "fp_mul", None, 8, "mul"),
    ("FP16", "fp_mul", None, 16, "mul"),
    ("FP8", "fp_add", None, 8, "add"),
    ("FP16", "fp_add", None, 16, "add"),
]


def test_q_logic_ops_exhaustive():
    for i in range(8):
        np.testing.assert_array_equal(qfunc.q_and(A, B, i),
                                      (A >> i) & (B >> i) & 1)
        np.testing.assert_array_equal(qfunc.q_or(A, B, i),
                                      ((A >> i) | (B >> i)) & 1)
        np.testing.assert_array_equal(qfunc.q_not(B, i), 1 - ((B >> i) & 1))
        m = (1 << (i + 1)) - 1
        np.testing.assert_array_equal(qfunc.q_comp(A, B, i),
                                      ((A & m) >= (B & m)).astype(int))


@pytest.mark.parametrize("c0", [0, 1])
def test_q_add_planes_exhaustive(c0):
    """ADD = carry plane (Table I) then sum plane (Table II)."""
    s, cout = qfunc.cluster_add(A, B, p=8, c0=c0)
    np.testing.assert_array_equal(s, (A + B + c0) & 0xFF)
    np.testing.assert_array_equal(cout, (A + B + c0) >> 8)


def test_q_xor_two_step_exhaustive():
    np.testing.assert_array_equal(qfunc.cluster_xor(A, B, p=8), A ^ B)


def test_q_posit_decode_row():
    """Table I's posit-decode row: the V thermometer of P(8,2) 01110100."""
    t_val = 0b1110100
    v = [int(qfunc.q_posit_decode_compare(t_val, i, p=8)) for i in range(7)]
    assert sum(v) == 3 and v == [0, 0, 0, 0, 1, 1, 1]


def test_talu_int_mul_accurate():
    t = TALU()
    rng = np.random.default_rng(0)
    for bits in (4, 8, 16):
        for _ in range(20):
            a = int(rng.integers(0, 1 << bits))
            b = int(rng.integers(0, 1 << bits))
            assert t.int_mul(a, b, bits=bits) == a * b


def test_talu_posit_ops_match_oracle():
    """The reference's property case on 60 seeded P(8,2) pairs (edges
    included), against the port's oracle and the reference's simulator."""
    rng = np.random.default_rng(1)
    pairs = [(0, 0), (0, 128), (128, 5), (255, 1), (127, 127)] + [
        tuple(int(v) for v in rng.integers(0, 256, 2)) for _ in range(55)]
    t, j = TALU(), j_talu.TALU()
    jf, tf = jformats.POSIT8_2, tformats.POSIT8_2
    for a, b in pairs:
        got_m, got_a = t.posit_mul(a, b, tf), t.posit_add(a, b, tf)
        assert got_m == posit_ref.mul(a, b, 8, 2) == j.posit_mul(a, b, jf)
        assert got_a == posit_ref.add(a, b, 8, 2) == j.posit_add(a, b, jf)
    assert t.cc.cycles == j.cc.cycles


def test_posit_decode_fields_every_p8_code():
    t, j = TALU(), j_talu.TALU()
    for c in range(1, 256):
        if c == 128:
            continue
        assert t.posit_decode(c, tformats.POSIT8_2) == \
            j.posit_decode(c, jformats.POSIT8_2) == \
            posit_ref.decode_fields(c, 8, 2)
    assert t.cc.cycles == j.cc.cycles == 2 * 254


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[4]}")
def test_table3_cell_equals_reference(cell):
    """Every cell of the reference's test_table3_reproduced_exactly: the
    port's measure equals TABLE3 and the reference's measure."""
    cfg, kind, name, bits, op = cell
    ours = TALU().measure(kind, fmt=name and tformats.get(name),
                          bits=bits or 8)
    ref = j_talu.TALU().measure(kind, fmt=name and jformats.get(name),
                                bits=bits or 8)
    assert ours == TABLE3[(cfg, op)] == ref


def test_table3_equals_reference():
    assert TABLE3 == j_talu.TABLE3


def test_vector_unit_lockstep():
    v, j = VectorUnit(), j_talu.VectorUnit()
    assert v.vector_op_cycles(19, 128) == 19
    assert v.vector_op_cycles(19, 129) == 38
    assert v.matmul_cycles(3, 3, 3, 19, 23) == 19 + 23 == \
        j.matmul_cycles(3, 3, 3, 19, 23)
    for args in ((3, 3, 3, 19, 23), (64, 768, 768, 19, 23)):
        assert v.throughput_kernels_per_s(*args) == \
            j.throughput_kernels_per_s(*args)
        assert v.energy_per_kernel_j(*args) == j.energy_per_kernel_j(*args)
    assert CycleCounter().cycles == 0
