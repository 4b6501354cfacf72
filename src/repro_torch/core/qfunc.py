"""Q-function threshold-logic primitive (paper Eq. 3) and Table I/II mappings
(a copy of ``repro.core.qfunc``: numpy only).

A threshold function is a unate Boolean function with linearly separable
on/off sets (Eq. 2).  The paper's generalized template is

    Q(p, Z0, X, Z1, Y) = [ Z0 + sum_j 2^j X_j  >=  Z1 + sum_j 2^j Y_j ]

Eight physical Q blocks form a *cluster*; TALU has two clusters (PC, SC).
Every TALU operation in Tables I and II is an argument mapping of this single
template.  This module implements the template bit-accurately (vectorized
numpy — this layer is the cycle-level simulator substrate, not the
device's hot path) and exposes each table row as a function of packed integer operands.

Conventions: operands are unsigned integers held in numpy arrays; ``p`` is
the slice width (the paper uses p = 8).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "q_eval", "q_and", "q_or", "q_not", "q_comp", "q_add_carry", "q_add_sum",
    "q_xor_step1", "q_xor_step2", "q_posit_decode_compare", "cluster_add",
    "cluster_and", "cluster_or", "cluster_not", "cluster_xor",
]


def _bit(v, i):
    return (np.asarray(v, np.int64) >> i) & 1


def q_eval(z0, x, z1, y):
    """The Q template on already-summed integer arguments.

    x, y are the integer values sum_j 2^j X_j / sum_j 2^j Y_j (callers build
    them from bit selections exactly as Tables I/II specify).
    """
    return ((np.asarray(z0, np.int64) + np.asarray(x, np.int64)) >=
            (np.asarray(z1, np.int64) + np.asarray(y, np.int64))).astype(np.int64)


# --- Table I: Primary Cluster ops (one Q evaluation per output bit) --------

def q_and(a, b, i):
    return q_eval(0, _bit(a, i), 1, 1 - _bit(b, i))          # {0^{p-1}, ~B_i}


def q_or(a, b, i):
    return q_eval(0, _bit(a, i), 0, 1 - _bit(b, i))


def q_not(b, i):
    return q_eval(0, 1 - _bit(b, i), 1, 0)


def q_comp(a, b, i, p=8):
    """A[i:0] >= B[i:0]."""
    m = (1 << (i + 1)) - 1
    return q_eval(0, np.asarray(a, np.int64) & m, 0, np.asarray(b, np.int64) & m)


def q_add_carry(a, b, i, c0=0):
    """ADD step 1: Carry_{i+1} = [C0 + A[i:0] >= 1 + ~B[i:0]] (Table I)."""
    m = (1 << (i + 1)) - 1
    nb = (~np.asarray(b, np.int64)) & m
    return q_eval(c0, np.asarray(a, np.int64) & m, 1, nb)


def q_xor_step1(a, b, i):
    return q_and(a, b, i)


def q_posit_decode_compare(t_val, i, p=8):
    """Posit decode row: V_i = [T[p-2:0] >= 2^{p-1}-1-(2^i-1)]."""
    thr = (1 << (p - 1)) - 1 - ((1 << i) - 1)
    return q_eval(0, np.asarray(t_val, np.int64), 0, thr)


# --- Table II: Secondary Cluster ops ---------------------------------------

def q_add_sum(a, b, i, carry_i, carry_ip1):
    """ADD step 2: Sum_i = [A_i + B_i >= 2*Carry_{i+1} + ~Carry_i]."""
    y = 2 * np.asarray(carry_ip1, np.int64) + (1 - np.asarray(carry_i, np.int64))
    return q_eval(_bit(a, i), _bit(b, i), 0, y)


def q_xor_step2(a, b, i, and_i):
    """XOR step 2: [A_i + B_i >= 1 + 2*AND_i]."""
    return q_eval(_bit(a, i), _bit(b, i), 1, 2 * np.asarray(and_i, np.int64))


# --- whole-cluster (p-bit) operations: p parallel Q blocks, 1 cycle each ---

def cluster_and(a, b, p=8):
    return sum(q_and(a, b, i) << i for i in range(p))


def cluster_or(a, b, p=8):
    return sum(q_or(a, b, i) << i for i in range(p))


def cluster_not(b, p=8):
    return sum(q_not(b, i) << i for i in range(p))


def cluster_add(a, b, p=8, c0=0):
    """Two-cycle ADD: carry plane on PC, sum plane on SC.

    Returns (sum mod 2^p, carry_out).  This is the paper's key demonstration
    that both the CLA carries and the sum bits are threshold functions.
    """
    carries = [np.asarray(c0, np.int64)]
    for i in range(p):
        carries.append(q_add_carry(a, b, i, c0))
    s = sum(q_add_sum(a, b, i, carries[i], carries[i + 1]) << i for i in range(p))
    return s, carries[p]


def cluster_xor(a, b, p=8):
    """Two-cycle XOR: AND plane (PC) then XOR plane (SC)."""
    ands = [q_xor_step1(a, b, i) for i in range(p)]
    return sum(q_xor_step2(a, b, i, ands[i]) << i for i in range(p))
