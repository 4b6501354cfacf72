"""Number-format descriptors for transprecision computing (PyTorch port).

Immutable, hashable dataclasses keyed by name, as in ``repro.core.formats``:
the quantizer, the policy engine and the kernels all key off these objects.

Storage dtypes: torch's unsigned 16/32-bit types have thin op coverage, so
posit16 codes live in ``int16`` and posit32 codes in ``int32`` holding the
same bit patterns as the reference's ``uint16``/``uint32`` (compare through
``.view``).  Codes of 8 bits or fewer stay ``uint8``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Format:
    """Base class for all number formats."""

    name: str
    bits: int

    @property
    def bytes(self) -> float:
        return self.bits / 8.0


@dataclasses.dataclass(frozen=True)
class PositFormat(Format):
    """Posit P(n, es); ``bias`` is a power-of-two offset of the total
    exponent (0 is the paper-faithful format)."""

    es: int = 2
    bias: int = 0

    def __post_init__(self):
        if not (2 <= self.bits <= 32):
            raise ValueError(f"posit bits must be in [2,32], got {self.bits}")
        if not (0 <= self.es <= 3):
            raise ValueError(f"posit es must be in [0,3], got {self.es}")

    @property
    def useed(self) -> int:
        return 1 << (1 << self.es)

    @property
    def max_scale(self) -> int:
        """Max total binary exponent t (maxpos = 2**max_scale)."""
        return (1 << self.es) * (self.bits - 2)

    @property
    def storage_dtype(self) -> torch.dtype:
        return {8: torch.uint8, 16: torch.int16, 32: torch.int32}[
            8 * max(1, (self.bits + 7) // 8)
        ]


@dataclasses.dataclass(frozen=True)
class IntFormat(Format):
    """Signed integer with an implicit per-tensor/per-channel scale."""

    symmetric: bool = True

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1)) + (1 if self.symmetric else 0)

    @property
    def storage_dtype(self) -> torch.dtype:
        return (torch.int8 if self.bits <= 8
                else (torch.int16 if self.bits <= 16 else torch.int32))


@dataclasses.dataclass(frozen=True)
class FloatFormat(Format):
    """IEEE-style float; maps to a native torch dtype where one exists."""

    exp_bits: int = 8
    man_bits: int = 23

    @property
    def torch_dtype(self) -> torch.dtype:
        key = (self.bits, self.exp_bits, self.man_bits)
        table = {
            (32, 8, 23): torch.float32,
            (16, 5, 10): torch.float16,
            (16, 8, 7): torch.bfloat16,
            (8, 4, 3): torch.float8_e4m3fn,
            (8, 5, 2): torch.float8_e5m2,
        }
        if key not in table:
            raise ValueError(f"no native dtype for {self}")
        return table[key]


# ---------------------------------------------------------------------------
# Registry (the formats the TALU supports, plus native compute formats).
# ---------------------------------------------------------------------------

POSIT4_1 = PositFormat("posit4_1", 4, es=1)  # sub-byte KV-cache storage
POSIT8_0 = PositFormat("posit8_0", 8, es=0)
POSIT8_1 = PositFormat("posit8_1", 8, es=1)
POSIT8_2 = PositFormat("posit8_2", 8, es=2)   # the paper's DNN format
POSIT16_0 = PositFormat("posit16_0", 16, es=0)
POSIT16_1 = PositFormat("posit16_1", 16, es=1)
POSIT16_2 = PositFormat("posit16_2", 16, es=2)
POSIT32_2 = PositFormat("posit32_2", 32, es=2)

INT4 = IntFormat("int4", 4)
INT8 = IntFormat("int8", 8)
INT16 = IntFormat("int16", 16)
INT32 = IntFormat("int32", 32)

FP8_E4M3 = FloatFormat("fp8_e4m3", 8, exp_bits=4, man_bits=3)
FP8_E5M2 = FloatFormat("fp8_e5m2", 8, exp_bits=5, man_bits=2)
FP16 = FloatFormat("fp16", 16, exp_bits=5, man_bits=10)
BF16 = FloatFormat("bf16", 16, exp_bits=8, man_bits=7)
FP32 = FloatFormat("fp32", 32, exp_bits=8, man_bits=23)

REGISTRY = {
    f.name: f
    for f in [
        POSIT4_1, POSIT8_0, POSIT8_1, POSIT8_2, POSIT16_0, POSIT16_1, POSIT16_2,
        POSIT32_2, INT4, INT8, INT16, INT32, FP8_E4M3, FP8_E5M2, FP16,
        BF16, FP32,
    ]
}


def get(name) -> Format:
    if isinstance(name, Format):
        return name
    if name not in REGISTRY:
        raise KeyError(f"unknown format {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
