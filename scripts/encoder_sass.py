#!/usr/bin/env python3
"""Static SASS instructions per element of the posit codec's device
functions (``posit::encode`` and ``posit::decode`` in
``src/repro_torch/csrc/posit_codec.cuh``, and where the checkout has it
the run-time-es form ``posit::decode_es<16>`` that K7's 16-bit paths call,
and the gradient wire's normalising ``posit::encode<N, ES, true>``, K2's
wire mode) for one checkout, so that two commits' codecs can be compared (the
parent's and the change's, unpacked side by side):

    python3 scripts/encoder_sass.py [--root DIR]

Each count is a kernel that encodes (or decodes) one element per thread,
compiled with nvcc for sm_90a against DIR's codec header and read back
with ``cuobjdump -sass``, less the same kernel with the codec replaced by
one add; NOPs are not counted.  A static count of the code as written:
both sides of a branch count, whichever one an element takes.  So it is
a diagnostic of the codec, not a bound on K1 or K2.

Where ``nvidia-smi`` answers, the line also carries
``issue_at_current_sass_us``: the posit8_2 count times the kernels line's
2^21 elements over 132 SMs x 128 thread-instructions per SM per clock
(four schedulers of one warp instruction each) at the max SM clock, the
time the codec as written would take to issue if nothing else limited it.
Needs the CUDA toolkit; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
H100_SMS, ISSUE_PER_SM_CLOCK = 132, 128
N_ELEMENTS = 1 << 21                # chip_smoke.py's K1/K2 shape

SASS_PROBE = r"""
#include "posit_codec.cuh"
template <int N, int ES>
__global__ void encode_probe(const float* x,
                             typename posit::Code<N>::type* c, int bias) {
  c[threadIdx.x] =
      (typename posit::Code<N>::type)posit::encode<N, ES>(x[threadIdx.x],
                                                          bias);
}
template <int N, int ES>
__global__ void decode_probe(const typename posit::Code<N>::type* c,
                             float* y, int bias) {
  y[threadIdx.x] = posit::decode<N, ES>(c[threadIdx.x], bias);
}
#ifdef HAS_DECODE_ES
template <int N>
__global__ void decode_es_probe(const typename posit::Code<N>::type* c,
                                float* y, int es, int bias) {
  y[threadIdx.x] = posit::decode_es<N>(c[threadIdx.x], es, bias);
}
template __global__ void decode_es_probe<16>(const uint16_t*, float*, int,
                                             int);
#endif
#ifdef HAS_ENCODE_WIRE
template <int N, int ES>
__global__ void encode_wire_probe(const float* x,
                                  typename posit::Code<N>::type* c,
                                  int bias) {
  c[threadIdx.x] = (typename posit::Code<N>::type)
      posit::encode<N, ES, true>(x[threadIdx.x], bias);
}
#define WIRE_PROBE(N, ES)                                                 \
  template __global__ void encode_wire_probe<N, ES>(                      \
      const float*, posit::Code<N>::type*, int);
POSIT_FORMATS(WIRE_PROBE)
#endif
template <int N>
__global__ void encode_skeleton(const float* x,
                                typename posit::Code<N>::type* c, int bias) {
  c[threadIdx.x] = (typename posit::Code<N>::type)(
      __float_as_uint(x[threadIdx.x]) + bias);
}
template <int N>
__global__ void decode_skeleton(const typename posit::Code<N>::type* c,
                                float* y, int bias) {
  y[threadIdx.x] = __uint_as_float(c[threadIdx.x] + bias);
}
#define PROBE(N, ES)                                                      \
  template __global__ void encode_probe<N, ES>(                           \
      const float*, posit::Code<N>::type*, int);                         \
  template __global__ void decode_probe<N, ES>(                           \
      const posit::Code<N>::type*, float*, int);
POSIT_FORMATS(PROBE)
template __global__ void encode_skeleton<8>(const float*, uint8_t*, int);
template __global__ void encode_skeleton<16>(const float*, uint16_t*, int);
template __global__ void decode_skeleton<8>(const uint8_t*, float*, int);
template __global__ void decode_skeleton<16>(const uint16_t*, float*, int);
"""


def sass_per_element(csrc: Path, out: Path, nvcc: str) -> dict:
    """Static SASS instructions (NOPs left out) of ``posit::encode`` and
    ``posit::decode`` per element for every built format, against the
    codec header in ``csrc``, and of ``posit::decode_es<16>`` and the
    wire mode ``posit::encode<N, ES, true>`` where the header has them.
    Returns {"encode": {fmt: n}, "decode": {fmt: n}, "decode_es":
    {"posit16": n} or {}, "encode_wire": {fmt: n} or {}}."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "sass_probe.cu").write_text(SASS_PROBE)
    cubin = out / "sass_probe.cubin"
    header = (csrc / "posit_codec.cuh").read_text()
    flags = [f for f, has in (("-DHAS_DECODE_ES", "decode_es" in header),
                              ("-DHAS_ENCODE_WIRE", "kNormalize" in header))
             if has]
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(csrc), *flags, "-o",
                    str(cubin), str(out / "sass_probe.cu")], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = 0
            continue
        # cuobjdump prints padding as "NOP;": the opcode stops at ";"
        ins = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)", line)
        if name and ins and ins.group(1) != "NOP":
            counts[name] += 1
    by = {}
    for mangled, n in counts.items():
        m = re.search(r"(encode_wire|encode|decode_es|decode)_"
                      r"(probe|skeleton)ILi(\d+)E(?:Li(\d+)E)?", mangled)
        if m:
            by[m.groups()] = n
    res = {"encode": {}, "decode": {}, "decode_es": {}, "encode_wire": {}}
    for (kind, role, bits, es), n in by.items():
        if role == "probe":
            code = "8" if int(bits) <= 8 else "16"
            skeleton = by[(kind.split("_")[0], "skeleton", code, None)]
            name = f"posit{bits}" + (f"_{es}" if es else "")
            res[kind][name] = n - skeleton
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build
    res = {"root": str(root), **sass_per_element(
        root / "src" / "repro_torch" / "csrc", root / "build" / "sass_probe",
        _build._nvcc())}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = None
    if smi:
        card, limit, clock = (s.strip() for s in smi.split(","))
        hz = float(clock.split()[0]) * 1e6
        res.update(card=card, power_limit=limit, sm_clock_max=clock,
                   issue_at_current_sass_us={
                       kind: res[kind]["posit8_2"] * N_ELEMENTS
                       / (H100_SMS * ISSUE_PER_SM_CLOCK * hz) * 1e6
                       for kind in ("encode", "decode")})
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
