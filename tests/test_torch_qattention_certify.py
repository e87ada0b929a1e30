"""The attention kernel's certified division, on the CPU.

``csrc/qattention.cu`` takes p_q = rint(RN32(RN32(e / total) * 127)) by a
branch-free fast path, RN32(RN32(e * RN32(1 / total)) * 127), and keeps it
only where it is proven to round as the exact steps do (its source comment
gives the proof), flagging the rest for the exact steps. Here ``pq_fast``
is cut from that source and built with the host C++ compiler, with host
definitions of the CUDA intrinsics it uses (each an IEEE operation,
correctly rounded on both), and held against the exact steps in f32 on
random (e, total) pairs and on pairs placed next to the half-integers of
127 e / total: where it certifies, it equals the exact p_q; it flags few
random pairs and most pairs next to a boundary.

The kernel itself is held against ``qattention_plain`` on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phases 10 and 14).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from tf2_tpu_torch.kernels import build

HOST = r"""
#include <cmath>
#include <cstdint>
#include <math.h>
#define __device__
#define __forceinline__ inline
static float __fmul_rn(float a, float b) { return a * b; }
static float __fsub_rn(float a, float b) { return a - b; }
static int __float2int_rn(float a) { return static_cast<int>(std::nearbyint(a)); }
"""

HARNESS = r"""
extern "C" long run_pq(const float* e, const float* total, int* q, long n) {
  long flagged = 0;
  for (long i = 0; i < n; ++i) {
    bool sure;
    const uint32_t v = pq_fast(e[i], 1.0f / total[i], sure);
    q[i] = sure ? static_cast<int>(v) : -1;
    flagged += !sure;
  }
  return flagged;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = (build.CSRC / "qattention.cu").read_text()
    body = src[src.index("__device__ __forceinline__ uint32_t pq_fast"):
               src.index("__device__ __noinline__ uint32_t pq_exact")]
    d = tmp_path_factory.mktemp("certify")
    (d / "certify.cpp").write_text(HOST + body + HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-o",
                    str(d / "certify.so"), str(d / "certify.cpp")], check=True)
    out = ctypes.CDLL(str(d / "certify.so"))
    out.run_pq.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
    out.run_pq.restype = ctypes.c_long
    return out


def _pairs(rng, case: str, n: int):
    """(e, total) in f32, e <= total as in the kernel."""
    if case == "random":
        total = rng.uniform(1.0, 4096.0, n).astype(np.float32)
        e = rng.uniform(0.0, 1.0, n).astype(np.float32)
        return np.concatenate([e, [0.0, 1.0, 1e-40]]).astype(np.float32), \
            np.concatenate([total, [1.0, 1.0, 3.0]]).astype(np.float32)
    # 127 e / total within 2^-12 of a half-integer
    k = rng.integers(0, 127, n) + 0.5 + rng.uniform(-2.0 ** -12, 2.0 ** -12, n)
    total = rng.uniform(1.0, 300.0, n).astype(np.float32)
    return np.minimum(k / 127 * total.astype(np.float64), total).astype(np.float32), total


@pytest.mark.parametrize("case", ["random", "near_boundary"])
def test_pq_fast_certifies_only_the_exact_pq(lib, case):
    e, total = _pairs(np.random.default_rng(0), case, 1 << 20)
    q = np.empty(e.size, np.int32)
    flagged = lib.run_pq(e.ctypes.data, total.ctypes.data, q.ctypes.data, e.size)
    sure = q >= 0
    want = np.rint((e / total).astype(np.float32) * np.float32(127)).astype(np.int32)
    print(f"{case}: {e.size} pairs, {flagged} flagged")
    np.testing.assert_array_equal(q[sure], want[sure])
    assert int((~sure).sum()) == flagged
    if case == "random":
        assert flagged < e.size // 1000
    else:
        assert flagged > e.size // 2
