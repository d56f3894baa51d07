// DIA SpMV: y[i] = sum_d data[d, i] * x[i + off[d]]  (0 <= i + off[d] < n).
//
// Replaces the TPU kernels spmv_tpu/ops/pallas_dia.py::_make_kernel (K3,
// f32 / bf16 diagonals) and ::_make_kernel_df (K4, f64 matrices), and the
// XLA plan spmv_tpu/ops/xla_csr.py::dia_spmv that the JAX package runs when
// m is above the TPU kernels' VMEM bound.  K4 carries each f64 value as
// (hi, lo) f32 planes through error-free transforms because the TPU has no
// f64; the H100 has, so the f64 plan streams the f64 diagonals and sums in
// native f64: the same 8 B a slot, and all 53 bits of each value.
//
// Bound on the H100: device-memory bytes.  Per row it streams ndiags
// values (2 B in bf16, 4 B in f32, 8 B in f64) and writes y once; x is read
// ndiags times, but neighbouring rows read neighbouring x, so after the
// first diagonal the reads hit L1/L2 and x costs about one pass.  The TPU
// kernels kept x resident in VMEM and built each diagonal's shifted view
// with a lane roll; here a thread per row reads x[i + off] directly: the
// warp's 32 reads are contiguous for every diagonal, so they coalesce.
// Rows out of the band are guarded by 0 <= i + off < n instead of the
// TPU's zero guard rows.
#include <type_traits>

#include "common.cuh"

namespace spmv {
namespace {

enum DiaKind : int { kF32 = 0, kBf16 = 1, kF64 = 2 };

template <int kKind>
using DiaAcc = typename std::conditional<kKind == kF64, double, float>::type;

template <int kKind>
__global__ void dia_kernel(const void* __restrict__ data,
                           const int32_t* __restrict__ offsets,
                           const DiaAcc<kKind>* __restrict__ x,
                           DiaAcc<kKind>* __restrict__ y, int64_t m, int64_t n,
                           int ndiags) {
  using T = DiaAcc<kKind>;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    T acc = T(0);
    for (int d = 0; d < ndiags; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      const int64_t k = int64_t(d) * m + i;
      T v;
      if constexpr (kKind == kBf16)
        v = bf16_bits_to_f32(__ldg(static_cast<const uint16_t*>(data) + k));
      else
        v = __ldg(static_cast<const T*>(data) + k);
      if (j >= 0 && j < n) acc = fma_acc(v, __ldg(x + j), acc);
    }
    y[i] = acc;
  }
}

template <int kKind>
int launch(const void* data, const void* offsets, const void* x, void* y,
           int64_t m, int64_t n, int64_t ndiags, cudaStream_t stream) {
  using T = DiaAcc<kKind>;
  constexpr int kThreads = 256;
  const int64_t want = (m + kThreads - 1) / kThreads;
  const int blocks = int(want < 132 * 32 ? want : 132 * 32);
  dia_kernel<kKind><<<blocks, kThreads, 0, stream>>>(
      data, static_cast<const int32_t*>(offsets), static_cast<const T*>(x),
      static_cast<T*>(y), m, n, int(ndiags));
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace spmv

// data: (ndiags, m) f32, bf16 bits or f64; offsets: (ndiags,) int32; x: (n,)
// and y: (m,), f64 for f64 data, else f32.  kind: 0 f32, 1 bf16, 2 f64.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int spmv_dia_launch(const void* data, const void* offsets,
                               const void* x, void* y, int64_t m, int64_t n,
                               int64_t ndiags, int64_t kind, void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case spmv::kF32:
      return spmv::launch<spmv::kF32>(data, offsets, x, y, m, n, ndiags, st);
    case spmv::kBf16:
      return spmv::launch<spmv::kBf16>(data, offsets, x, y, m, n, ndiags, st);
    case spmv::kF64:
      return spmv::launch<spmv::kF64>(data, offsets, x, y, m, n, ndiags, st);
    default: return int(cudaErrorInvalidValue);
  }
}
