// DIA SpMV: y[i] = sum_d data[d, i] * x[i + off[d]]  (0 <= i + off[d] < n).
//
// Replaces the TPU kernel spmv_tpu/ops/pallas_dia.py::_make_kernel (K3),
// and the XLA plan spmv_tpu/ops/xla_csr.py::dia_spmv that the JAX package
// runs when m is above the TPU kernel's VMEM bound.
//
// Bound on the H100: device-memory bytes.  Per row it streams ndiags
// values (2 B in bf16, 4 B in f32) and writes 4 B of y; x is read ndiags
// times, but neighbouring rows read neighbouring x, so after the first
// diagonal the reads hit L1/L2 and x costs about one pass.  The TPU kernel
// kept x resident in VMEM and built each diagonal's shifted view with a
// lane roll; here a thread per row reads x[i + off] directly: the warp's
// 32 reads are contiguous for every diagonal, so they coalesce.  Rows out
// of the band are guarded by 0 <= i + off < n instead of the TPU's zero
// guard rows.
#include "common.cuh"

namespace spmv {
namespace {

template <bool kBf16>
__global__ void dia_kernel(const void* __restrict__ data,
                           const int32_t* __restrict__ offsets,
                           const float* __restrict__ x, float* __restrict__ y,
                           int64_t m, int64_t n, int ndiags) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    float acc = 0.f;
    for (int d = 0; d < ndiags; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      const int64_t k = int64_t(d) * m + i;
      const float v =
          kBf16 ? bf16_bits_to_f32(__ldg(static_cast<const uint16_t*>(data) + k))
                : __ldg(static_cast<const float*>(data) + k);
      if (j >= 0 && j < n) acc = fmaf(v, __ldg(x + j), acc);
    }
    y[i] = acc;
  }
}

}  // namespace
}  // namespace spmv

// data: (ndiags, m) f32 or bf16 bits; offsets: (ndiags,) int32; x: (n,) f32;
// y: (m,) f32.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int spmv_dia_launch(const void* data, const void* offsets,
                               const void* x, void* y, int64_t m, int64_t n,
                               int64_t ndiags, int64_t bf16, void* stream) {
  if (m <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t want = (m + kThreads - 1) / kThreads;
  const int blocks = int(want < 132 * 32 ? want : 132 * 32);
  auto st = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int32_t*>(offsets);
  auto xf = static_cast<const float*>(x);
  auto yf = static_cast<float*>(y);
  if (bf16)
    spmv::dia_kernel<true><<<blocks, kThreads, 0, st>>>(data, off, xf, yf, m, n,
                                                        int(ndiags));
  else
    spmv::dia_kernel<false><<<blocks, kThreads, 0, st>>>(data, off, xf, yf, m,
                                                         n, int(ndiags));
  return int(cudaGetLastError());
}
