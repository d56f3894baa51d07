// COO2 pass 1: the product stream of the two-pass CSR5 plan,
//   out[t, i, l] = vals[t, i, l] * x[1024 * w_t + 128 * s + r],
//   r = meta[t, i, l] & 127 (at the slot), s = (meta[t, i, r] >> 7) & 7 (at
//   the CELL (i, r)), w_t = window_ids[t]; columns >= n read 0.
//
// Replaces the TPU kernel spmv_tpu/ops/pallas_coo2.py::_make_pass1_kernel
// (K8, via _pass1).  There the grid ran 16 tiles a step, each tile's
// 1024-column window of x DMA'd into VMEM through a scalar-prefetched
// index map, and the gather was take_along_axis over sublanes (s) and then
// lanes (r); the first take reads s at (i, l) and the second picks lane r of
// that row, so s comes from the cell (i, r), as in the SELL kernels.  Here
// x stays in device memory: a thread per slot, a block per tile.
//
// Bound on the H100: device-memory bytes.  Each slot reads 2 B of meta and
// 4 B (f32) or 2 B (lossless bf16) of value and writes 4 B of product, all
// coalesced (neighbouring threads, neighbouring slots); the cell's meta is
// in the same 2 KB tile (L1), and the x gather stays inside one 4 KB window
// a tile, so x costs about one pass.  There is no reduction and no product
// for tensor cores.  Padding slots (value 0) multiply as the TPU kernel
// does, so a padding tile writes zeros for any finite x.
#include "common.cuh"

namespace spmv {
namespace {

template <bool kBf16>
__global__ void __launch_bounds__(kTile)
    coo2_pass1_kernel(const int32_t* __restrict__ window_ids,
                      const uint16_t* __restrict__ meta,
                      const void* __restrict__ vals,
                      const float* __restrict__ x, float* __restrict__ out,
                      int64_t n) {
  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;  // slot (i, l) = (tid >> 7, tid & 127)
  const int64_t k = t * kTile + tid;
  const uint16_t* mt = meta + t * kTile;
  const uint32_t r = __ldg(mt + tid) & 127u;
  const uint32_t s = (__ldg(mt + (tid >> 7) * kLanes + r) >> 7) & 7u;
  const int64_t col = int64_t(__ldg(window_ids + t)) * kTile + s * kLanes + r;
  float v;
  if constexpr (kBf16)
    v = bf16_bits_to_f32(__ldg(static_cast<const uint16_t*>(vals) + k));
  else
    v = __ldg(static_cast<const float*>(vals) + k);
  out[k] = v * (col < n ? __ldg(x + col) : 0.0f);
}

}  // namespace
}  // namespace spmv

// window_ids: (ntiles,) int32; meta: (ntiles, 8, 128) int16; vals: (ntiles,
// 8, 128) f32, or bf16 bits when bf16 != 0; x: (n,) f32; out: (ntiles, 8,
// 128) f32.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int spmv_coo2_launch(const void* window_ids, const void* meta,
                                const void* vals, const void* x, void* out,
                                int64_t ntiles, int64_t n, int64_t bf16,
                                void* stream) {
  if (ntiles <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(window_ids);
  auto m = static_cast<const uint16_t*>(meta);
  auto xf = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (bf16)
    spmv::coo2_pass1_kernel<true>
        <<<unsigned(ntiles), spmv::kTile, 0, st>>>(w, m, vals, xf, o, n);
  else
    spmv::coo2_pass1_kernel<false>
        <<<unsigned(ntiles), spmv::kTile, 0, st>>>(w, m, vals, xf, o, n);
  return int(cudaGetLastError());
}
