// SELL-32-sigma SpMV with explicit columns (K12, sell_cs): the light rows of
// an f32 row-split hybrid, y[row] = sum_j vals[slot j] * x[cols[slot j]].
//
// Replaces no TPU kernel.  On the TPU the hybrid's light rows ride SELL-8D
// slot bundles (spmv_tpu/ops/pallas_sell.py::_kernel_v2 in slot mode, K1
// slot here): x is cut into 1,024-column windows because it had to sit in
// VMEM, and a permuted scale-free graph spreads each short row over many
// bundles, so most slots of that stream are padding (33.7 slots a nonzero
// on Graph500 SCALE 19).  The card keeps an x of up to 2M f32 columns in
// its 50 MB L2, so this layout (spmv_tpu_torch/formats/sell_cs.py) stores
// each nonzero's column beside its value and needs no windows: rows sorted
// by length, slices of 32 rows, each slice column-major, about 8 B a
// nonzero.
//
// Bound on the H100: the two planes (int32 column, f32 value: 8 B a slot)
// stream once from device memory, and each slot gathers one x word, a 32-B
// L2 sector where x is L2-resident.  One warp takes a slice and one thread
// a row: at slot j the warp's 32 column loads and 32 value loads are each
// one coalesced 128-B line.  Latency is hidden by occupancy, not by
// staging: each thread runs a plain loop of one column load, one value load
// and one x gather a slot, in 32 registers, so every SM holds its full 64
// warps.  Measured on the H100 (Graph500 SCALE 19's light rows, 4.9 M
// nonzeros, 200 chained calls): this loop 51.1 us against 53.5, 52.7, 66.1
// and 59.0 us with 2, 4, 8 and 16 slots' loads issued before their FMAs (8
// and 16 take 40 and 78 registers, so fewer warps fit); in a later call,
// blocks of 4, 8, 16 and 32 warps 49.8, 50.5, 49.1 and 50.5 us, and __ldg
// planes 51.6.  Shared memory would only hold the two
// planes, which each warp already reads as whole lines; the x gathers, the
// larger cost, cannot be staged (x is megabytes).  The planes are read
// with the streaming hint (ld.global.cs: used once, evicted first) so that
// they do not push x out of the L2.
//
// Each thread sums its row's slots in slot order with one FMA each, in f32,
// with no atomics and no partial sums: the result is fixed, and repeats bit
// for bit from call to call.  Padding slots (column 0, value 0) add
// 0 * x[0].  Every lane of every slice writes its output row once; rows
// with no light nonzero (the heavy rows, empty rows) sit in slices of
// length 0 and get 0, so one pass writes the whole m-row output.
#include "common.cuh"

namespace spmv {
namespace {

constexpr int kSlice = 32;      // rows a slice: one warp
constexpr int kWarps = 16;      // slices a block

__global__ void __launch_bounds__(kSlice * kWarps)
sell_cs_kernel(const int32_t* __restrict__ slice_ptr,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               const float* __restrict__ vals, const float* __restrict__ x,
               float* __restrict__ y, int64_t nslices) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t s = t / kSlice;
  if (s >= nslices) return;
  const int lane = int(t % kSlice);
  const int32_t beg = __ldg(slice_ptr + s);
  const int len = (__ldg(slice_ptr + s + 1) - beg) / kSlice;
  const int32_t* c = cols + beg + lane;
  const float* v = vals + beg + lane;
  float acc = 0.0f;
  for (int j = 0; j < len; ++j)
    acc = fma_acc(__ldcs(v + j * kSlice), __ldg(x + __ldcs(c + j * kSlice)),
                  acc);
  const int32_t row = __ldg(rows + t);
  if (row >= 0) y[row] = acc;
}

}  // namespace
}  // namespace spmv

// slice_ptr: (nslices + 1,) int32, each slice's first slot (a slice of
// length L holds 32 * L slots); rows: (nslices * 32,) int32, each lane's
// output row, -1 for none; cols, vals: (slice_ptr[nslices],) int32 and f32;
// x: (n,) f32; y: (m,) f32, every row written.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int spmv_sell_cs_launch(const void* slice_ptr, const void* rows,
                                   const void* cols, const void* vals,
                                   const void* x, void* y, int64_t nslices,
                                   void* stream) {
  if (nslices <= 0) return 0;
  constexpr int kThreads = spmv::kSlice * spmv::kWarps;
  const int64_t blocks = (nslices + spmv::kWarps - 1) / spmv::kWarps;
  spmv::sell_cs_kernel<<<unsigned(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slice_ptr),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), nslices);
  return int(cudaGetLastError());
}
