// SELL tile-stream SpMV over the JAX package's grouped (8, 128) tiles, in
// its row mode (SELL-8W v2) and slot mode (SELL-8D).
//
// Replaces the TPU kernel spmv_tpu/ops/pallas_sell.py::_kernel_v2 (K1),
// launched there by _run_v2 for build_sell8w_v2_fn (row mode) and the
// resident branch of build_sell8d_fn (slot mode).
//
// Decode, per slot (i, l) of tile t (meta read as uint16):
//   r    = meta[t, i, l] & 127                       (at the slot)
//   s    = (meta[t, i, r] >> 7) & 7                  (at the CELL (i, r))
//   wsel = (meta[., i, .] >> 10) & (nw - 1)          (at the cell with cell_w,
//                                                     else at the slot)
//   code = (meta[t, i, l] >> (10 + lb)) & (63 >> lb) (palette, at the slot)
//   col  = base + 1024 * wsel + 128 * s + r,  base = (tinfo[t] >> 3) * nw*1024
// Row mode sums a tile's 8 sublanes into row (tinfo[t] & 7) * 128 + l of
// its 1024-row output block; slot mode adds slot (i, l) into row
// 128 * i + l.  Padding slots hold value 0; columns >= n read 0.
//
// Bound on the H100: device-memory bytes per padded slot (2 B meta, plus
// 2 B bf16 or 4 B f32 values; palette values live in the meta bits) and
// the dependent loads per slot (meta -> cell meta -> x).  The TPU grid ran
// the tile stream in order on one core, carrying each output block in
// VMEM; here the stream is cut into chunks of at most kChunkTiles tiles
// that never straddle an output block, one CUDA block of 1024 threads per
// chunk (a thread per slot), so even a plan with few output blocks fills
// the card.  Each chunk writes its 1024 partial row sums; a second kernel
// adds a block's chunks in order.  No atomics: the result is deterministic.
#include "common.cuh"

namespace spmv {
namespace {

enum ValueMode : int { kF32 = 0, kBf16 = 1, kPalette = 2 };

template <int kVM, bool kSlot, int kNw, bool kCellW>
__global__ void __launch_bounds__(kTile)
    sell_chunk_kernel(const uint16_t* __restrict__ meta,
                      const void* __restrict__ vals,
                      const float* __restrict__ palette,
                      const int32_t* __restrict__ tinfo,
                      const int32_t* __restrict__ chunk_step_ptr,
                      const float* __restrict__ x,
                      float* __restrict__ partial, int64_t g, int64_t n) {
  constexpr int kLb = kNw == 8 ? 3 : kNw == 4 ? 2 : kNw == 2 ? 1 : 0;
  const int tid = threadIdx.x;  // slot (i, l) = (tid >> 7, tid & 127)
  const int i = tid >> 7;
  const int64_t t0 = int64_t(chunk_step_ptr[blockIdx.x]) * g;
  const int64_t t1 = int64_t(chunk_step_ptr[blockIdx.x + 1]) * g;
  float acc[kSlot ? 1 : kSub];
#pragma unroll
  for (int j = 0; j < (kSlot ? 1 : kSub); ++j) acc[j] = 0.f;

  for (int64_t t = t0; t < t1; ++t) {
    const int32_t ti = __ldg(tinfo + t);
    const uint16_t* mt = meta + t * kTile;
    const uint32_t ms = __ldg(mt + tid);
    const uint32_t r = ms & 127u;
    const uint32_t mc = __ldg(mt + i * kLanes + r);  // the cell (i, r)
    const uint32_t s = (mc >> 7) & 7u;
    int64_t col = int64_t(ti >> 3) * (kSlot ? kNw * kTile : kTile) +
                  s * kLanes + r;
    if (kSlot && kNw > 1)
      col += int64_t(((kCellW ? mc : ms) >> 10) & (kNw - 1)) * kTile;
    float v;
    if (kVM == kPalette)
      v = __ldg(palette + ((ms >> (10 + kLb)) & (63u >> kLb)));
    else if (kVM == kBf16)
      v = bf16_bits_to_f32(
          __ldg(static_cast<const uint16_t*>(vals) + t * kTile + tid));
    else
      v = __ldg(static_cast<const float*>(vals) + t * kTile + tid);
    const float xv = col < n ? __ldg(x + col) : 0.f;
    if (kSlot) {
      acc[0] = fmaf(v, xv, acc[0]);
    } else {
      const int row = ti & 7;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (j == row) acc[j] = fmaf(v, xv, acc[j]);
    }
  }

  float* out = partial + int64_t(blockIdx.x) * kTile;
  if (kSlot) {
    out[tid] = acc[0];
    return;
  }
  // row mode: row j of the block gets the sum over sublanes i of acc_i[j]
  __shared__ float red[kSub][kTile];  // red[j][i * 128 + l], 32 KB
#pragma unroll
  for (int j = 0; j < kSub; ++j) red[j][tid] = acc[j];
  __syncthreads();
  const int row = tid >> 7, l = tid & 127;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kSub; ++k) sum += red[row][k * kLanes + l];
  out[tid] = sum;
}

// out[b, :] = sum of the partials of block b's chunks, in chunk order.
__global__ void __launch_bounds__(kTile)
    sell_reduce_kernel(const float* __restrict__ partial,
                       const int32_t* __restrict__ block_chunk_ptr,
                       float* __restrict__ out) {
  const int64_t b = blockIdx.x;
  float sum = 0.f;
  for (int32_t c = block_chunk_ptr[b]; c < block_chunk_ptr[b + 1]; ++c)
    sum += partial[int64_t(c) * kTile + threadIdx.x];
  out[b * kTile + threadIdx.x] = sum;
}

struct Args {
  const uint16_t* meta;
  const void* vals;
  const float* palette;
  const int32_t* tinfo;
  const int32_t* chunk_step_ptr;
  const int32_t* block_chunk_ptr;
  const float* x;
  float* partial;
  float* out;
  int64_t nchunks, nblocks, g, n;
  cudaStream_t stream;
};

template <int kVM, bool kSlot, int kNw, bool kCellW>
int launch(const Args& a) {
  if (a.nchunks > 0) {
    sell_chunk_kernel<kVM, kSlot, kNw, kCellW>
        <<<unsigned(a.nchunks), kTile, 0, a.stream>>>(
            a.meta, a.vals, a.palette, a.tinfo, a.chunk_step_ptr, a.x,
            a.partial, a.g, a.n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (a.nblocks > 0)
    sell_reduce_kernel<<<unsigned(a.nblocks), kTile, 0, a.stream>>>(
        a.partial, a.block_chunk_ptr, a.out);
  return int(cudaGetLastError());
}

template <int kVM>
int dispatch_slot(const Args& a, int64_t nw, bool cell_w) {
  switch (nw) {
    case 1: return launch<kVM, true, 1, false>(a);
    case 2: return cell_w ? launch<kVM, true, 2, true>(a)
                          : launch<kVM, true, 2, false>(a);
    case 4: return cell_w ? launch<kVM, true, 4, true>(a)
                          : launch<kVM, true, 4, false>(a);
    case 8: return cell_w ? launch<kVM, true, 8, true>(a)
                          : launch<kVM, true, 8, false>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int kVM>
int dispatch(const Args& a, bool slot, int64_t nw, bool cell_w) {
  if (!slot) return nw == 1 ? launch<kVM, false, 1, false>(a)
                            : int(cudaErrorInvalidValue);
  return dispatch_slot<kVM>(a, nw, cell_w);
}

}  // namespace
}  // namespace spmv

// meta: (ntiles, 8, 128) int16; vals: (ntiles, 8, 128) f32 / bf16 bits, or
// unused for the palette; palette: (128,) f32; tinfo: (ntiles,) int32;
// chunk_step_ptr: (nchunks + 1,) int32, step bounds of each chunk;
// block_chunk_ptr: (nblocks + 1,) int32, chunk bounds of each output block;
// x: (n,) f32; partial: (nchunks, 1024) f32 scratch; out: (nblocks, 1024)
// f32.  value_mode: 0 f32, 1 bf16, 2 palette.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int spmv_sell_launch(const void* meta, const void* vals,
                                const void* palette, const void* tinfo,
                                const void* chunk_step_ptr,
                                const void* block_chunk_ptr, const void* x,
                                void* partial, void* out, int64_t nchunks,
                                int64_t nblocks, int64_t g, int64_t n,
                                int64_t value_mode, int64_t slot_mode,
                                int64_t nw, int64_t cell_w, void* stream) {
  const spmv::Args a{static_cast<const uint16_t*>(meta),
                     vals,
                     static_cast<const float*>(palette),
                     static_cast<const int32_t*>(tinfo),
                     static_cast<const int32_t*>(chunk_step_ptr),
                     static_cast<const int32_t*>(block_chunk_ptr),
                     static_cast<const float*>(x),
                     static_cast<float*>(partial),
                     static_cast<float*>(out),
                     nchunks, nblocks, g, n,
                     static_cast<cudaStream_t>(stream)};
  const bool slot = slot_mode != 0, cw = cell_w != 0;
  switch (value_mode) {
    case spmv::kF32: return spmv::dispatch<spmv::kF32>(a, slot, nw, cw);
    case spmv::kBf16: return spmv::dispatch<spmv::kBf16>(a, slot, nw, cw);
    case spmv::kPalette: return spmv::dispatch<spmv::kPalette>(a, slot, nw, cw);
    default: return int(cudaErrorInvalidValue);
  }
}
