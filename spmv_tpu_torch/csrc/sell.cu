// SELL tile-stream SpMV over the JAX package's grouped (8, 128) tiles, in
// its row mode (SELL-8W v2) and slot mode (SELL-8D), for f32 and f64.
//
// Replaces the TPU's SELL tile kernels, launched there by
// build_sell8w_v2_fn and build_sell8w_v2w_fn (row mode) and
// build_sell8d_fn (slot mode):
//   * spmv_tpu/ops/pallas_sell.py::_kernel_v2 (K1, via _run_v2): f32, bf16
//     and palette values, f32 x and y;
//   * spmv_tpu/ops/pallas_sell.py::_kernel_v2_df (K2, via _run_v2_df): the
//     double-float packs of f64 matrices, values as "df" (f32 hi + f32 lo),
//     "df16" (f32 hi + int16 lo scaled by hi's exponent, _df16_decode) or
//     "palette_df" (a palette of f64 values), f64 x and y.  The TPU has no
//     f64, so its kernel carries (hi, lo) f32 pairs through error-free
//     transforms; the H100 has f64, so here each slot's value is decoded
//     to one double (hi + lo, rounded once) and the sums are native f64
//     FMAs;
//   * spmv_tpu/ops/pallas_sell.py::_make_kernel_v2w (K5, via _run_v2w) in
//     its "binary" mode, row mode only: the COO2 pass-2 reduce y = R @ p.
//     Every stored value is 1 and a slot's validity is bit 15 of its meta,
//     so there is no values stream; x is the f32 pass-1 product stream.
//     K5 selects x where the bit is set (jnp.where(m < 0, xg, 0)); here a
//     padding slot loads nothing and adds nothing, and a valid one adds x
//     (fma(1, x, acc) is acc + x rounded once);
//   * the TPU's windowed kernels, which compute what K1 and K2 compute for
//     n past V2_MAX_N = 2M columns (the same decode, column formula and
//     row/slot sums): _make_kernel_v2w (K5, via _run_v2w) with values, K1's
//     row mode; _make_kernel_v2w_slot (K6, via _run_v2w_slot), K1's slot
//     mode; _make_kernel_v2w_df (K7, via _run_v2w_df), K2 in both modes.
//     They DMA one x window (row mode) or bundle of nw windows (slot mode)
//     a tile because x does not fit in VMEM.  That is a VMEM workaround and
//     is not carried over: here every mode reads x from device memory at
//     any column, so the windowed streams run this same template;
//   * the TPU's v1 kernels, one tile a grid step over the v1 SELL-8W layout
//     (build_sell8w_fn and the mesh's dist SELL-8W plans): _kernel (K9, via
//     _run), f32 values; _kernel_v1_df (K10, via _run_df_v1), hi + lo f32
//     planes decoded to one double a slot as in K2; _kernel_binary (K11,
//     via _run(binary=True)), the binary mode above.  The v1 layout keeps a
//     tile's window in window_ids[t] and its row in the group in gpk[t]:
//     gpk = group << 4 | row_in_group << 1 | first.  The kernel reads both
//     as they are (kV1): the window from tinfo = window_ids, the row from
//     (gpk[t] >> 1) & 7, one tile a step (g = 1).  The meta decode is the
//     v2 row mode's.  A dist pack's padding tiles (window 0, zero values,
//     first = 0, the last group) add 0 * x[col] like any slot, as on the
//     TPU.
//
// Index widths, for n past 2^21 and streams past 2^31 slots: a slot's
// offset (t * kTile + tid), its column (tinfo >> 3 is a window or bundle
// index, at most 2^28, times nw * 1024) and the partial/output offsets are
// int64.  tinfo, chunk_step_ptr and block_chunk_ptr are int32: they count
// bundles, steps and chunks, each far below 2^31 for any stream that fits
// in device memory.
//
// Decode, per slot (i, l) of tile t (meta read as uint16):
//   r    = meta[t, i, l] & 127                       (at the slot)
//   s    = (meta[t, i, r] >> 7) & 7                  (at the CELL (i, r))
//   wsel = (meta[., i, .] >> 10) & (nw - 1)          (at the cell with cell_w,
//                                                     else at the slot)
//   code = (meta[t, i, l] >> (10 + lb)) & (63 >> lb) (palette, at the slot)
//   col  = base + 1024 * wsel + 128 * s + r,  base = (tinfo[t] >> 3) * nw*1024
// (v1: base = window_ids[t] * 1024.)  Row mode sums a tile's 8 sublanes
// into row (tinfo[t] & 7) * 128 + l (v1: ((gpk[t] >> 1) & 7) * 128 + l) of
// its 1024-row output block; slot mode adds slot (i, l) into row
// 128 * i + l.  Padding slots hold value 0; columns >= n read 0.
//
// Bound on the H100: device-memory bytes per padded slot (2 B meta, plus
// 2 B bf16, 4 B f32, 6 B df16 or 8 B df values; palette values live in the
// meta bits) and the dependent loads per slot (meta -> cell meta -> x).
// The TPU grid ran the tile stream in order on one core, carrying each
// output block in VMEM; here the stream is cut into chunks of at most
// kChunkTiles tiles that never straddle an output block, one CUDA block of
// 1024 threads per chunk (a thread per slot), so even a plan with few
// output blocks fills the card.  Each chunk writes its 1024 partial row
// sums; a second kernel adds a block's chunks in order.  No atomics: the
// result is deterministic.
#include <type_traits>

#include "common.cuh"

namespace spmv {
namespace {

enum ValueMode : int {
  kF32 = 0, kBf16 = 1, kPalette = 2,   // f32 matrices (K1)
  kDf = 3, kDf16 = 4, kPaletteDf = 5,  // f64 matrices (K2)
  kBinary = 6,                         // COO2's R, row mode (K5 binary)
};

constexpr bool is_double(int vm) {
  return vm == kDf || vm == kDf16 || vm == kPaletteDf;
}

// The double-float modes accumulate (and read x, write y) in double, every
// other mode in float.
template <int kVM>
using Acc = typename std::conditional<is_double(kVM), double, float>::type;

// The value of slot k of the stream, whose meta is ms.
template <int kVM, int kLb>
__device__ __forceinline__ Acc<kVM> slot_value(const void* vals,
                                               const void* vals_lo,
                                               const void* palette, int64_t k,
                                               uint32_t ms) {
  const uint32_t code = (ms >> (10 + kLb)) & (63u >> kLb);
  if constexpr (kVM == kBinary) {
    return 1.0f;  // the caller has skipped the slots whose bit 15 is clear
  } else if constexpr (kVM == kPalette) {
    return __ldg(static_cast<const float*>(palette) + code);
  } else if constexpr (kVM == kPaletteDf) {
    return __ldg(static_cast<const double*>(palette) + code);
  } else if constexpr (kVM == kBf16) {
    return bf16_bits_to_f32(__ldg(static_cast<const uint16_t*>(vals) + k));
  } else if constexpr (kVM == kF32) {
    return __ldg(static_cast<const float*>(vals) + k);
  } else {
    const float hi = __ldg(static_cast<const float*>(vals) + k);
    if constexpr (kVM == kDf16) {
      // lo = q * floor-pow2(|hi|) * 2^-39, the scale read from hi's
      // exponent bits (0 for a zero or subnormal hi) as _df16_decode does;
      // q * scale and hi + lo are exact in double (lo spans 2^-39 of hi)
      const float pulse = __uint_as_float(__float_as_uint(hi) & 0x7F800000u);
      const int16_t q = __ldg(static_cast<const int16_t*>(vals_lo) + k);
      return double(hi) + double(q) * double(pulse * 0x1p-39f);
    } else {
      const float lo = __ldg(static_cast<const float*>(vals_lo) + k);
      return double(hi) + double(lo);
    }
  }
}

// kV1: the v1 layout (row mode, g = 1): tinfo holds window_ids and gpk the
// row in the group; else tinfo = window or bundle << 3 | row_in_group.
template <int kVM, bool kSlot, int kNw, bool kCellW, bool kV1>
__global__ void __launch_bounds__(kTile)
    sell_chunk_kernel(const uint16_t* __restrict__ meta,
                      const void* __restrict__ vals,
                      const void* __restrict__ vals_lo,
                      const void* __restrict__ palette,
                      const int32_t* __restrict__ tinfo,
                      const int32_t* __restrict__ gpk,
                      const int32_t* __restrict__ chunk_step_ptr,
                      const Acc<kVM>* __restrict__ x,
                      Acc<kVM>* __restrict__ partial, int64_t g, int64_t n) {
  using T = Acc<kVM>;
  constexpr int kLb = kNw == 8 ? 3 : kNw == 4 ? 2 : kNw == 2 ? 1 : 0;
  const int tid = threadIdx.x;  // slot (i, l) = (tid >> 7, tid & 127)
  const int i = tid >> 7;
  const int64_t t0 = int64_t(chunk_step_ptr[blockIdx.x]) * g;
  const int64_t t1 = int64_t(chunk_step_ptr[blockIdx.x + 1]) * g;
  T acc[kSlot ? 1 : kSub];
#pragma unroll
  for (int j = 0; j < (kSlot ? 1 : kSub); ++j) acc[j] = T(0);

  for (int64_t t = t0; t < t1; ++t) {
    const int32_t ti = __ldg(tinfo + t);
    const uint16_t* mt = meta + t * kTile;
    const uint32_t ms = __ldg(mt + tid);
    if (kVM == kBinary && !(ms & 0x8000u)) continue;  // padding: value 0
    const uint32_t r = ms & 127u;
    const uint32_t mc = __ldg(mt + i * kLanes + r);  // the cell (i, r)
    const uint32_t s = (mc >> 7) & 7u;
    const int64_t base = kV1 ? int64_t(ti) : int64_t(ti >> 3);
    int64_t col = base * (kSlot ? kNw * kTile : kTile) + s * kLanes + r;
    if (kSlot && kNw > 1)
      col += int64_t(((kCellW ? mc : ms) >> 10) & (kNw - 1)) * kTile;
    const T v = slot_value<kVM, kLb>(vals, vals_lo, palette, t * kTile + tid,
                                     ms);
    const T xv = col < n ? __ldg(x + col) : T(0);
    if (kSlot) {
      acc[0] = fma_acc(v, xv, acc[0]);
    } else {
      const int row = kV1 ? (__ldg(gpk + t) >> 1) & 7 : ti & 7;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (j == row) acc[j] = fma_acc(v, xv, acc[j]);
    }
  }

  T* out = partial + int64_t(blockIdx.x) * kTile;
  if (kSlot) {
    out[tid] = acc[0];
    return;
  }
  // row mode: row j of the block gets the sum over sublanes i of acc_i[j],
  // through 32 KB of shared memory: 8 rows in one pass in f32, 4 rows in
  // each of two passes in f64 (64 KB would exceed the 48 KB static limit)
  constexpr int kRows = 32 * 1024 / (kTile * int(sizeof(T)));
  __shared__ T red[kRows][kTile];  // red[j][i * 128 + l]
  const int row = tid >> 7, l = tid & 127;
#pragma unroll
  for (int p = 0; p < kSub / kRows; ++p) {
    if (p > 0) __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) red[j][tid] = acc[p * kRows + j];
    __syncthreads();
    if (row / kRows == p) {
      T sum = T(0);
#pragma unroll
      for (int k = 0; k < kSub; ++k) sum += red[row % kRows][k * kLanes + l];
      out[tid] = sum;
    }
  }
}

// out[b, :] = sum of the partials of block b's chunks, in chunk order.
template <typename T>
__global__ void __launch_bounds__(kTile)
    sell_reduce_kernel(const T* __restrict__ partial,
                       const int32_t* __restrict__ block_chunk_ptr,
                       T* __restrict__ out) {
  const int64_t b = blockIdx.x;
  T sum = T(0);
  for (int32_t c = block_chunk_ptr[b]; c < block_chunk_ptr[b + 1]; ++c)
    sum += partial[int64_t(c) * kTile + threadIdx.x];
  out[b * kTile + threadIdx.x] = sum;
}

struct Args {
  const uint16_t* meta;
  const void* vals;
  const void* vals_lo;
  const void* palette;
  const int32_t* tinfo;
  const int32_t* gpk;
  const int32_t* chunk_step_ptr;
  const int32_t* block_chunk_ptr;
  const void* x;
  void* partial;
  void* out;
  int64_t nchunks, nblocks, g, n;
  cudaStream_t stream;
};

template <int kVM, bool kSlot, int kNw, bool kCellW, bool kV1 = false>
int launch(const Args& a) {
  using T = Acc<kVM>;
  if (a.nchunks > 0) {
    sell_chunk_kernel<kVM, kSlot, kNw, kCellW, kV1>
        <<<unsigned(a.nchunks), kTile, 0, a.stream>>>(
            a.meta, a.vals, a.vals_lo, a.palette, a.tinfo, a.gpk,
            a.chunk_step_ptr,
            static_cast<const T*>(a.x), static_cast<T*>(a.partial), a.g,
            a.n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (a.nblocks > 0)
    sell_reduce_kernel<T><<<unsigned(a.nblocks), kTile, 0, a.stream>>>(
        static_cast<const T*>(a.partial), a.block_chunk_ptr,
        static_cast<T*>(a.out));
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

// Row mode has one window a tile (nw == 1), windowed streams (K5, K7 row)
// included.  The binary mode exists in row mode only (COO2's R is a
// SELL-8W pack).
template <>
int dispatch<kBinary>(const Args& a, bool slot, int64_t nw, bool cell_w) {
  return !slot && nw == 1 && !cell_w ? launch<kBinary, false, 1, false>(a)
                                     : int(cudaErrorInvalidValue);
}

// The v1 layout exists in row mode only, for K9 (f32), K10 (df) and K11
// (binary).
template <int kVM>
int dispatch_v1(const Args& a, bool slot, int64_t nw, bool cell_w) {
  if constexpr (kVM == kF32 || kVM == kDf || kVM == kBinary) {
    if (!slot && nw == 1 && !cell_w) return launch<kVM, false, 1, false, true>(a);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace spmv

// meta: (ntiles, 8, 128) int16; vals: (ntiles, 8, 128) f32 / bf16 bits
// (the hi plane in df modes), or unused for the palettes; vals_lo:
// (ntiles, 8, 128) f32 (df) or int16 (df16), else unused; palette: (128,)
// f32 (palette) or f64 (palette_df), read only by those modes; tinfo:
// (ntiles,) int32; gpk: null, or the v1 layout's (ntiles,) int32 gpk, and
// then tinfo is its window_ids (row mode, f32, df or binary, g = 1);
// chunk_step_ptr: (nchunks + 1,) int32, step bounds of each chunk;
// block_chunk_ptr: (nblocks + 1,) int32, chunk bounds of each output block;
// x: (n,), partial: (nchunks, 1024) scratch, out: (nblocks, 1024), all f64
// in the df modes and f32 in the others.  value_mode: 0 f32, 1 bf16,
// 2 palette, 3 df, 4 df16, 5 palette_df, 6 binary (row mode only; vals
// unused, validity in meta bit 15).  Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int spmv_sell_launch(const void* meta, const void* vals,
                                const void* vals_lo, const void* palette,
                                const void* tinfo, const void* gpk,
                                const void* chunk_step_ptr,
                                const void* block_chunk_ptr, const void* x,
                                void* partial, void* out, int64_t nchunks,
                                int64_t nblocks, int64_t g, int64_t n,
                                int64_t value_mode, int64_t slot_mode,
                                int64_t nw, int64_t cell_w, void* stream) {
  const spmv::Args a{static_cast<const uint16_t*>(meta),
                     vals,
                     vals_lo,
                     palette,
                     static_cast<const int32_t*>(tinfo),
                     static_cast<const int32_t*>(gpk),
                     static_cast<const int32_t*>(chunk_step_ptr),
                     static_cast<const int32_t*>(block_chunk_ptr),
                     x,
                     partial,
                     out,
                     nchunks, nblocks, g, n,
                     static_cast<cudaStream_t>(stream)};
  const bool slot = slot_mode != 0, cw = cell_w != 0;
  if (gpk != nullptr) {
    switch (value_mode) {
      case spmv::kF32: return spmv::dispatch_v1<spmv::kF32>(a, slot, nw, cw);
      case spmv::kDf: return spmv::dispatch_v1<spmv::kDf>(a, slot, nw, cw);
      case spmv::kBinary:
        return spmv::dispatch_v1<spmv::kBinary>(a, slot, nw, cw);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (value_mode) {
    case spmv::kF32: return spmv::dispatch<spmv::kF32>(a, slot, nw, cw);
    case spmv::kBf16: return spmv::dispatch<spmv::kBf16>(a, slot, nw, cw);
    case spmv::kPalette: return spmv::dispatch<spmv::kPalette>(a, slot, nw, cw);
    case spmv::kDf: return spmv::dispatch<spmv::kDf>(a, slot, nw, cw);
    case spmv::kDf16: return spmv::dispatch<spmv::kDf16>(a, slot, nw, cw);
    case spmv::kPaletteDf:
      return spmv::dispatch<spmv::kPaletteDf>(a, slot, nw, cw);
    case spmv::kBinary: return spmv::dispatch<spmv::kBinary>(a, slot, nw, cw);
    default: return int(cudaErrorInvalidValue);
  }
}
