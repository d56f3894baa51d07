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
// Index widths, for n past 2^21 and streams past 2^31 slots: a tile's
// offset (t * kTile), a tile's first column (tinfo >> 3 is a window or
// bundle index, at most 2^28, times nw * 1024) and the partial/output
// offsets are int64; a slot's column inside its window or bundle is below
// 8 * 1024 and stays 32-bit.  tinfo and the chunk tables are int32: they
// count bundles, steps and chunks, each far below 2^31 for any stream that
// fits in device memory.
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
// Bound on the H100: the device-memory bytes of the padded stream, 2 B of
// meta a slot plus 2 B bf16, 4 B f32, 6 B df16 or 8 B df values (none for
// the palettes and the binary mode); x is gathered mostly from L2.  What
// kept the first version of this kernel (a thread a slot, 1024 threads a
// block) far from that bound was latency: each slot chained three
// dependent global loads (its meta, its cell's meta, x) with one tile in
// flight per thread.  The design here:
//   * the stream is cut into chunks that never straddle a 1024-row output
//     block, sized to the stream (ops/sell.py chunk_tables: about
//     CHUNKS_PER_SM chunks an SM, at most CHUNK_TILES tiles each, and no
//     more chunks an output block than MAX_REDUCE_BYTES of partial sums),
//     one CUDA block a chunk;
//   * a block is one producer warp and four consumer warps (kLanes
//     threads).  The producer warp reads 32 tiles' tinfo (and gpk) at a
//     time; one producer thread streams the chunk's tiles into a ring of
//     shared-memory stages with 1-D bulk copies (TMA,
//     cp.async.bulk ... mbarrier::complete_tx), each stage with its tile's
//     (tinfo, row) beside it: a tile's meta (2 KB) and value planes are
//     contiguous, so a stage is one to four copies, and an mbarrier a stage
//     says when it has landed.  The ring holds about kRingBytes a block,
//     several blocks an SM;
//   * row mode also copies the tile's x window (1024 columns, clipped to
//     n) into its stage, so its gathers are shared-memory reads; slot mode
//     gathers from device memory (a bundle is up to 8 windows);
//   * consumer thread l owns lane l of every tile: it decodes the slots
//     (i, l) of kU tiles from shared memory (the cell lookup meta[t, i, r]
//     is a shared-memory read, the palette sits in shared memory), frees
//     their stages, then issues their 8 kU x gathers back to back (slot
//     mode): x[col] is the only dependent global load left;
//   * row mode adds a tile's 8 sublanes in one thread, into that tile's
//     row (uniform over the tile) in a shared-memory accumulator whose
//     column l only thread l touches; slot mode keeps 8 registers;
//   * one launch a call: a block's rows go straight to the output when
//     its output block has one chunk; otherwise each chunk writes its 1024
//     partial sums, takes a ticket (atomicAdd on a per-output-block
//     counter, reset to 0 by the last), and the last chunk to finish adds
//     the block's partials in chunk order.  The ticket is the only atomic:
//     the sums are taken in a fixed order and the result is deterministic.
//     The tickets are shared state: launches that use one set must not
//     overlap.  ops/sell.py keeps a set for each CUDA stream a stream is
//     launched on (launches on one CUDA stream do not overlap), so only a
//     captured CUDA graph, which binds the set of the stream it was
//     captured on, must not be replayed on two streams at once.
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

namespace spmv {
namespace {

enum ValueMode : int {
  kF32 = 0, kBf16 = 1, kPalette = 2,   // f32 matrices (K1)
  kDf = 3, kDf16 = 4, kPaletteDf = 5,  // f64 matrices (K2)
  kBinary = 6,                         // COO2's R, row mode (K5 binary)
};

__host__ __device__ constexpr bool is_double(int vm) {
  return vm == kDf || vm == kDf16 || vm == kPaletteDf;
}
__host__ __device__ constexpr bool is_palette(int vm) {
  return vm == kPalette || vm == kPaletteDf;
}

// The double-float modes accumulate (and read x, write y) in double, every
// other mode in float.
template <int kVM>
using Acc = typename std::conditional<is_double(kVM), double, float>::type;

// Bytes a slot of each plane a tile stores: the values (the hi plane in the
// df modes) and the lo plane; the meta plane is 2 B a slot in every mode.
__host__ __device__ constexpr int hi_bytes(int vm) {
  return vm == kBf16 ? 2 : (vm == kF32 || vm == kDf || vm == kDf16) ? 4 : 0;
}
__host__ __device__ constexpr int lo_bytes(int vm) {
  return vm == kDf ? 4 : vm == kDf16 ? 2 : 0;
}
__host__ __device__ constexpr int tile_bytes(int vm) {
  return kTile * (2 + hi_bytes(vm) + lo_bytes(vm));
}

// Row mode stages each tile's x window (1024 columns) beside the tile, so
// its gathers are shared-memory reads; slot mode gathers from device
// memory (a bundle of nw windows is up to 8 times the tile's own bytes).
__host__ __device__ constexpr bool stage_x(bool slot) { return !slot; }

// Bytes of a ring stage: the tile, and its x window where it is staged.
template <int kVM, bool kSlot>
__host__ __device__ constexpr int stage_bytes() {
  return tile_bytes(kVM)
         + (stage_x(kSlot) ? kTile * int(sizeof(Acc<kVM>)) : 0);
}

// The ring: about kRingBytes a block, at least kMinStages stages, so that
// the blocks an SM holds keep tens of KB of the stream in flight (a ring of
// 16 to 96 KB a block ran within 1% on the H100).
constexpr int kRingBytes = 16 * 1024;
constexpr int kMinStages = 4;
template <int kVM, bool kSlot>
__host__ __device__ constexpr int stages() {
  return kRingBytes / stage_bytes<kVM, kSlot>() > kMinStages
             ? kRingBytes / stage_bytes<kVM, kSlot>() : kMinStages;
}

// Tiles a consumer decodes and gathers at once: the x gathers of kU tiles
// (8 kU a thread) are in flight together.
constexpr int kU = 2;
constexpr int kConsumerWarps = kLanes / 32;
constexpr int kThreads = kLanes + 32;  // consumers, then the producer warp

// Dynamic shared memory: the ring, the palette, the row accumulators (row
// mode), each stage's full and empty barriers and (tinfo, row), the
// last-chunk flag.
template <int kVM, bool kSlot>
constexpr int smem_bytes() {
  return stages<kVM, kSlot>() * (stage_bytes<kVM, kSlot>() + 3 * 8)
         + (is_palette(kVM) ? kLanes : 0) * int(sizeof(Acc<kVM>))
         + (kSlot ? 0 : kTile) * int(sizeof(Acc<kVM>)) + 16;
}

// s[0 ..) += the lanes of a 16-B vector; a 16-B vector of s[0 ..).
__device__ __forceinline__ void add_vec(float* s, const float4& v) {
  s[0] += v.x;
  s[1] += v.y;
  s[2] += v.z;
  s[3] += v.w;
}
__device__ __forceinline__ void add_vec(double* s, const double2& v) {
  s[0] += v.x;
  s[1] += v.y;
}
__device__ __forceinline__ float4 make_vec(const float* s) {
  return make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ double2 make_vec(const double* s) {
  return make_double2(s[0], s[1]);
}

struct Params {
  const uint16_t* meta;
  const void* vals;
  const void* vals_lo;
  const void* palette;
  const int32_t* tinfo;
  const int32_t* gpk;
  const int32_t* chunk_step_ptr;   // (nchunks + 1,) step bounds
  const int32_t* chunk_block;      // (nchunks,) output block of each chunk
  const int32_t* block_chunk_ptr;  // (nblocks + 1,) chunk bounds
  int32_t* ticket;                 // (nblocks,) zero between launches
  const void* x;
  void* partial;                   // (nchunks, 1024), multi-chunk blocks
  void* out;                       // (nblocks, 1024)
  int64_t g, n;
};

// The value of slot (i, l) of a staged tile whose meta is ms.
template <int kVM, int kLb>
__device__ __forceinline__ Acc<kVM> slot_value(const unsigned char* stage,
                                               const Acc<kVM>* pal, int k,
                                               uint32_t ms) {
  const unsigned char* hi = stage + 2 * kTile;
  const unsigned char* lo = hi + hi_bytes(kVM) * kTile;
  if constexpr (kVM == kBinary) {
    return 1.0f;
  } else if constexpr (is_palette(kVM)) {
    return pal[(ms >> (10 + kLb)) & (63u >> kLb)];
  } else if constexpr (kVM == kBf16) {
    return bf16_bits_to_f32(reinterpret_cast<const uint16_t*>(hi)[k]);
  } else if constexpr (kVM == kF32) {
    return reinterpret_cast<const float*>(hi)[k];
  } else {
    const float h = reinterpret_cast<const float*>(hi)[k];
    if constexpr (kVM == kDf16) {
      // lo = q * floor-pow2(|hi|) * 2^-39, the scale read from hi's
      // exponent bits (0 for a zero or subnormal hi) as _df16_decode does;
      // q * scale and hi + lo are exact in double (lo spans 2^-39 of hi)
      const float pulse = __uint_as_float(__float_as_uint(h) & 0x7F800000u);
      const int16_t q = reinterpret_cast<const int16_t*>(lo)[k];
      return double(h) + double(q) * double(pulse * 0x1p-39f);
    } else {
      return double(h) + double(reinterpret_cast<const float*>(lo)[k]);
    }
  }
}

// Row mode: the first column of a tile's window (v1: tinfo is the window).
template <bool kV1>
__device__ __forceinline__ int64_t window_base(int32_t ti) {
  return (kV1 ? int64_t(ti) : int64_t(ti >> 3)) * kTile;
}

// kV1: the v1 layout (row mode, g = 1): tinfo holds window_ids and gpk the
// row in the group; else tinfo = window or bundle << 3 | row_in_group.
template <int kVM, bool kSlot, int kNw, bool kCellW, bool kV1>
__global__ void __launch_bounds__(kThreads, is_double(kVM) ? 3 : 4)
    sell_chunk_kernel(const Params p) {
  using T = Acc<kVM>;
  constexpr int kLb = kNw == 8 ? 3 : kNw == 4 ? 2 : kNw == 2 ? 1 : 0;
  constexpr int nst = stages<kVM, kSlot>();
  constexpr int kTB = stage_bytes<kVM, kSlot>();
  constexpr bool kStageX = stage_x(kSlot);
  constexpr int64_t kSpan = kSlot ? int64_t(kNw) * kTile : kTile;
  constexpr uint32_t kWsel = kSlot ? uint32_t(kNw - 1) << 10 : 0u;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  T* pal = reinterpret_cast<T*>(smem + nst * kTB);
  T* racc = pal + (is_palette(kVM) ? kLanes : 0);  // racc[j * 128 + l]
  uint64_t* full = reinterpret_cast<uint64_t*>(racc + (kSlot ? 0 : kTile));
  uint64_t* empty = full + nst;
  int2* sinfo = reinterpret_cast<int2*>(empty + nst);  // (tinfo, row)
  int* last = reinterpret_cast<int*>(sinfo + nst);

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int64_t t0 = int64_t(p.chunk_step_ptr[c]) * p.g;
  const int nk = int(int64_t(p.chunk_step_ptr[c + 1]) * p.g - t0);
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kLanes) {
    if constexpr (is_palette(kVM))
      pal[tid] = static_cast<const T*>(p.palette)[tid];
    if constexpr (!kSlot) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) racc[j * kLanes + tid] = T(0);
    }
  }
  __syncthreads();

  T acc[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) acc[j] = T(0);
  if (tid >= kLanes) {
    // the producer warp: it loads 32 tiles' tinfo (and gpk) at a time, one
    // a lane; lane 0 then puts tile k in stage k % nst once the
    // consumers have freed that stage's previous tile, with the tile's
    // (tinfo, row) beside it, so no consumer waits on a global load
    const int lane = tid - kLanes;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const bool mine = k0 + lane < nk;
      const int64_t tl = t0 + k0 + lane;
      const int32_t my_ti = mine ? __ldg(p.tinfo + tl) : 0;
      const int32_t my_row = !mine || kSlot ? 0
                             : kV1 ? (__ldg(p.gpk + tl) >> 1) & 7
                                   : my_ti & 7;
      const int kend = nk - k0 < 32 ? nk - k0 : 32;
      for (int kk = 0; kk < kend; ++kk) {
        const int32_t ti = __shfl_sync(0xffffffffu, my_ti, kk);
        const int32_t row = __shfl_sync(0xffffffffu, my_row, kk);
        if (lane == 0) {
          const int k = k0 + kk;
          const int s = k % nst;
          const int64_t t = t0 + k;
          if (k >= nst) mbar_wait(&empty[s], ((k / nst) - 1) & 1);
          sinfo[s] = make_int2(ti, row);  // seen by the consumers after
          unsigned char* dst = ring + s * kTB;  // the stage's barrier
          const int nx = kStageX ? staged_x<T>(window_base<kV1>(ti), p.n)
                                 : 0;
          mbar_expect_tx(&full[s], tile_bytes(kVM) + nx * int(sizeof(T)));
          bulk_g2s(dst, p.meta + t * kTile, 2 * kTile, &full[s]);
          if (nx > 0)
            bulk_g2s(dst + tile_bytes(kVM),
                     static_cast<const T*>(p.x) + window_base<kV1>(ti),
                     nx * int(sizeof(T)), &full[s]);
          if constexpr (hi_bytes(kVM) > 0)
            bulk_g2s(dst + 2 * kTile,
                     static_cast<const unsigned char*>(p.vals)
                         + t * (hi_bytes(kVM) * kTile),
                     hi_bytes(kVM) * kTile, &full[s]);
          if constexpr (lo_bytes(kVM) > 0)
            bulk_g2s(dst + (2 + hi_bytes(kVM)) * kTile,
                     static_cast<const unsigned char*>(p.vals_lo)
                         + t * (lo_bytes(kVM) * kTile),
                     lo_bytes(kVM) * kTile, &full[s]);
        }
        __syncwarp();
      }
    }
  } else {
    // consumer thread l: kU tiles at a time, decoded from their stages,
    // then all their x gathers issued together, then summed in tile order
    const int l = tid;
    const T* x = static_cast<const T*>(p.x);
    for (int k0 = 0; k0 < nk; k0 += kU) {
      uint32_t off[kU][kSub];
      T v[kU][kSub];
      T xv[kU][kSub];
      bool valid[kU][kSub];
      int64_t base[kU];
      int row[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u;
        base[u] = 0;
        row[u] = 0;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          off[u][i] = 0;
          valid[u][i] = false;
          v[u][i] = T(0);
          xv[u][i] = T(0);
        }
        if (k >= nk) continue;  // uniform over the block
        const int s = k % nst;
        mbar_wait(&full[s], (k / nst) & 1);
        const int2 info = sinfo[s];
        row[u] = info.y;
        base[u] = kSlot ? int64_t(info.x >> 3) * kSpan
                        : window_base<kV1>(info.x);
        const unsigned char* stage = ring + s * kTB;
        const uint16_t* mt = reinterpret_cast<const uint16_t*>(stage);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const uint32_t ms = mt[i * kLanes + l];
          const uint32_t mc = mt[i * kLanes + (ms & 127u)];  // the cell
          // col - base = 1024 wsel + 128 s + r: r (bits 0-6), s (7-9) and
          // wsel (from bit 10) keep their places in the meta words, so they
          // are masked out together, not shifted out and back
          off[u][i] = (mc & (0x380u | (kCellW ? kWsel : 0u)))
                      | (ms & (0x7Fu | (kCellW ? 0u : kWsel)));
          valid[u][i] = kVM != kBinary || (ms & 0x8000u);  // bit 15
          v[u][i] = slot_value<kVM, kLb>(stage, pal, i * kLanes + l, ms);
        }
        if constexpr (kStageX) {
          // x from the staged window; past its staged part (a ragged last
          // window) from device memory, 0 past n
          const T* xs = reinterpret_cast<const T*>(stage + tile_bytes(kVM));
          const int nx = staged_x<T>(base[u], p.n);
#pragma unroll
          for (int i = 0; i < kSub; ++i)
            xv[u][i] = !valid[u][i] ? T(0)
                       : int(off[u][i]) < nx ? xs[off[u][i]]
                       : base[u] + off[u][i] < p.n
                           ? __ldg(x + base[u] + off[u][i]) : T(0);
        }
        fence_stage_reads();
        __syncwarp();
        if ((l & 31) == 0) mbar_arrive(&empty[s]);  // the stage is free
      }
#pragma unroll
      for (int u = 0; u < kU && !kStageX; ++u) {
        const bool inside = base[u] + kSpan <= p.n;  // uniform
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          xv[u][i] = valid[u][i] && (inside || base[u] + off[u][i] < p.n)
                         ? __ldg(x + base[u] + off[u][i]) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (k0 + u >= nk) break;
        if constexpr (kSlot) {
#pragma unroll
          for (int i = 0; i < kSub; ++i)
            acc[i] = fma_acc(v[u][i], xv[u][i], acc[i]);
        } else {
          T a = racc[row[u] * kLanes + l];
#pragma unroll
          for (int i = 0; i < kSub; ++i) {
            if constexpr (kVM == kBinary) {
              if (valid[u][i]) a += xv[u][i];
            } else {
              a = fma_acc(v[u][i], xv[u][i], a);
            }
          }
          racc[row[u] * kLanes + l] = a;
        }
      }
    }
    if constexpr (!kSlot) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[j] = racc[j * kLanes + l];
    }
  }

  // acc[j] of thread l < 128 is row j * 128 + l of this chunk's sums
  const int b = p.chunk_block[c];
  const int c0 = p.block_chunk_ptr[b], c1 = p.block_chunk_ptr[b + 1];
  T* out = static_cast<T*>(p.out) + int64_t(b) * kTile;
  if (c1 - c0 == 1) {
    if (tid < kLanes) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) out[j * kLanes + tid] = acc[j];
    }
    return;
  }
  T* partial = static_cast<T*>(p.partial);
  if (tid < kLanes) {
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      partial[int64_t(c) * kTile + j * kLanes + tid] = acc[j];
    // each writer fences its own stores at device scope before the ticket
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) *last = atomicAdd(p.ticket + b, 1) == c1 - c0 - 1;
  __syncthreads();
  if (!*last) return;
  // the last chunk of block b: add its chunks' partials in chunk order.
  // Thread t < 128 takes rows 8t .. 8t + 7 as 16-B vectors and keeps
  // kBatch chunks' loads in flight
  __threadfence();
  if (tid < kLanes) {
    using V = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
    constexpr int kVecs = kSub * int(sizeof(T)) / 16;  // a thread's rows
    constexpr int kBatch = 16 / kVecs;
    T sum[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) sum[j] = T(0);
    for (int cc = c0; cc < c1; cc += kBatch) {
      V q[kBatch][kVecs];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int w = 0; w < kVecs; ++w)
          if (cc + u < c1)
            q[u][w] = __ldcg(reinterpret_cast<const V*>(
                partial + int64_t(cc + u) * kTile + kSub * tid) + w);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (cc + u >= c1) break;
#pragma unroll
        for (int w = 0; w < kVecs; ++w) add_vec(sum + w * (kSub / kVecs),
                                                q[u][w]);
      }
    }
#pragma unroll
    for (int w = 0; w < kVecs; ++w)
      reinterpret_cast<V*>(out + kSub * tid)[w] =
          make_vec(sum + w * (kSub / kVecs));
  }
  if (tid == 0) p.ticket[b] = 0;
}

struct Args {
  Params p;
  int64_t nchunks;
  cudaStream_t stream;
};

template <int kVM, bool kSlot, int kNw, bool kCellW, bool kV1 = false>
int launch(const Args& a) {
  if (a.nchunks == 0) return int(cudaSuccess);
  constexpr int smem = smem_bytes<kVM, kSlot>();
  auto* kernel = sell_chunk_kernel<kVM, kSlot, kNw, kCellW, kV1>;
  if constexpr (smem > 48 * 1024) {
    // past the 48 KB default, once per device and instantiation; a refusal
    // is returned like a launch error
    static std::atomic<uint64_t> allowed{0};  // one bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    const uint64_t bit = uint64_t(1) << (dev & 63);
    if (!(allowed.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return int(err);
      allowed.fetch_or(bit);
    }
  }
  kernel<<<unsigned(a.nchunks), kThreads, smem, a.stream>>>(a.p);
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
// (ntiles, 8, 128) f32 (df) or int16 (df16), else unused; meta, vals and
// vals_lo 16-B aligned (bulk copies); palette: (128,) f32 (palette) or f64
// (palette_df), read only by those modes; tinfo: (ntiles,) int32; gpk:
// null, or the v1 layout's (ntiles,) int32 gpk, and then tinfo is its
// window_ids (row mode, f32, df or binary, g = 1); chunk_step_ptr:
// (nchunks + 1,) int32, step bounds of each chunk; chunk_block: (nchunks,)
// int32, each chunk's output block; block_chunk_ptr: (nblocks + 1,) int32,
// chunk bounds of each output block, at least one chunk each; ticket:
// (nblocks,) int32, zero before the launch and left zero after it; x:
// (n,), partial: (nchunks, 1024) scratch (unused, may be null, when every
// block has one chunk), out: (nblocks, 1024), all f64 in the df modes and
// f32 in the others.  value_mode: 0 f32, 1 bf16, 2 palette, 3 df, 4 df16,
// 5 palette_df, 6 binary (row mode only; vals unused, validity in meta bit
// 15); x 16-B aligned in row mode (its windows are bulk-copied).
// Launches one kernel on `stream`, allocates nothing, returns
// cudaGetLastError() or the error of the shared-memory attribute.
extern "C" int spmv_sell_launch(const void* meta, const void* vals,
                                const void* vals_lo, const void* palette,
                                const void* tinfo, const void* gpk,
                                const void* chunk_step_ptr,
                                const void* chunk_block,
                                const void* block_chunk_ptr, void* ticket,
                                const void* x, void* partial, void* out,
                                int64_t nchunks, int64_t g, int64_t n,
                                int64_t value_mode, int64_t slot_mode,
                                int64_t nw, int64_t cell_w, void* stream) {
  const spmv::Args a{
      {static_cast<const uint16_t*>(meta), vals, vals_lo, palette,
       static_cast<const int32_t*>(tinfo), static_cast<const int32_t*>(gpk),
       static_cast<const int32_t*>(chunk_step_ptr),
       static_cast<const int32_t*>(chunk_block),
       static_cast<const int32_t*>(block_chunk_ptr),
       static_cast<int32_t*>(ticket), x, partial, out, g, n},
      nchunks, static_cast<cudaStream_t>(stream)};
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
