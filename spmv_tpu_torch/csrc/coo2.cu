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
// that row, so s comes from the cell (i, r), as in the SELL kernels.
//
// Bound on the H100: device-memory bytes.  Each slot reads 2 B of meta and
// 4 B (f32) or 2 B (lossless bf16) of value and writes 4 B of product; a
// tile's x window (4 KB) comes mostly from L2.  There is no reduction and no
// product for tensor cores.  A first version (a thread a slot, a block a
// tile) chained three dependent loads a slot (its meta, its cell's meta,
// x) with one tile in flight a thread, far from that bound.  The design
// here is the SELL row mode's (csrc/sell.cu) without its sums:
//   * the tiles are cut into chunks of contiguous tiles (ops/coo2.py
//     chunk_bounds: the SELL chunk rule, about CHUNKS_PER_SM chunks an SM,
//     at most CHUNK_TILES tiles each), one CUDA block a chunk;
//   * a block is four consumer warps and one producer warp.  The producer
//     warp reads 32 tiles' window ids at a time; one producer thread puts
//     each tile into a ring of shared-memory stages with 1-D bulk copies
//     (TMA, mbarrier::complete_tx): its meta (2 KB), its values (2 or 4 KB)
//     and its x window (the 1024 columns below n, rounded down to whole
//     16-B words), after the consumers have freed the stage (a full and an
//     empty mbarrier a stage);
//   * consumer thread j takes slots 4j .. 4j + 3 of sublanes 0-3 and then
//     of sublanes 4-7: it reads their meta and values as one vector each,
//     the cells' meta and x from the stage (x past the staged words, in a
//     ragged last window, from device memory; 0 past n), frees the stage
//     and writes each four products with one 16-B store.  A warp writes
//     512 contiguous bytes a store, straight from registers: no shared
//     memory for the products and no bulk store to wait on before a stage
//     is reused;
//   * one launch a call, no atomics; every product is one f32 multiply
//     rounded to nearest (no fast math, no flush to zero), so the kernel
//     equals the plain version bit for bit.  Padding slots (value 0)
//     multiply as the TPU kernel does: an inf at a column below n gives
//     NaN there, and a padding tile (window 0) writes its products too.
#include "common.cuh"
#include "tma.cuh"

namespace spmv {
namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // consumers, then the producer warp
// Slots a consumer takes at once (one 16-B store), and its passes a tile.
constexpr int kVec = 4;
constexpr int kPasses = kTile / (kConsumers * kVec);
static_assert(kPasses * kConsumers * kVec == kTile, "a tile is whole passes");

// Bytes of a tile's values, and of a ring stage: meta, values, x window.
__host__ __device__ constexpr int val_bytes(bool bf16) {
  return kTile * (bf16 ? 2 : 4);
}
__host__ __device__ constexpr int stage_bytes(bool bf16) {
  return 2 * kTile + val_bytes(bf16) + kTile * int(sizeof(float));
}
// The ring: about kRingBytes a block (5 stages of bf16 tiles, 4 of f32), so
// that the two or three blocks an SM holds keep tens of KB of the stream in
// flight, and the block stays under the 48 KB of default shared memory.
constexpr int kRingBytes = 40 * 1024;
__host__ __device__ constexpr int stages(bool bf16) {
  return kRingBytes / stage_bytes(bf16);
}
// Dynamic shared memory: the ring, then each stage's full and empty
// barriers and its window's first column.
__host__ __device__ constexpr int smem_bytes(bool bf16) {
  return stages(bf16) * (stage_bytes(bf16) + 3 * 8);
}
static_assert(smem_bytes(true) <= 48 * 1024 && smem_bytes(false) <= 48 * 1024,
              "the ring fits the default shared memory");
static_assert(stages(false) >= 2, "the producer runs ahead of the consumers");

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 4)
    coo2_pass1_kernel(const int32_t* __restrict__ window_ids,
                      const uint16_t* __restrict__ meta,
                      const void* __restrict__ vals,
                      const float* __restrict__ x,
                      const int32_t* __restrict__ chunk_ptr,
                      float* __restrict__ out, int64_t n) {
  constexpr int nst = stages(kBf16);
  constexpr int kSB = stage_bytes(kBf16);
  constexpr int kVB = val_bytes(kBf16);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nst * kSB);
  uint64_t* empty = full + nst;
  int64_t* sbase = reinterpret_cast<int64_t*>(empty + nst);

  const int tid = threadIdx.x;
  const int64_t t0 = chunk_ptr[blockIdx.x];
  const int nk = int(chunk_ptr[blockIdx.x + 1] - t0);
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: 32 tiles' window ids at a time, one a lane; lane
    // 0 puts tile k in stage k % nst once the consumers have freed that
    // stage's previous tile, with the window's first column beside it
    const int lane = tid - kConsumers;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int32_t my_w =
          k0 + lane < nk ? __ldg(window_ids + t0 + k0 + lane) : 0;
      const int kend = nk - k0 < 32 ? nk - k0 : 32;
      for (int kk = 0; kk < kend; ++kk) {
        const int64_t base =
            int64_t(__shfl_sync(0xffffffffu, my_w, kk)) * kTile;
        if (lane == 0) {
          const int k = k0 + kk;
          const int s = k % nst;
          const int64_t t = t0 + k;
          if (k >= nst) mbar_wait(&empty[s], ((k / nst) - 1) & 1);
          sbase[s] = base;  // seen by the consumers after the stage's barrier
          unsigned char* dst = ring + s * kSB;
          const int nx = staged_x<float>(base, n);
          mbar_expect_tx(&full[s], 2 * kTile + kVB + nx * int(sizeof(float)));
          bulk_g2s(dst, meta + t * kTile, 2 * kTile, &full[s]);
          bulk_g2s(dst + 2 * kTile,
                   static_cast<const unsigned char*>(vals) + t * kVB, kVB,
                   &full[s]);
          if (nx > 0)
            bulk_g2s(dst + 2 * kTile + kVB, x + base,
                     nx * int(sizeof(float)), &full[s]);
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumer thread j: pass h takes slots q .. q + 3, q = 4 (128 h + j),
  // all in sublane q >> 7 (warp w's are sublane 4 h + w)
  const int j = tid;
  for (int k = 0; k < nk; ++k) {
    const int s = k % nst;
    mbar_wait(&full[s], (k / nst) & 1);
    const int64_t base = sbase[s];
    const unsigned char* stage = ring + s * kSB;
    const uint16_t* mt = reinterpret_cast<const uint16_t*>(stage);
    const unsigned char* vs = stage + 2 * kTile;
    const float* xs = reinterpret_cast<const float*>(vs + kVB);
    const int nx = staged_x<float>(base, n);
    float4 prod[kPasses];
#pragma unroll
    for (int h = 0; h < kPasses; ++h) {
      const int q = (h * kConsumers + j) * kVec;
      const uint16_t* cell = mt + (q & ~(kLanes - 1));  // the sublane's meta
      const uint2 m4 = *reinterpret_cast<const uint2*>(mt + q);
      const uint32_t ms[kVec] = {m4.x & 0xFFFFu, m4.x >> 16, m4.y & 0xFFFFu,
                                 m4.y >> 16};
      float v[kVec];
      if constexpr (kBf16) {
        const uint2 b = *reinterpret_cast<const uint2*>(vs + 2 * q);
        v[0] = bf16_bits_to_f32(uint16_t(b.x));
        v[1] = bf16_bits_to_f32(uint16_t(b.x >> 16));
        v[2] = bf16_bits_to_f32(uint16_t(b.y));
        v[3] = bf16_bits_to_f32(uint16_t(b.y >> 16));
      } else {
        const float4 f = *reinterpret_cast<const float4*>(vs + 4 * q);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      }
      float p[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const uint32_t r = ms[u] & 127u;
        const uint32_t off = (cell[r] & 0x380u) | r;  // 128 s + r
        const float xv = int(off) < nx ? xs[off]
                         : base + off < n ? __ldg(x + base + off) : 0.0f;
        p[u] = v[u] * xv;
      }
      prod[h] = make_float4(p[0], p[1], p[2], p[3]);
    }
    fence_stage_reads();
    __syncwarp();
    if ((j & 31) == 0) mbar_arrive(&empty[s]);  // the stage is free
    float* o = out + (t0 + k) * kTile;
#pragma unroll
    for (int h = 0; h < kPasses; ++h)
      *reinterpret_cast<float4*>(o + (h * kConsumers + j) * kVec) = prod[h];
  }
}

template <bool kBf16>
int launch(const int32_t* w, const uint16_t* m, const void* vals,
           const float* x, const int32_t* chunk_ptr, float* out,
           int64_t nchunks, int64_t n, cudaStream_t st) {
  coo2_pass1_kernel<kBf16><<<unsigned(nchunks), kThreads, smem_bytes(kBf16),
                             st>>>(w, m, vals, x, chunk_ptr, out, n);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace spmv

// window_ids: (ntiles,) int32; meta: (ntiles, 8, 128) int16; vals: (ntiles,
// 8, 128) f32, or bf16 bits when bf16 != 0; x: (n,) f32; meta, vals and x
// 16-B aligned (bulk copies); chunk_ptr: (nchunks + 1,) int32 tile bounds,
// no chunk empty, the last bound ntiles; out: (ntiles, 8, 128) f32, 16-B
// aligned.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int spmv_coo2_launch(const void* window_ids, const void* meta,
                                const void* vals, const void* x,
                                const void* chunk_ptr, void* out,
                                int64_t nchunks, int64_t n, int64_t bf16,
                                void* stream) {
  if (nchunks <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(window_ids);
  auto m = static_cast<const uint16_t*>(meta);
  auto xf = static_cast<const float*>(x);
  auto cp = static_cast<const int32_t*>(chunk_ptr);
  auto o = static_cast<float*>(out);
  return bf16 ? spmv::launch<true>(w, m, vals, xf, cp, o, nchunks, n, st)
              : spmv::launch<false>(w, m, vals, xf, cp, o, nchunks, n, st);
}
