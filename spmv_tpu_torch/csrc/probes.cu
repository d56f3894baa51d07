// The measurement probes of the planner's calibration, the counterparts of
// the nine Pallas probes in baselines/ (P1-P9), as five micro-kernels:
//
//   tile_stream   P1 probe2_stream.py:make_stream_fn, P3 probe3_v2proto.py:
//                 pallas_huge, P7 probe_step_overhead.py:_acc_kernel
//   tile_body     P2 probe2_stream.py:make_g8_fn, P4 probe3_v2proto.py:
//                 v2_proto, P5 probe4_body.py:build
//   window_gather P9 probe_wide_gather_r5.py:kern_loop, kern_wide
//   tiny          P6 probe5_floor.py:tiny_pallas
//   fma_err       P8 probe_r4_compute.py:probe_fma
//
// They are simple, correct kernels; what they measure on the card feeds the
// price table (spmv_tpu_torch/formats/prices.py, bench/probes.py).
//
// Translation.  A TPU probe's grid runs its steps in order on one core and
// carries a sum in the output block from step to step.  Here CUDA blocks
// run in parallel: each block walks a contiguous run of steps in a loop,
// as the TPU grid would, and the carried sum becomes a per-block partial
// added up once at the end (tile_stream: by the last block to finish, in
// block order, so the result is deterministic; tile_body: by atomic adds
// into the output block, one a block and output block).  A step of B tiles
// is B independent 16-B loads a thread before the sum, the analogue of the
// TPU's block of B tiles brought into VMEM a grid step.
//
// Bounds on the H100: tile_stream and tile_body read their stream once (4 B
// a slot of values, 2 B of meta), so device-memory bytes bind them;
// window_gather reads the same 128 KB again and again from L1/L2, and
// tiny and fma_err one 4 KB tile: launch latency binds those.
//
// fma_err computes a*b - p with __fmaf_rn: sm_90 has an IEEE fused
// multiply-add, so the product's error is exact in one instruction where
// the TPU probe asked whether its compiler fused it.
#include "common.cuh"

namespace spmv {
namespace {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

constexpr int kStreamThreads = kTile / 4;  // one float4 of a tile each

// P1/P3/P7: sum B tiles a step.  accumulate: out (1024) = c + every step's
// sum; else out[s] (1024 a step) = c + step s's sum.  Block b takes steps
// [b * spb, (b + 1) * spb).
__global__ void tile_stream_kernel(const float4* __restrict__ vals,
                                   const float4* __restrict__ c,
                                   float4* __restrict__ out,
                                   float4* __restrict__ partial,
                                   int* __restrict__ ticket, int64_t nsteps,
                                   int B, int64_t spb, int accumulate) {
  const int t = threadIdx.x;
  const int64_t s0 = int64_t(blockIdx.x) * spb;
  const int64_t s1 = s0 + spb < nsteps ? s0 + spb : nsteps;
  const float4 ct = __ldg(c + t);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t s = s0; s < s1; ++s) {
    const float4* p = vals + s * B * kStreamThreads + t;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < B; ++k) sum = add4(sum, __ldg(p + int64_t(k) * kStreamThreads));
    if (accumulate)
      acc = add4(acc, sum);
    else
      out[s * kStreamThreads + t] = add4(sum, ct);
  }
  if (!accumulate) return;
  partial[int64_t(blockIdx.x) * kStreamThreads + t] = acc;
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (t == 0) last = atomicAdd(ticket, 1) == int(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float4 r = ct;
  for (unsigned b = 0; b < gridDim.x; ++b)
    r = add4(r, __ldcg(partial + int64_t(b) * kStreamThreads + t));
  out[t] = r;
  if (t == 0) *ticket = 0;  // ready for the next launch
}

enum BodyValue : int { kValF32 = 0, kValBf16 = 1, kValPalette = 2,
                       kValDyadic = 3 };
enum BodyGather : int { kGatherFull = 0, kGatherNoDim1 = 1, kGatherNone = 2 };

// P2/P4/P5: the SELL row-mode body.  A thread a lane j; per tile t of a step
// of G: window w = tinfo[t] >> 3 (0 with fixed_window), row = tinfo[t] & 7;
// per sublane i the slot's meta m gives r = m & 127 and the sub-row s read
// at the cell (i, r): xg = x[1024 w + 128 s + r] (kGatherNoDim1: s at the
// slot, column j; kGatherNone: x[1024 w + 128 i + j]); contrib = sum over i
// of value * xg, added into row `row` (mask) or into all 8 rows.  Steps of
// one output block (ginfo >> 1) are consecutive; the first (ginfo & 1) adds
// init.  A block's runs flush into out by atomic adds.
__global__ void tile_body_kernel(const uint16_t* __restrict__ meta,
                                 const void* __restrict__ vals,
                                 const float* __restrict__ pal,
                                 const int32_t* __restrict__ tinfo,
                                 const int32_t* __restrict__ ginfo,
                                 const float* __restrict__ x,
                                 const float* __restrict__ init,
                                 float* __restrict__ out, int64_t nsteps,
                                 int G, int64_t spb, int value_kind,
                                 int gather, int mask, int fixed_window) {
  const int j = threadIdx.x;
  const int64_t s0 = int64_t(blockIdx.x) * spb;
  const int64_t s1 = s0 + spb < nsteps ? s0 + spb : nsteps;
  float acc[kSub];
#pragma unroll
  for (int r = 0; r < kSub; ++r) acc[r] = 0.f;
  int64_t cur = -1;
  for (int64_t s = s0; s < s1; ++s) {
    const int32_t gi = __ldg(ginfo + s);
    const int64_t grp = gi >> 1;
    if (grp != cur) {
      if (cur >= 0) {
#pragma unroll
        for (int r = 0; r < kSub; ++r) {
          atomicAdd(out + cur * kTile + r * kLanes + j, acc[r]);
          acc[r] = 0.f;
        }
      }
      cur = grp;
    }
    if (gi & 1) {
#pragma unroll
      for (int r = 0; r < kSub; ++r) acc[r] += __ldg(init + r * kLanes + j);
    }
    for (int k = 0; k < G; ++k) {
      const int64_t t = s * G + k;
      const int32_t ti = __ldg(tinfo + t);
      const int64_t w = fixed_window ? 0 : (ti >> 3);
      const float* xw = x + w * kTile;
      const uint16_t* mt = meta + t * kTile;
      float contrib = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const uint32_t m = __ldg(mt + i * kLanes + j);
        const uint32_t r = m & 127u;
        float xg;
        if (gather == kGatherFull) {
          const uint32_t sc = (__ldg(mt + i * kLanes + r) >> 7) & 7u;
          xg = __ldg(xw + sc * kLanes + r);
        } else if (gather == kGatherNoDim1) {
          xg = __ldg(xw + ((m >> 7) & 7u) * kLanes + j);
        } else {
          xg = __ldg(xw + i * kLanes + j);
        }
        float v;
        const int64_t slot = t * kTile + i * kLanes + j;
        if (value_kind == kValF32)
          v = __ldg(static_cast<const float*>(vals) + slot);
        else if (value_kind == kValBf16)
          v = bf16_bits_to_f32(__ldg(static_cast<const uint16_t*>(vals) + slot));
        else if (value_kind == kValPalette)
          v = __ldg(pal + ((m >> 10) & 63u));
        else
          v = float((m >> 10) & 7u) * 0.125f;
        contrib = fmaf(v, xg, contrib);
      }
      const int row = ti & 7;
#pragma unroll
      for (int r = 0; r < kSub; ++r)
        acc[r] += (!mask || r == row) ? contrib : 0.f;
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int r = 0; r < kSub; ++r)
      atomicAdd(out + cur * kTile + r * kLanes + j, acc[r]);
  }
}

constexpr int kNw = 8;  // P9's bundle of 8 windows

// P9: g tiles a step, one block a step (every step reads the same g tiles,
// as the TPU probe's clamped block index does), each writing the same sum
// over the g tiles.  Loop form: per slot, for each of the 8 windows j, the
// take0 + take1 gather x2[(8 j + s(i, r)) * 128 + r] and a select on
// wsel == j.  Wide form: one gather xb[srow][c(srow, l)] from the
// (8, 1024) bundle.  A thread a lane l.
__global__ void window_gather_kernel(const int32_t* __restrict__ a0,
                                     const int32_t* __restrict__ a1,
                                     const int32_t* __restrict__ a2,
                                     const float* __restrict__ x,
                                     float* __restrict__ out, int g,
                                     int wide) {
  const int l = threadIdx.x;
  float acc[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) acc[i] = 0.f;
  for (int k = 0; k < g; ++k) {
    const int64_t base = int64_t(k) * kTile;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int64_t slot = base + i * kLanes + l;
      if (wide) {
        // a0 = ctab (column in the bundle), a1 = srow
        const int sr = __ldg(a1 + slot);
        const int col = __ldg(a0 + base + sr * kLanes + l);
        acc[i] += __ldg(x + sr * (kNw * kLanes) + col);
      } else {
        // a0 = sidx, a1 = ridx, a2 = wsel
        const int r = __ldg(a1 + slot);
        const int s = __ldg(a0 + base + i * kLanes + r);
        const int wsel = __ldg(a2 + slot);
        float xg = 0.f;
#pragma unroll
        for (int jw = 0; jw < kNw; ++jw) {
          const float gj = __ldg(x + (jw * kSub + s) * kLanes + r);
          xg = wsel == jw ? gj : xg;
        }
        acc[i] += xg;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) out[i * kLanes + l] = acc[i];
}

// P6: one (8, 128) f32 tile times 2.
__global__ void tiny_kernel(const float4* __restrict__ v,
                            float4* __restrict__ out) {
  const float4 a = __ldg(v + threadIdx.x);
  out[threadIdx.x] = make_float4(2.f * a.x, 2.f * a.y, 2.f * a.z, 2.f * a.w);
}

// P8: e = a * b - p, fused: exactly the rounding error of p = fl(a * b).
__global__ void fma_err_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ p,
                               float* __restrict__ e, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) e[i] = __fmaf_rn(__ldg(a + i), __ldg(b + i), -__ldg(p + i));
}

}  // namespace
}  // namespace spmv

// Every entry launches on `stream`, allocates nothing and returns
// cudaGetLastError().

// vals: (nsteps * B, 1024) f32; c: (1024,); out: (1024,) when accumulate,
// else (nsteps, 1024); partial: (nblocks, 1024) scratch; ticket: one int32
// 0, left 0.  Blocks: ceil(nsteps / spb).
extern "C" int spmv_probe_tile_stream(const void* vals, const void* c,
                                      void* out, void* partial, void* ticket,
                                      int64_t nsteps, int64_t B, int64_t spb,
                                      int64_t accumulate, void* stream) {
  if (nsteps <= 0) return 0;
  const int64_t blocks = (nsteps + spb - 1) / spb;
  spmv::tile_stream_kernel<<<unsigned(blocks), spmv::kStreamThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vals), static_cast<const float4*>(c),
      static_cast<float4*>(out), static_cast<float4*>(partial),
      static_cast<int*>(ticket), nsteps, int(B), spb, int(accumulate));
  return int(cudaGetLastError());
}

// meta: (nsteps * G, 1024) int16; vals: f32 or bf16 bits a slot (value
// kinds 0, 1) or null; pal: (128,) f32; tinfo: (nsteps * G,) int32; ginfo:
// (nsteps,) int32; x: f32 covering every window read; init: (1024,) f32;
// out: (ngroups, 1024) f32, zeros.
extern "C" int spmv_probe_tile_body(const void* meta, const void* vals,
                                    const void* pal, const void* tinfo,
                                    const void* ginfo, const void* x,
                                    const void* init, void* out,
                                    int64_t nsteps, int64_t G, int64_t spb,
                                    int64_t value_kind, int64_t gather,
                                    int64_t mask, int64_t fixed_window,
                                    void* stream) {
  if (nsteps <= 0) return 0;
  const int64_t blocks = (nsteps + spb - 1) / spb;
  spmv::tile_body_kernel<<<unsigned(blocks), spmv::kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(meta), vals,
      static_cast<const float*>(pal), static_cast<const int32_t*>(tinfo),
      static_cast<const int32_t*>(ginfo), static_cast<const float*>(x),
      static_cast<const float*>(init), static_cast<float*>(out), nsteps,
      int(G), spb, int(value_kind), int(gather), int(mask),
      int(fixed_window));
  return int(cudaGetLastError());
}

// Loop form (wide = 0): a0 sidx, a1 ridx, a2 wsel, (g, 1024) int32 each, x
// (8 windows * 1024,) window-major.  Wide form: a0 ctab, a1 srow, a2 unused,
// x the (8, 1024) bundle.  out: (1024,).  nsteps blocks.
extern "C" int spmv_probe_window_gather(const void* a0, const void* a1,
                                        const void* a2, const void* x,
                                        void* out, int64_t g, int64_t nsteps,
                                        int64_t wide, void* stream) {
  if (nsteps <= 0) return 0;
  spmv::window_gather_kernel<<<unsigned(nsteps), spmv::kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<const int32_t*>(a2), static_cast<const float*>(x),
      static_cast<float*>(out), int(g), int(wide));
  return int(cudaGetLastError());
}

// v, out: (1024,) f32.
extern "C" int spmv_probe_tiny(const void* v, void* out, void* stream) {
  spmv::tiny_kernel<<<1, spmv::kStreamThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(v), static_cast<float4*>(out));
  return int(cudaGetLastError());
}

// a, b, p, e: (n,) f32.
extern "C" int spmv_probe_fma_err(const void* a, const void* b,
                                  const void* p, void* e, int64_t n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + 255) / 256;
  spmv::fma_err_kernel<<<unsigned(blocks), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(p), static_cast<float*>(e), n);
  return int(cudaGetLastError());
}
