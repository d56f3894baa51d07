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
// What they measure on the card feeds the price table
// (spmv_tpu_torch/formats/prices.py, bench/probes.py).
//
// Translation.  A TPU probe's grid runs its steps in order on one core and
// carries a sum in the output block from step to step; a step of B (or G)
// tiles is what the TPU brings into VMEM at once.  On Hopper a step means
// nothing: blocks run in parallel on 132 SMs, and what binds tile_stream
// and tile_body is the device-memory stream.  So both cut their TILES, not
// their steps, into chunks that fill the card, one CUDA block a chunk
// (host tables: bench/probes.py stream_split and body_split), and the
// carried sum becomes a reduce in a fixed order:
//   * a chunk sums its tiles in tile order; an output (the carried sum, a
//     step's sum, a body's output block) that lies in one chunk is written
//     by that chunk;
//   * an output cut over several chunks gets one partial (1024 f32) a
//     piece, a "slot".  Its slots are summed in slot order by the last
//     chunk to finish each node of kFan consecutive slots, and the node
//     sums in node order by the last node to finish (a ticket each,
//     atomicAdd on a counter that the last one sets back to 0).  The order
//     depends on the tables only, so every launch gives the same bits.
//     A block takes all its slots' tickets in one round: on the H100 the
//     reduce costs about 6 us of a 48 MB stream's 24 (sell_probe.py
//     probes times the kernels with it left out).
//
// tile_stream (P1/P3/P7): 256 threads a block; thread p owns float4 p of
// every tile and keeps kStreamU independent 16-B loads in flight; two
// chunks an SM, all resident at once (four ran slower: more slots for
// the reduce).  B only decides which tiles are
// summed and, without accumulate, where each step's sum goes: a chunk of
// whole steps writes each step's sum as the step ends, and a step longer
// than a chunk is cut over chunks like the carried sum.
//
// tile_body (P2/P4/P5): the SELL row-mode body, staged as csrc/sell.cu
// stages it.  One producer warp streams each chunk's tiles (meta, values)
// into a ring of shared-memory stages with bulk copies (csrc/tma.cuh),
// beside each tile its tinfo and whether it opens a step that adds init;
// 128 consumer threads decode lane j of kBodyU tiles from shared memory
// (the cell lookup is a shared-memory read, the palette sits in shared
// memory) and issue their 8 kBodyU x gathers together, from L1/L2 (x is
// 800 KB for clustered200k).  The value mode, gather stage, row mask and
// fixed window are template parameters, so a part that a P5 variant takes
// out leaves no instruction behind.  A chunk walks its runs of one output
// block (group) from the host's run table; the groups no step visits are
// zero-filled by the blocks, so `out` needs no memset.
//
// Bounds on the H100: tile_stream and tile_body read their stream once (4 B
// a slot of f32 values, 2 B of meta), so device-memory bytes bind them;
// window_gather's bound is its adds (its inputs are 416 KB), and what
// binds it is its shared-memory loads: it stages x and its tiles' indices
// once a block and gathers from shared memory every step (see below);
// tiny and fma_err read one 4 KB tile (8 and 16 KB moved), so no body gets
// near their bounds: the launch binds them, and their design is the
// launch.  Both launch with programmatic dependent launch (PDL, sm_90;
// pdl_launch below): each issues griddepcontrol.launch_dependents as it
// starts, so the next kernel on the stream may be scheduled while it
// runs, and griddepcontrol.wait before its first read, which returns once
// the kernels before it have completed and their writes are visible.  The
// TPU probe times a launch inside one compiled loop; the port's
// counterpart is spmv_probe_tiny_chain, n dependent launches from C with
// no Python between them.
//
// fma_err computes a*b - p with __fmaf_rn: sm_90 has an IEEE fused
// multiply-add, so the product's error is exact in one instruction where
// the TPU probe asked whether its compiler fused it.
#include <atomic>
#include <utility>

#include "common.cuh"
#include "tma.cuh"

namespace spmv {
namespace {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

constexpr int kVecs = kTile / 4;  // float4s of a tile, or of a partial
constexpr int kFan = 16;          // slots a node of the reduce sums

// The reduce of outputs cut over chunks.  Slots of split output k are
// [slot_ptr[k], slot_ptr[k + 1]), its nodes [node_ptr[k], node_ptr[k +
// 1]), node j holding slots slot_ptr[k] + kFan j .. + kFan.  partial: the
// slots' vectors, then the nodes'; tickets: one a node, then one a split
// output, 0 between launches.
struct Tree {
  const int32_t* slot_out;
  const int32_t* slot_ptr;
  const int32_t* node_ptr;
  int32_t* tickets;
  float4* partial;
  int64_t nslots, nnodes;
};

// dst = (((0 + src[0]) + src[1]) + ... + src[n - 1]) (+ add), float4 by
// float4, every thread of the block taking columns tid, tid + blockDim.x..
__device__ __forceinline__ void sum_in_order(float4* dst, const float4* src,
                                             int n, const float4* add) {
  for (int col = threadIdx.x; col < kVecs; col += blockDim.x) {
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < n; k0 += 8) {
      float4 q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n) q[u] = __ldcg(src + int64_t(k0 + u) * kVecs + col);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n) r = add4(r, q[u]);
    }
    if (add != nullptr) r = add4(r, __ldg(add + col));
    dst[col] = r;
  }
}

// The reduce's first round, for a block that has written its pieces: the
// node tickets of `n` (at most kBlockSlots) slots at once, slots[i] < 0
// for none; returns with last[i] set where this block finished slot i's
// node.  Every thread of the block calls it.
constexpr int kBlockSlots = 32;
__device__ __forceinline__ void take_tickets(const Tree& tr,
                                             const int* slots, int n,
                                             int* last) {
  __threadfence();  // each writer fences its own stores of the slots
  __syncthreads();
  const int i = threadIdx.x;
  if (i < n) {
    const int slot = slots[i];
    int done = 0;
    if (slot >= 0) {
      const int k = tr.slot_out[slot];
      const int s0 = tr.slot_ptr[k], s1 = tr.slot_ptr[k + 1];
      const int a = s0 + (slot - s0) / kFan * kFan;
      const int b = a + kFan < s1 ? a + kFan : s1;
      done = atomicAdd(tr.tickets + tr.node_ptr[k] + (slot - s0) / kFan,
                       1) == b - a - 1;
    }
    last[i] = done;
  }
  __syncthreads();
}

// The rest, for the block that finished slot `slot`'s node: it sums the
// node's slots in order, into dst (+ add) where the output has one node,
// else into the node's vector, and the last node to finish sums the nodes
// in order into dst (+ add).  Every thread of the block calls it.
__device__ void finish_node(const Tree& tr, int slot, float4* dst,
                            const float4* add) {
  __shared__ int last;
  __threadfence();
  const int k = tr.slot_out[slot];
  const int s0 = tr.slot_ptr[k], s1 = tr.slot_ptr[k + 1];
  const int n0 = tr.node_ptr[k], n1 = tr.node_ptr[k + 1];
  const int j = (slot - s0) / kFan;
  const int a = s0 + j * kFan, b = a + kFan < s1 ? a + kFan : s1;
  const bool one = n1 - n0 == 1;
  sum_in_order(one ? dst : tr.partial + (tr.nslots + n0 + j) * kVecs,
               tr.partial + int64_t(a) * kVecs, b - a, one ? add : nullptr);
  if (threadIdx.x == 0) tr.tickets[n0 + j] = 0;  // ready for the next launch
  if (one) return;
  __threadfence();
  __syncthreads();
  int32_t* to = tr.tickets + tr.nnodes + k;
  if (threadIdx.x == 0) last = atomicAdd(to, 1) == n1 - n0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_in_order(dst, tr.partial + (tr.nslots + n0) * kVecs, n1 - n0, add);
  if (threadIdx.x == 0) *to = 0;
}

// -- tile_stream (P1, P3, P7) ------------------------------------------------

constexpr int kStreamThreads = kVecs;  // one float4 of a tile each
constexpr int kStreamU = 8;            // 16-B loads in flight a thread

// chunks[c] = (tile_lo, tile_hi, slot, output): slot -1 writes `output`
// directly (with accumulate, or a part of one step, slot >= 0 is one piece
// of the reduce); without accumulate a chunk with slot -1 holds whole steps
// and writes each.  accumulate: out (1024) = c + every tile; else out[s]
// (1024 a step) = c + step s's B tiles.
template <bool kAcc>
__global__ void __launch_bounds__(kStreamThreads, 2)
    tile_stream_kernel(const float4* __restrict__ vals,
                       const float4* __restrict__ c,
                       float4* __restrict__ out,
                       const int4* __restrict__ chunks, const Tree tr,
                       int64_t B) {
  const int p = threadIdx.x;
  const int4 ch = chunks[blockIdx.x];
  const int64_t lo = ch.x, hi = ch.y;
  const float4* v = vals + p;
  const float4 ct = __ldg(c + p);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool steps = !kAcc && ch.z < 0;
  int64_t step_end = (lo / B + 1) * B;  // the tile after the step's last
  for (int64_t t0 = lo; t0 < hi; t0 += kStreamU) {
    float4 q[kStreamU];
#pragma unroll
    for (int u = 0; u < kStreamU; ++u)
      if (t0 + u < hi) q[u] = __ldg(v + (t0 + u) * kVecs);
#pragma unroll
    for (int u = 0; u < kStreamU; ++u) {
      if (t0 + u >= hi) break;
      acc = add4(acc, q[u]);
      if (steps && t0 + u + 1 == step_end) {
        out[(t0 + u) / B * kVecs + p] = add4(acc, ct);
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        step_end += B;
      }
    }
  }
  if (steps) return;
  if (ch.z < 0) {
    out[int64_t(ch.w) * kVecs + p] = add4(acc, ct);
    return;
  }
  tr.partial[int64_t(ch.z) * kVecs + p] = acc;
  __shared__ int slot, last;
  if (p == 0) slot = ch.z;
  take_tickets(tr, &slot, 1, &last);
  if (last) finish_node(tr, ch.z, out + int64_t(ch.w) * kVecs, c);
}

// -- tile_body (P2, P4, P5) --------------------------------------------------

enum BodyValue : int { kValF32 = 0, kValBf16 = 1, kValPalette = 2,
                       kValDyadic = 3 };
enum BodyGather : int { kGatherFull = 0, kGatherNoDim1 = 1, kGatherNone = 2 };

__host__ __device__ constexpr int body_val_bytes(int vk) {
  return vk == kValF32 ? 4 : vk == kValBf16 ? 2 : 0;
}
// meta is read for the gather's sub-row or column, or for a palette code
__host__ __device__ constexpr bool body_needs_meta(int vk, int gk) {
  return gk != kGatherNone || vk == kValPalette || vk == kValDyadic;
}
template <int kVal, int kGat>
__host__ __device__ constexpr int body_stage_bytes() {
  return kTile * ((body_needs_meta(kVal, kGat) ? 2 : 0) + body_val_bytes(kVal));
}
// about kBodyRingBytes of stages a block, at least kBodyMinStages
constexpr int kBodyRingBytes = 24 * 1024;
constexpr int kBodyMinStages = 4;
template <int kVal, int kGat>
__host__ __device__ constexpr int body_stages() {
  return kBodyRingBytes / body_stage_bytes<kVal, kGat>() > kBodyMinStages
             ? kBodyRingBytes / body_stage_bytes<kVal, kGat>()
             : kBodyMinStages;
}
constexpr int kBodyU = 2;  // tiles a consumer decodes and gathers at once
constexpr int kBodyConsumerWarps = kLanes / 32;
constexpr int kBodyThreads = kLanes + 32;  // consumers, then the producer
template <int kVal, int kGat>
constexpr int body_smem_bytes() {
  return body_stages<kVal, kGat>() * (body_stage_bytes<kVal, kGat>() + 3 * 8)
         + kLanes * 4;
}

struct BodyParams {
  const uint16_t* meta;
  const void* vals;
  const float* pal;
  const int32_t* tinfo;
  const int32_t* ginfo;
  const float* x;
  const float* init;
  float* out;
  const int4* chunks;       // (tile_lo, tile_hi, run_lo, run_hi)
  const int4* runs;         // (tile_end, group, slot, 0)
  const int32_t* zero_groups;
  int64_t nzero, G;
  Tree tr;
};

// P2/P4/P5: per tile t (window w = tinfo[t] >> 3, 0 with kFixed; row
// tinfo[t] & 7) and lane j: contrib = sum over sublanes i of value(i, j) *
// x[1024 w + col(i, j)], col = 128 s + r with r = meta(i, j) & 127 and s =
// (meta(i, r) >> 7) & 7 (kGatherNoDim1: s = (meta(i, j) >> 7) & 7 and
// column j; kGatherNone: 128 i + j); contrib goes into row `row` of the
// tile's group (every row without kMask); a step's first tile adds init
// where ginfo marks the step first.
template <int kVal, int kGat, bool kMask, bool kFixed>
__global__ void __launch_bounds__(kBodyThreads, 4)
    tile_body_kernel(const BodyParams p) {
  constexpr int nst = body_stages<kVal, kGat>();
  constexpr int kSB = body_stage_bytes<kVal, kGat>();
  constexpr bool kMeta = body_needs_meta(kVal, kGat);
  constexpr int kMetaBytes = kMeta ? 2 * kTile : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* pal = reinterpret_cast<float*>(smem + nst * kSB);
  uint64_t* full = reinterpret_cast<uint64_t*>(pal + kLanes);
  uint64_t* empty = full + nst;
  int2* sinfo = reinterpret_cast<int2*>(empty + nst);  // (tinfo, opens)

  const int tid = threadIdx.x;
  const int4 ch = p.chunks[blockIdx.x];
  const int64_t t0 = ch.x;
  const int nk = ch.y - ch.x;
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBodyConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kVal == kValPalette && tid < kLanes) pal[tid] = __ldg(p.pal + tid);
  {
    // this block's share of the groups no tile visits: zeros
    const int64_t nb = gridDim.x, b = blockIdx.x;
    const int64_t z0 = p.nzero * b / nb, z1 = p.nzero * (b + 1) / nb;
    for (int64_t z = z0; z < z1; ++z) {
      float4* o = reinterpret_cast<float4*>(p.out)
                  + int64_t(__ldg(p.zero_groups + z)) * kVecs;
      for (int col = tid; col < kVecs; col += kBodyThreads)
        o[col] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  if (tid >= kLanes) {
    // the producer warp: 32 tiles' (tinfo, opens) at a time, one a lane;
    // lane 0 puts tile k in stage k % nst once the consumers have freed it
    const int lane = tid - kLanes;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int64_t tl = t0 + k0 + lane;
      const bool mine = k0 + lane < nk;
      const int32_t my_ti = mine ? __ldg(p.tinfo + tl) : 0;
      const int32_t my_open =
          mine && tl % p.G == 0 ? __ldg(p.ginfo + tl / p.G) & 1 : 0;
      const int kend = nk - k0 < 32 ? nk - k0 : 32;
      for (int kk = 0; kk < kend; ++kk) {
        const int32_t ti = __shfl_sync(0xffffffffu, my_ti, kk);
        const int32_t open = __shfl_sync(0xffffffffu, my_open, kk);
        if (lane == 0) {
          const int k = k0 + kk;
          const int s = k % nst;
          const int64_t t = t0 + k;
          if (k >= nst) mbar_wait(&empty[s], ((k / nst) - 1) & 1);
          sinfo[s] = make_int2(ti, open);
          unsigned char* dst = ring + s * kSB;
          mbar_expect_tx(&full[s], kSB);
          if constexpr (kMeta)
            bulk_g2s(dst, p.meta + t * kTile, kMetaBytes, &full[s]);
          if constexpr (body_val_bytes(kVal) > 0)
            bulk_g2s(dst + kMetaBytes,
                     static_cast<const unsigned char*>(p.vals)
                         + t * (body_val_bytes(kVal) * kTile),
                     body_val_bytes(kVal) * kTile, &full[s]);
        }
        __syncwarp();
      }
    }
  } else {
    const int j = tid;
    float iv[kSub], acc[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      iv[r] = __ldg(p.init + r * kLanes + j);
      acc[r] = 0.f;
    }
    int run = ch.z;
    int4 rn = run < ch.w ? __ldg(p.runs + run) : make_int4(0, 0, -1, 0);
    for (int k0 = 0; k0 < nk; k0 += kBodyU) {
      uint32_t off[kBodyU][kSub];
      float v[kBodyU][kSub], xg[kBodyU][kSub];
      int64_t base[kBodyU];
      int row[kBodyU], open[kBodyU];
#pragma unroll
      for (int u = 0; u < kBodyU; ++u) {
        const int k = k0 + u;
        base[u] = 0;
        row[u] = 0;
        open[u] = 0;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          off[u][i] = 0;
          v[u][i] = 0.f;
        }
        if (k >= nk) continue;  // uniform over the block
        const int s = k % nst;
        mbar_wait(&full[s], (k / nst) & 1);
        const int2 info = sinfo[s];
        row[u] = info.x & 7;
        open[u] = info.y;
        base[u] = kFixed ? 0 : int64_t(info.x >> 3) * kTile;
        const unsigned char* stage = ring + s * kSB;
        const uint16_t* mt = reinterpret_cast<const uint16_t*>(stage);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int sl = i * kLanes + j;
          uint32_t ms = 0;
          if constexpr (kMeta) ms = mt[sl];
          if constexpr (kGat == kGatherFull) {
            const uint32_t r = ms & 127u;
            off[u][i] = ((uint32_t(mt[i * kLanes + r]) >> 7) & 7u) * kLanes
                        + r;
          } else if constexpr (kGat == kGatherNoDim1) {
            off[u][i] = ((ms >> 7) & 7u) * kLanes + j;
          } else {
            off[u][i] = sl;
          }
          if constexpr (kVal == kValF32)
            v[u][i] = reinterpret_cast<const float*>(stage + kMetaBytes)[sl];
          else if constexpr (kVal == kValBf16)
            v[u][i] = bf16_bits_to_f32(
                reinterpret_cast<const uint16_t*>(stage + kMetaBytes)[sl]);
          else if constexpr (kVal == kValPalette)
            v[u][i] = pal[(ms >> 10) & 63u];
          else
            v[u][i] = float((ms >> 10) & 7u) * 0.125f;
        }
        fence_stage_reads();
        __syncwarp();
        if ((j & 31) == 0) mbar_arrive(&empty[s]);  // the stage is free
      }
#pragma unroll
      for (int u = 0; u < kBodyU; ++u)
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          xg[u][i] = k0 + u < nk ? __ldg(p.x + base[u] + off[u][i]) : 0.f;
#pragma unroll
      for (int u = 0; u < kBodyU; ++u) {
        const int k = k0 + u;
        if (k >= nk) break;
        if (open[u]) {
#pragma unroll
          for (int r = 0; r < kSub; ++r) acc[r] += iv[r];
        }
        float contrib = 0.f;
#pragma unroll
        for (int i = 0; i < kSub; ++i) contrib = fmaf(v[u][i], xg[u][i], contrib);
#pragma unroll
        for (int r = 0; r < kSub; ++r)
          if (!kMask || r == row[u]) acc[r] += contrib;
        if (t0 + k + 1 == rn.x) {
          // the run ends: its group directly, or its slot of the reduce
          float* dst = rn.z < 0 ? p.out + int64_t(rn.y) * kTile
                                : reinterpret_cast<float*>(p.tr.partial)
                                      + int64_t(rn.z) * kTile;
#pragma unroll
          for (int r = 0; r < kSub; ++r) {
            dst[r * kLanes + j] = acc[r];
            acc[r] = 0.f;
          }
          ++run;
          rn = run < ch.w ? __ldg(p.runs + run) : make_int4(0, 0, -1, 0);
        }
      }
    }
  }
  // the runs of this chunk that are slots of the reduce: their tickets in
  // one round (kBlockSlots runs at a time), then each node it finished
  __shared__ int slots[kBlockSlots], groups[kBlockSlots], last[kBlockSlots];
  for (int r0 = ch.z; r0 < ch.w; r0 += kBlockSlots) {
    const int n = ch.w - r0 < kBlockSlots ? ch.w - r0 : kBlockSlots;
    if (tid < n) {
      const int4 rr = __ldg(p.runs + r0 + tid);
      slots[tid] = rr.z;
      groups[tid] = rr.y;
    }
    take_tickets(p.tr, slots, n, last);
    for (int i = 0; i < n; ++i)
      if (last[i])
        finish_node(p.tr, slots[i],
                    reinterpret_cast<float4*>(p.out)
                        + int64_t(groups[i]) * kVecs,
                    nullptr);
    __syncthreads();  // slots and last are rewritten next round
  }
}

struct BodyArgs {
  BodyParams p;
  int64_t nchunks;
  cudaStream_t stream;
};

template <int kVal, int kGat, bool kMask, bool kFixed>
int body_launch(const BodyArgs& a) {
  constexpr int smem = body_smem_bytes<kVal, kGat>();
  static_assert(smem <= 48 * 1024, "the ring fits the default shared memory");
  tile_body_kernel<kVal, kGat, kMask, kFixed>
      <<<unsigned(a.nchunks), kBodyThreads, smem, a.stream>>>(a.p);
  return int(cudaGetLastError());
}

template <int kVal, int kGat>
int body_dispatch_flags(const BodyArgs& a, bool mask, bool fixed) {
  if (mask)
    return fixed ? body_launch<kVal, kGat, true, true>(a)
                 : body_launch<kVal, kGat, true, false>(a);
  return fixed ? body_launch<kVal, kGat, false, true>(a)
               : body_launch<kVal, kGat, false, false>(a);
}

template <int kVal>
int body_dispatch_gather(const BodyArgs& a, int64_t gather, bool mask,
                         bool fixed) {
  switch (gather) {
    case kGatherFull: return body_dispatch_flags<kVal, kGatherFull>(a, mask, fixed);
    case kGatherNoDim1:
      return body_dispatch_flags<kVal, kGatherNoDim1>(a, mask, fixed);
    case kGatherNone: return body_dispatch_flags<kVal, kGatherNone>(a, mask, fixed);
    default: return int(cudaErrorInvalidValue);
  }
}

// -- window_gather (P9) ------------------------------------------------------

constexpr int kNw = 8;                   // P9's bundle of 8 windows
constexpr int kBundle = kNw * kTile;     // its 8192 f32
constexpr int kGatherTiles = 4;          // most tiles a block holds
constexpr int kGatherThreads = 256;      // lane p % 128, 4 rows (p / 128)
constexpr int kGatherRows = kTile / kGatherThreads;

template <bool kWide>
__host__ __device__ constexpr int gather_planes() { return kWide ? 2 : 3; }
template <bool kWide>
__host__ __device__ constexpr int gather_smem_bytes() {
  return (kBundle + gather_planes<kWide>() * kGatherTiles * kTile) * 4;
}

// A 4-B load from shared memory that the compiler must issue where it
// stands: every step reads the same indices and x, so plain loads would be
// hoisted out of the step loop and the loop folded to one step.
__device__ __forceinline__ int lds_volatile(uint32_t addr) {
  int v;
  asm volatile("ld.volatile.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

// P9: the g tiles' gathered sum, every (step, tile) gather done.  The TPU
// probe runs nsteps grid steps over the same g tiles (its clamped block
// index), each step taking its tiles' 1024 slots from the VMEM-resident
// x; here block c takes tiles [ch.x, ch.y) over steps [ch.z, ch.w)
// (bench/probes.py gather_split: about two blocks an SM).  It stages the
// 32 KB bundle and its tiles' index planes in shared memory once (the
// TPU's VMEM), then every step re-reads them with volatile loads: thread
// p takes lane l = p % 128 of rows 4 (p / 128) .. + 3 of each tile, the
// slot's own index words first, then the cell words they name, then the
// x words, 4 x kGatherTiles slots in flight.  Loop form (a0 sidx, a1
// ridx, a2 wsel; x window-major): one load at the column the select
// names, x[(8 wsel + s(i, r)) * 128 + r], where the TPU takes eight and
// selects.  Wide form (a0 ctab, a1 srow): x[srow * 1024 + ctab(srow, l)].
// Indices are taken modulo their ranges (r < 128, s and wsel < 8, ctab <
// 1024).  Each slot's sum over the block's tiles (in tile order, from 0)
// is held to the previous step's, bit for bit, and a step that differs
// makes it NaN, so every step's adds are used.  The block of steps from 0
// writes its tiles' sum: straight to out when one block holds all g
// tiles, else into its slot of the Tree, which adds the slots in tile
// order (writes[c] = slot, -1 for out, -2 for nothing).
//
// Bound: 67 M adds at nsteps 2048, g 32 (1 us at 67 TFLOP/s).  What binds
// it is shared-memory issue: 4 loads a slot in the loop form, 3 in the
// wide, one warp-wide load an SM a clock, with no bank conflicts where r
// and the column in the bundle run with the lane (the probe's instance).
template <bool kWide>
__global__ void __launch_bounds__(kGatherThreads, 2)
    window_gather_kernel(const int32_t* __restrict__ a0,
                         const int32_t* __restrict__ a1,
                         const int32_t* __restrict__ a2,
                         const float* __restrict__ x,
                         float* __restrict__ out,
                         const int4* __restrict__ chunks,
                         const int32_t* __restrict__ writes, const Tree tr) {
  extern __shared__ __align__(16) int32_t sm[];
  constexpr int kPlane = kGatherTiles * kTile;  // int32 words a plane
  const int p = threadIdx.x;
  const int4 ch = chunks[blockIdx.x];
  const int nt = ch.y - ch.x;
  const int wr = writes[blockIdx.x];
  {
    // the bundle, then each plane's tiles [ch.x, ch.y), 16 B a load
    const int4* xs = reinterpret_cast<const int4*>(x);
    int4* d = reinterpret_cast<int4*>(sm);
    for (int q = p; q < kBundle / 4; q += kGatherThreads) d[q] = __ldg(xs + q);
    const int32_t* src[3] = {a0, a1, a2};
#pragma unroll
    for (int pl = 0; pl < gather_planes<kWide>(); ++pl) {
      const int4* s4 =
          reinterpret_cast<const int4*>(src[pl] + int64_t(ch.x) * kTile);
      int4* d4 = reinterpret_cast<int4*>(sm + kBundle + pl * kPlane);
      for (int q = p; q < nt * (kTile / 4); q += kGatherThreads)
        d4[q] = __ldg(s4 + q);
    }
  }
  __syncthreads();
  const uint32_t sx = smem_addr(sm);
  const uint32_t sp0 = sx + kBundle * 4;       // a0's plane
  const uint32_t sp1 = sp0 + kPlane * 4;       // a1's
  const uint32_t sp2 = sp1 + kPlane * 4;       // a2's (loop form)
  const int l = p % kLanes, i0 = p / kLanes * kGatherRows;
  float res[kGatherRows];
#pragma unroll
  for (int u = 0; u < kGatherRows; ++u) res[u] = 0.f;
  for (int step = ch.z; step < ch.w; ++step) {
    int idx[kGatherTiles][kGatherRows], sel[kGatherTiles][kGatherRows];
    // the slots' own words: ridx and wsel, or srow
#pragma unroll
    for (int k = 0; k < kGatherTiles; ++k)
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        if (k >= nt) continue;
        const uint32_t slot = 4u * (k * kTile + (i0 + u) * kLanes + l);
        idx[k][u] = lds_volatile(sp1 + slot);
        if (!kWide) sel[k][u] = lds_volatile(sp2 + slot);
      }
    // the cell words they name: s at (i, r), or ctab at (srow, l)
#pragma unroll
    for (int k = 0; k < kGatherTiles; ++k)
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        if (k >= nt) continue;
        if (kWide) {
          const int sr = idx[k][u] & (kSub - 1);
          const int c = lds_volatile(sp0 + 4u * (k * kTile + sr * kLanes + l));
          idx[k][u] = sr * (kNw * kLanes) + (c & (kNw * kLanes - 1));
        } else {
          const int r = idx[k][u] & (kLanes - 1);
          const int s = lds_volatile(sp0 + 4u * (k * kTile +
                                                 (i0 + u) * kLanes + r));
          idx[k][u] = ((kSub * (sel[k][u] & (kNw - 1)) + (s & (kSub - 1)))
                       * kLanes) + r;
        }
      }
    // the x words, added in tile order
    float acc[kGatherRows];
#pragma unroll
    for (int u = 0; u < kGatherRows; ++u) acc[u] = 0.f;
#pragma unroll
    for (int k = 0; k < kGatherTiles; ++k)
#pragma unroll
      for (int u = 0; u < kGatherRows; ++u) {
        if (k >= nt) continue;
        acc[u] += __int_as_float(lds_volatile(sx + 4u * idx[k][u]));
      }
#pragma unroll
    for (int u = 0; u < kGatherRows; ++u)
      res[u] = step == ch.z || acc[u] == res[u] ? acc[u] : __int_as_float(
                                                               0x7fc00000);
  }
  if (wr == -2) return;
  if (wr == -1) {
#pragma unroll
    for (int u = 0; u < kGatherRows; ++u) out[(i0 + u) * kLanes + l] = res[u];
    return;
  }
  float* part = reinterpret_cast<float*>(tr.partial) + int64_t(wr) * kTile;
#pragma unroll
  for (int u = 0; u < kGatherRows; ++u) part[(i0 + u) * kLanes + l] = res[u];
  __shared__ int slot, last;
  if (p == 0) slot = wr;
  take_tickets(tr, &slot, 1, &last);
  if (last) finish_node(tr, wr, reinterpret_cast<float4*>(out), nullptr);
}

template <bool kWide>
int gather_launch(const void* a0, const void* a1, const void* a2,
                  const void* x, void* out, const void* chunks,
                  const void* writes, const Tree& tr, int64_t nchunks,
                  cudaStream_t stream) {
  constexpr int smem = gather_smem_bytes<kWide>();
  auto* kernel = window_gather_kernel<kWide>;
  // past the 48 KB default, once per device; a refusal is returned like a
  // launch error
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
  kernel<<<unsigned(nchunks), kGatherThreads, smem, stream>>>(
      static_cast<const int32_t*>(a0), static_cast<const int32_t*>(a1),
      static_cast<const int32_t*>(a2), static_cast<const float*>(x),
      static_cast<float*>(out), static_cast<const int4*>(chunks),
      static_cast<const int32_t*>(writes), tr);
  return int(cudaGetLastError());
}

// Programmatic dependent launch (PTX ISA 7.8, sm_90).  The trigger lets
// the next kernel on the stream be scheduled before this one ends; the
// wait returns once every kernel before this one has completed and its
// writes are visible.  A kernel must not touch memory that a predecessor
// writes before its wait, and reads after it with ld.global.cg, not the
// read-only path: with PDL the grid is alive while its predecessor writes
// its input, which the read-only (nc) path does not allow.  The trigger may
// come first: a successor waits on this grid's completion all the same.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// P6: one (8, 128) f32 tile times 2, 256 threads, a float4 each.
__global__ void tiny_kernel(const float4* v, float4* out) {
  pdl_trigger();
  pdl_wait();
  const float4 a = __ldcg(v + threadIdx.x);
  out[threadIdx.x] = make_float4(2.f * a.x, 2.f * a.y, 2.f * a.z, 2.f * a.w);
}

// P8: e = a * b - p, fused: exactly the rounding error of p = fl(a * b).
__global__ void fma_err_kernel(const float* a, const float* b,
                               const float* p, float* e, int64_t n) {
  pdl_trigger();
  pdl_wait();
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) e[i] = __fmaf_rn(__ldcg(a + i), __ldcg(b + i), -__ldcg(p + i));
}

// One launch of `kernel` on `stream` through cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization = pdl.  A refused
// launch returns its error (cleared from cudaGetLastError, so no later
// entry reports it); nothing falls back to a plain launch.
//
// With pdl the kernel may start while the kernel before it on the stream
// runs, and waits for it (griddepcontrol.wait) before it reads.  The
// other kernels of the port (the SELL, DIA and COO2 kernels, tile_stream,
// tile_body, window_gather) launch without the attribute, so each starts
// only after a tiny or fma_err before it has completed: they never overlap
// one, and a tiny after one of them waits for it before its first read.
template <typename... Params, typename... Args>
int pdl_launch(void (*kernel)(Params...), unsigned blocks, unsigned threads,
               cudaStream_t stream, bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace spmv

// Every entry launches on `stream`, allocates nothing and returns
// cudaGetLastError().

// vals: (nsteps * B, 1024) f32; c: (1024,); out: (1024,) when accumulate,
// else (nsteps, 1024); chunks: (nchunks, 4) int32, slot_out: (nslots,),
// slot_ptr and node_ptr: (nsplit + 1,) int32, bench/probes.py's
// stream_split; partial: (nslots + nnodes, 1024) f32 scratch; tickets:
// (nnodes + nsplit,) int32, 0 before the launch and left 0.  nchunks
// blocks.
extern "C" int spmv_probe_tile_stream(const void* vals, const void* c,
                                      void* out, const void* chunks,
                                      const void* slot_out,
                                      const void* slot_ptr,
                                      const void* node_ptr, void* partial,
                                      void* tickets, int64_t nchunks,
                                      int64_t nslots, int64_t nnodes,
                                      int64_t B, int64_t accumulate,
                                      void* stream) {
  if (nchunks <= 0) return 0;
  const spmv::Tree tr{static_cast<const int32_t*>(slot_out),
                      static_cast<const int32_t*>(slot_ptr),
                      static_cast<const int32_t*>(node_ptr),
                      static_cast<int32_t*>(tickets),
                      static_cast<float4*>(partial), nslots, nnodes};
  auto* kernel = accumulate ? spmv::tile_stream_kernel<true>
                            : spmv::tile_stream_kernel<false>;
  kernel<<<unsigned(nchunks), spmv::kStreamThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(vals), static_cast<const float4*>(c),
      static_cast<float4*>(out), static_cast<const int4*>(chunks), tr, B);
  return int(cudaGetLastError());
}

// meta: (nsteps * G, 1024) int16 and vals: f32 or bf16 bits a slot (value
// kinds 0, 1) or null, both 16-B aligned (bulk copies); pal: (128,) f32;
// tinfo: (nsteps * G,) int32; ginfo: (nsteps,) int32; x: f32 covering
// every window read; init: (1024,) f32; out: (ngroups, 1024) f32, every
// group written; chunks: (nchunks, 4), runs: (nruns, 4), zero_groups:
// (nzero,), slot_out, slot_ptr, node_ptr: int32, bench/probes.py's
// body_split; partial and tickets as for tile_stream.  nchunks blocks.
extern "C" int spmv_probe_tile_body(
    const void* meta, const void* vals, const void* pal, const void* tinfo,
    const void* ginfo, const void* x, const void* init, void* out,
    const void* chunks, const void* runs, const void* zero_groups,
    const void* slot_out, const void* slot_ptr, const void* node_ptr,
    void* partial, void* tickets, int64_t nchunks, int64_t nzero,
    int64_t nslots, int64_t nnodes, int64_t G, int64_t value_kind,
    int64_t gather, int64_t mask, int64_t fixed_window, void* stream) {
  if (nchunks <= 0) return 0;
  const spmv::BodyArgs a{
      {static_cast<const uint16_t*>(meta), vals,
       static_cast<const float*>(pal), static_cast<const int32_t*>(tinfo),
       static_cast<const int32_t*>(ginfo), static_cast<const float*>(x),
       static_cast<const float*>(init), static_cast<float*>(out),
       static_cast<const int4*>(chunks), static_cast<const int4*>(runs),
       static_cast<const int32_t*>(zero_groups), nzero, G,
       {static_cast<const int32_t*>(slot_out),
        static_cast<const int32_t*>(slot_ptr),
        static_cast<const int32_t*>(node_ptr),
        static_cast<int32_t*>(tickets), static_cast<float4*>(partial),
        nslots, nnodes}},
      nchunks, static_cast<cudaStream_t>(stream)};
  const bool m = mask != 0, f = fixed_window != 0;
  switch (value_kind) {
    case spmv::kValF32:
      return spmv::body_dispatch_gather<spmv::kValF32>(a, gather, m, f);
    case spmv::kValBf16:
      return spmv::body_dispatch_gather<spmv::kValBf16>(a, gather, m, f);
    case spmv::kValPalette:
      return spmv::body_dispatch_gather<spmv::kValPalette>(a, gather, m, f);
    case spmv::kValDyadic:
      return spmv::body_dispatch_gather<spmv::kValDyadic>(a, gather, m, f);
    default: return int(cudaErrorInvalidValue);
  }
}

// Loop form (wide = 0): a0 sidx, a1 ridx, a2 wsel, (g, 1024) int32 each, x
// (8 windows * 1024,) window-major.  Wide form: a0 ctab, a1 srow, a2 unused,
// x the (8, 1024) bundle.  All 16-B aligned.  out: (1024,).  chunks:
// (nchunks, 4) int32 (tile_lo, tile_hi, step_lo, step_hi), at most 4 tiles
// each; writes: (nchunks,) int32; slot_out, slot_ptr, node_ptr, partial
// and tickets as for tile_stream: bench/probes.py's gather_split.
// nchunks blocks.
extern "C" int spmv_probe_window_gather(
    const void* a0, const void* a1, const void* a2, const void* x, void* out,
    const void* chunks, const void* writes, const void* slot_out,
    const void* slot_ptr, const void* node_ptr, void* partial, void* tickets,
    int64_t nchunks, int64_t nslots, int64_t nnodes, int64_t wide,
    void* stream) {
  if (nchunks <= 0) return 0;
  const spmv::Tree tr{static_cast<const int32_t*>(slot_out),
                      static_cast<const int32_t*>(slot_ptr),
                      static_cast<const int32_t*>(node_ptr),
                      static_cast<int32_t*>(tickets),
                      static_cast<float4*>(partial), nslots, nnodes};
  auto* launch = wide ? spmv::gather_launch<true> : spmv::gather_launch<false>;
  return launch(a0, a1, a2, x, out, chunks, writes, tr, nchunks,
                static_cast<cudaStream_t>(stream));
}

// v, out: (1024,) f32, 16-B aligned.  One launch with PDL.
extern "C" int spmv_probe_tiny(const void* v, void* out, void* stream) {
  return spmv::pdl_launch(spmv::tiny_kernel, 1, spmv::kStreamThreads,
                          static_cast<cudaStream_t>(stream), true,
                          static_cast<const float4*>(v),
                          static_cast<float4*>(out));
}

// n dependent tiny launches back to back, with PDL when pdl != 0, and no
// host work between them but the launch calls: v -> a, then a -> b, b ->
// a, ...  The result is in a for odd n, in b for even n.  v, a, b: (1024,)
// f32, 16-B aligned, a and b apart from v and each other.  Stops at the
// first refused launch and returns its error.
extern "C" int spmv_probe_tiny_chain(const void* v, void* a, void* b,
                                     int64_t n, int64_t pdl, void* stream) {
  const float4* src = static_cast<const float4*>(v);
  float4* dst = static_cast<float4*>(a);
  float4* next = static_cast<float4*>(b);
  for (int64_t i = 0; i < n; ++i) {
    const int err = spmv::pdl_launch(
        spmv::tiny_kernel, 1, spmv::kStreamThreads,
        static_cast<cudaStream_t>(stream), pdl != 0, src, dst);
    if (err) return err;
    src = dst;
    std::swap(dst, next);
  }
  return 0;
}

// a, b, p, e: (n,) f32.  One launch with PDL, 256 threads a block.
extern "C" int spmv_probe_fma_err(const void* a, const void* b,
                                  const void* p, void* e, int64_t n,
                                  void* stream) {
  if (n <= 0) return 0;
  return spmv::pdl_launch(spmv::fma_err_kernel, unsigned((n + 255) / 256),
                          256, static_cast<cudaStream_t>(stream), true,
                          static_cast<const float*>(a),
                          static_cast<const float*>(b),
                          static_cast<const float*>(p),
                          static_cast<float*>(e), n);
}
