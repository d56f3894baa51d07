// Native host packers for spmv_tpu_torch (C++17, no external deps).
//
// The port's own copy of spmv_tpu/native/spmv_native.cpp, kept byte for
// byte in its code so that both packages emit identical packs (pinned by
// tests/test_torch_formats.py).  The port binds the SELL-8W greedy tile
// packer and the SELL-8D slot-mode packer with its bundle-width stats
// (native/__init__.py); the MatrixMarket parser and the COO2 packers
// ride along unbound.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kSub = 8;
constexpr int kLanes = 128;
constexpr int kWindow = kSub * kLanes;  // 1024

struct CooBuffer {
  int64_t m = 0, n = 0, nnz = 0;
  std::vector<int32_t> rows, cols;
  std::vector<double> vals;
};

struct TileBuffer {
  std::vector<int32_t> window_ids, slice_ids;
  std::vector<int16_t> meta;   // ntiles * 8 * 128
  std::vector<float> vals;     // ntiles * 8 * 128
};

// Fast ASCII parsing helpers (strtod/strtol with manual whitespace skip).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket coordinate parser.
// Returns a handle (opaque pointer) or nullptr on failure.  Symmetry
// expansion (general=0, symmetric=1, skew=2) happens here, mirroring
// mmio_highlevel.h:439-463.  field: real/integer/pattern/complex(real part).
// ---------------------------------------------------------------------------
void* mtx_parse(const char* path, int* err) {
  *err = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = 1; return nullptr; }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(fsize) + 1);
  if (std::fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f); *err = 2; return nullptr;
  }
  std::fclose(f);
  buf[fsize] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + fsize;

  // banner
  int pattern = 0, complex_field = 0, symmetry = 0;  // 0 gen, 1 sym, 2 skew
  {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl || std::strncmp(p, "%%MatrixMarket", 14) != 0) {
      *err = 3; return nullptr;
    }
    std::string banner(p, nl);
    for (auto& c : banner) c = static_cast<char>(std::tolower(c));
    if (banner.find("coordinate") == std::string::npos) { *err = 4; return nullptr; }
    if (banner.find("pattern") != std::string::npos) pattern = 1;
    if (banner.find("complex") != std::string::npos) complex_field = 1;
    if (banner.find("skew-symmetric") != std::string::npos) symmetry = 2;
    else if (banner.find("symmetric") != std::string::npos ||
             banner.find("hermitian") != std::string::npos) symmetry = 1;
    p = nl + 1;
  }
  // comments
  while (p < end && *p == '%') {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) { *err = 5; return nullptr; }
    p = nl + 1;
  }
  char* q = nullptr;
  long m = std::strtol(p, &q, 10); p = q;
  long n = std::strtol(p, &q, 10); p = q;
  long nnz = std::strtol(p, &q, 10); p = q;
  if (m <= 0 || n <= 0 || nnz < 0) { *err = 6; return nullptr; }

  auto* coo = new CooBuffer();
  coo->m = m; coo->n = n;
  size_t cap = static_cast<size_t>(nnz) * (symmetry ? 2 : 1);
  coo->rows.reserve(cap); coo->cols.reserve(cap); coo->vals.reserve(cap);
  for (long k = 0; k < nnz; ++k) {
    p = skip_ws(p, end);
    if (p >= end) { delete coo; *err = 7; return nullptr; }
    long r = std::strtol(p, &q, 10); p = q;
    long c = std::strtol(p, &q, 10); p = q;
    double v = 1.0;
    if (!pattern) { v = std::strtod(p, &q); p = q; }
    if (complex_field) { std::strtod(p, &q); p = q; }  // skip imaginary
    --r; --c;
    if (r < 0 || r >= m || c < 0 || c >= n) { delete coo; *err = 8; return nullptr; }
    coo->rows.push_back(static_cast<int32_t>(r));
    coo->cols.push_back(static_cast<int32_t>(c));
    coo->vals.push_back(v);
    if (symmetry && r != c) {
      coo->rows.push_back(static_cast<int32_t>(c));
      coo->cols.push_back(static_cast<int32_t>(r));
      coo->vals.push_back(symmetry == 2 ? -v : v);
    }
  }
  coo->nnz = static_cast<int64_t>(coo->rows.size());
  return coo;
}

int64_t mtx_m(void* h) { return static_cast<CooBuffer*>(h)->m; }
int64_t mtx_n(void* h) { return static_cast<CooBuffer*>(h)->n; }
int64_t mtx_nnz(void* h) { return static_cast<CooBuffer*>(h)->nnz; }

void mtx_copy(void* h, int32_t* rows, int32_t* cols, double* vals) {
  auto* coo = static_cast<CooBuffer*>(h);
  std::memcpy(rows, coo->rows.data(), coo->rows.size() * sizeof(int32_t));
  std::memcpy(cols, coo->cols.data(), coo->cols.size() * sizeof(int32_t));
  std::memcpy(vals, coo->vals.data(), coo->vals.size() * sizeof(double));
}

void mtx_free(void* h) { delete static_cast<CooBuffer*>(h); }

// ---------------------------------------------------------------------------
// SELL-8W greedy packer (see formats/sell8w.py for the format contract).
// Input: CSR (rowptr int32[m+1], colidx int32[nnz], vals float[nnz]).
// Elements must be processed grouped by (slice, window) with lanes
// interleaved — this function does the grouping itself.
// Returns a handle; copy out via sell8w_copy, free via sell8w_free.
// ---------------------------------------------------------------------------
void* sell8w_pack(int64_t m, int64_t n, const int32_t* rowptr,
                  const int32_t* colidx, const float* vals,
                  int64_t* ntiles_out) {
  int64_t nslices = m > 0 ? (m + kLanes - 1) / kLanes : 1;
  int64_t nnz = rowptr[m];
  // bucket elements by (slice, window)
  struct Elem { int32_t lane; int8_t s; int8_t r; float v; };
  // two-pass counting sort over key = slice * nwin + window
  int64_t nwin = (n + kWindow - 1) / kWindow + 1;
  std::vector<int64_t> counts(static_cast<size_t>(nslices * nwin) + 1, 0);
  for (int64_t row = 0; row < m; ++row) {
    int64_t sl = row / kLanes;
    for (int32_t k = rowptr[row]; k < rowptr[row + 1]; ++k) {
      ++counts[sl * nwin + colidx[k] / kWindow + 1];
    }
  }
  for (size_t i = 1; i < counts.size(); ++i) counts[i] += counts[i - 1];
  std::vector<Elem> elems(static_cast<size_t>(nnz));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t row = 0; row < m; ++row) {
    int64_t sl = row / kLanes;
    int32_t lane = static_cast<int32_t>(row % kLanes);
    for (int32_t k = rowptr[row]; k < rowptr[row + 1]; ++k) {
      int32_t c = colidx[k];
      int64_t key = sl * nwin + c / kWindow;
      Elem& e = elems[static_cast<size_t>(cursor[key]++)];
      e.lane = lane;
      e.s = static_cast<int8_t>((c % kWindow) / kLanes);
      e.r = static_cast<int8_t>(c % kLanes);
      e.v = vals[k];
    }
  }

  auto* tb = new TileBuffer();
  std::vector<int16_t> stab(kSub * kLanes);
  std::vector<int16_t> rslot(kSub * kLanes);
  std::vector<float> vtile(kSub * kLanes);
  std::vector<uint8_t> lane_used(kSub * kLanes);
  std::vector<int32_t> pending, overflow;

  for (int64_t sl = 0; sl < nslices; ++sl) {
    for (int64_t wdx = 0; wdx < nwin; ++wdx) {
      int64_t lo = counts[sl * nwin + wdx];
      int64_t hi = counts[sl * nwin + wdx + 1];
      if (lo >= hi) continue;
      pending.clear();
      for (int64_t k = lo; k < hi; ++k)
        pending.push_back(static_cast<int32_t>(k));
      while (!pending.empty()) {
        std::fill(stab.begin(), stab.end(), static_cast<int16_t>(-1));
        std::fill(rslot.begin(), rslot.end(), static_cast<int16_t>(0));
        std::fill(vtile.begin(), vtile.end(), 0.0f);
        std::fill(lane_used.begin(), lane_used.end(), 0);
        overflow.clear();
        for (int32_t ei : pending) {
          const Elem& e = elems[static_cast<size_t>(ei)];
          bool placed = false;
          for (int i = 0; i < kSub; ++i) {
            int16_t& st = stab[i * kLanes + e.r];
            if (!lane_used[i * kLanes + e.lane] && (st == -1 || st == e.s)) {
              lane_used[i * kLanes + e.lane] = 1;
              st = e.s;
              rslot[i * kLanes + e.lane] = e.r;
              vtile[i * kLanes + e.lane] = e.v;
              placed = true;
              break;
            }
          }
          if (!placed) overflow.push_back(ei);
        }
        tb->window_ids.push_back(static_cast<int32_t>(wdx));
        tb->slice_ids.push_back(static_cast<int32_t>(sl));
        size_t base = tb->meta.size();
        tb->meta.resize(base + kSub * kLanes);
        tb->vals.resize(base + kSub * kLanes);
        for (int i = 0; i < kSub * kLanes; ++i) {
          int16_t st = stab[i] < 0 ? 0 : stab[i];
          tb->meta[base + i] =
              static_cast<int16_t>((st << 7) | rslot[i]);
          tb->vals[base + i] = vtile[i];
        }
        pending.swap(overflow);
      }
    }
  }

  // cover every slice-group with at least one tile (kernel zero-init rule);
  // tiles are already slice-major so group coverage insertion keeps order
  // by rebuilding with merge.
  int64_t ngroups = (nslices + kSub - 1) / kSub;
  std::vector<uint8_t> covered(static_cast<size_t>(ngroups), 0);
  for (int32_t s : tb->slice_ids) covered[static_cast<size_t>(s / kSub)] = 1;
  bool need = false;
  for (auto c : covered) if (!c) { need = true; break; }
  if (need) {
    TileBuffer merged;
    size_t ti = 0;
    for (int64_t g = 0; g < ngroups; ++g) {
      if (!covered[static_cast<size_t>(g)]) {
        merged.window_ids.push_back(0);
        merged.slice_ids.push_back(static_cast<int32_t>(g * kSub));
        merged.meta.insert(merged.meta.end(), kSub * kLanes, 0);
        merged.vals.insert(merged.vals.end(), kSub * kLanes, 0.0f);
      }
      while (ti < tb->slice_ids.size() &&
             tb->slice_ids[ti] / kSub == g) {
        merged.window_ids.push_back(tb->window_ids[ti]);
        merged.slice_ids.push_back(tb->slice_ids[ti]);
        size_t off = ti * kSub * kLanes;
        merged.meta.insert(merged.meta.end(), tb->meta.begin() + off,
                           tb->meta.begin() + off + kSub * kLanes);
        merged.vals.insert(merged.vals.end(), tb->vals.begin() + off,
                           tb->vals.begin() + off + kSub * kLanes);
        ++ti;
      }
    }
    *tb = std::move(merged);
  }
  if (tb->slice_ids.empty()) {
    tb->window_ids.push_back(0);
    tb->slice_ids.push_back(0);
    tb->meta.insert(tb->meta.end(), kSub * kLanes, 0);
    tb->vals.insert(tb->vals.end(), kSub * kLanes, 0.0f);
  }
  *ntiles_out = static_cast<int64_t>(tb->slice_ids.size());
  return tb;
}

void sell8w_copy(void* h, int32_t* window_ids, int32_t* slice_ids,
                 int16_t* meta, float* vals) {
  auto* tb = static_cast<TileBuffer*>(h);
  std::memcpy(window_ids, tb->window_ids.data(),
              tb->window_ids.size() * sizeof(int32_t));
  std::memcpy(slice_ids, tb->slice_ids.data(),
              tb->slice_ids.size() * sizeof(int32_t));
  std::memcpy(meta, tb->meta.data(), tb->meta.size() * sizeof(int16_t));
  std::memcpy(vals, tb->vals.data(), tb->vals.size() * sizeof(float));
}

void sell8w_free(void* h) { delete static_cast<TileBuffer*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// COO2 pass-1 greedy placer (see formats/coo2.py).  Elements arrive sorted
// (already grouped); each group's elements share one x-window.  A slot (i,j)
// is free-form under the per-(sublane,residue) staging-consistency
// constraint; positions are recorded per element for the pass-2 R matrix.
// ---------------------------------------------------------------------------
struct Coo2Buffer {
  std::vector<int32_t> window_ids;
  std::vector<int16_t> meta;
  std::vector<float> vals;
  std::vector<int64_t> positions;   // per input element
};

extern "C" void* coo2_place(int64_t n_elems, const int16_t* s,
                            const int16_t* r, const float* v,
                            int64_t ngroups, const int64_t* group_w,
                            const int64_t* group_lo, const int64_t* group_hi,
                            int64_t* ntiles_out) {
  auto* cb = new Coo2Buffer();
  cb->positions.resize(static_cast<size_t>(n_elems));
  std::vector<int16_t> stab(kSub * kLanes);
  std::vector<int16_t> rslot(kSub * kLanes);
  std::vector<float> vtile(kSub * kLanes);
  int64_t next_free[kSub];
  std::vector<int64_t> pending, overflow;
  for (int64_t g = 0; g < ngroups; ++g) {
    pending.clear();
    for (int64_t e = group_lo[g]; e < group_hi[g]; ++e) pending.push_back(e);
    while (!pending.empty()) {
      std::fill(stab.begin(), stab.end(), static_cast<int16_t>(-1));
      std::fill(rslot.begin(), rslot.end(), static_cast<int16_t>(0));
      std::fill(vtile.begin(), vtile.end(), 0.0f);
      std::fill(next_free, next_free + kSub, 0);
      overflow.clear();
      int64_t t_idx = static_cast<int64_t>(cb->window_ids.size());
      for (int64_t e : pending) {
        int16_t s_e = s[e], r_e = r[e];
        bool placed = false;
        for (int i = 0; i < kSub; ++i) {
          int16_t& st = stab[i * kLanes + r_e];
          if (next_free[i] < kLanes && (st == -1 || st == s_e)) {
            int64_t j = next_free[i]++;
            st = s_e;
            rslot[i * kLanes + j] = r_e;
            vtile[i * kLanes + j] = v[e];
            cb->positions[static_cast<size_t>(e)] =
                t_idx * kWindow + i * kLanes + j;
            placed = true;
            break;
          }
        }
        if (!placed) overflow.push_back(e);
      }
      cb->window_ids.push_back(static_cast<int32_t>(group_w[g]));
      size_t base = cb->meta.size();
      cb->meta.resize(base + kSub * kLanes);
      cb->vals.resize(base + kSub * kLanes);
      for (int i = 0; i < kSub * kLanes; ++i) {
        int16_t st = stab[i] < 0 ? 0 : stab[i];
        cb->meta[base + i] = static_cast<int16_t>((st << 7) | rslot[i]);
        cb->vals[base + i] = vtile[i];
      }
      pending.swap(overflow);
    }
  }
  *ntiles_out = static_cast<int64_t>(cb->window_ids.size());
  return cb;
}

extern "C" void coo2_copy(void* h, int32_t* window_ids, int16_t* meta,
                          float* vals, int64_t* positions) {
  auto* cb = static_cast<Coo2Buffer*>(h);
  std::memcpy(window_ids, cb->window_ids.data(),
              cb->window_ids.size() * sizeof(int32_t));
  std::memcpy(meta, cb->meta.data(), cb->meta.size() * sizeof(int16_t));
  std::memcpy(vals, cb->vals.data(), cb->vals.size() * sizeof(float));
  std::memcpy(positions, cb->positions.data(),
              cb->positions.size() * sizeof(int64_t));
}

extern "C" void coo2_free(void* h) { delete static_cast<Coo2Buffer*>(h); }

// ---------------------------------------------------------------------------
// Fused COO2 pipeline: CSR in → pass-1 tiles + pass-2 R matrix (CSR) out.
// Replaces the python stages (derive keys, group sort, place, R from_coo)
// that cost ~7 s at 6.3M nnz on this host (VERDICT round-1 item 2).
// Group key = (super_slice, window); a stable counting sort preserves CSR
// (row, col) order within groups — behavior-identical to the python path's
// stable argsort.  R rows come out with positions sorted ascending, matching
// CsrMatrix.from_coo's (row, position) lexsort.
// ---------------------------------------------------------------------------
struct Coo2AllBuffer {
  std::vector<int32_t> window_ids;
  std::vector<int16_t> meta;
  std::vector<float> vals;
  std::vector<int32_t> r_rowptr;    // (m+1,)
  std::vector<int32_t> r_colidx;    // (nnz,) positions, sorted within rows
};

extern "C" void* coo2_pack_all(int64_t m, int64_t n, const int32_t* rowptr,
                               const int32_t* colidx, const float* vals,
                               int64_t super_slices, int64_t* ntiles_out) {
  int64_t nnz = rowptr[m];
  int64_t nwin = n / kWindow + 2;
  int64_t nsup = ((m > 0 ? (m - 1) / kLanes : 0) / super_slices) + 1;
  int64_t nkeys = nsup * nwin;

  // 1. stable counting sort by (sup, window)
  std::vector<int64_t> counts(static_cast<size_t>(nkeys) + 1, 0);
  for (int64_t row = 0; row < m; ++row) {
    int64_t sup = (row / kLanes) / super_slices;
    for (int32_t k = rowptr[row]; k < rowptr[row + 1]; ++k)
      ++counts[sup * nwin + colidx[k] / kWindow + 1];
  }
  for (size_t i = 1; i < counts.size(); ++i) counts[i] += counts[i - 1];
  struct Elem { int32_t row; int16_t s; int16_t r; float v; };
  std::vector<Elem> elems(static_cast<size_t>(nnz));
  {
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t row = 0; row < m; ++row) {
      int64_t sup = (row / kLanes) / super_slices;
      for (int32_t k = rowptr[row]; k < rowptr[row + 1]; ++k) {
        int32_t c = colidx[k];
        Elem& e = elems[static_cast<size_t>(cursor[sup * nwin + c / kWindow]++)];
        e.row = static_cast<int32_t>(row);
        e.s = static_cast<int16_t>((c % kWindow) / kLanes);
        e.r = static_cast<int16_t>(c % kLanes);
        e.v = vals[k];
      }
    }
  }

  // 2. greedy placement per populated group (same loop as coo2_place)
  auto* out = new Coo2AllBuffer();
  std::vector<int64_t> positions(static_cast<size_t>(nnz));
  std::vector<int16_t> stab(kSub * kLanes);
  std::vector<int16_t> rslot(kSub * kLanes);
  std::vector<float> vtile(kSub * kLanes);
  int64_t next_free[kSub];
  std::vector<int64_t> pending, overflow;
  for (int64_t key = 0; key < nkeys; ++key) {
    int64_t lo = counts[key], hi = counts[key + 1];
    if (lo >= hi) continue;
    int32_t wdx = static_cast<int32_t>(key % nwin);
    pending.clear();
    for (int64_t e = lo; e < hi; ++e) pending.push_back(e);
    while (!pending.empty()) {
      std::fill(stab.begin(), stab.end(), static_cast<int16_t>(-1));
      std::fill(rslot.begin(), rslot.end(), static_cast<int16_t>(0));
      std::fill(vtile.begin(), vtile.end(), 0.0f);
      std::fill(next_free, next_free + kSub, 0);
      overflow.clear();
      int64_t t_idx = static_cast<int64_t>(out->window_ids.size());
      for (int64_t e : pending) {
        int16_t s_e = elems[e].s, r_e = elems[e].r;
        bool placed = false;
        for (int i = 0; i < kSub; ++i) {
          int16_t& st = stab[i * kLanes + r_e];
          if (next_free[i] < kLanes && (st == -1 || st == s_e)) {
            int64_t j = next_free[i]++;
            st = s_e;
            rslot[i * kLanes + j] = r_e;
            vtile[i * kLanes + j] = elems[e].v;
            positions[static_cast<size_t>(e)] = t_idx * kWindow + i * kLanes + j;
            placed = true;
            break;
          }
        }
        if (!placed) overflow.push_back(e);
      }
      out->window_ids.push_back(wdx);
      size_t base = out->meta.size();
      out->meta.resize(base + kSub * kLanes);
      out->vals.resize(base + kSub * kLanes);
      for (int i = 0; i < kSub * kLanes; ++i) {
        int16_t st = stab[i] < 0 ? 0 : stab[i];
        out->meta[base + i] = static_cast<int16_t>((st << 7) | rslot[i]);
        out->vals[base + i] = vtile[i];
      }
      pending.swap(overflow);
    }
  }

  // 3. R matrix CSR: positions bucketed per original row, sorted ascending
  out->r_rowptr.assign(static_cast<size_t>(m) + 1, 0);
  for (const Elem& e : elems) ++out->r_rowptr[static_cast<size_t>(e.row) + 1];
  for (int64_t i = 1; i <= m; ++i) out->r_rowptr[i] += out->r_rowptr[i - 1];
  out->r_colidx.resize(static_cast<size_t>(nnz));
  {
    std::vector<int32_t> cursor(out->r_rowptr.begin(), out->r_rowptr.end() - 1);
    for (int64_t e = 0; e < nnz; ++e)
      out->r_colidx[static_cast<size_t>(cursor[elems[e].row]++)] =
          static_cast<int32_t>(positions[e]);
    for (int64_t row = 0; row < m; ++row)
      std::sort(out->r_colidx.begin() + out->r_rowptr[row],
                out->r_colidx.begin() + out->r_rowptr[row + 1]);
  }
  *ntiles_out = static_cast<int64_t>(out->window_ids.size());
  return out;
}

extern "C" void coo2_all_copy(void* h, int32_t* window_ids, int16_t* meta,
                              float* vals, int32_t* r_rowptr,
                              int32_t* r_colidx) {
  auto* b = static_cast<Coo2AllBuffer*>(h);
  std::memcpy(window_ids, b->window_ids.data(),
              b->window_ids.size() * sizeof(int32_t));
  std::memcpy(meta, b->meta.data(), b->meta.size() * sizeof(int16_t));
  std::memcpy(vals, b->vals.data(), b->vals.size() * sizeof(float));
  std::memcpy(r_rowptr, b->r_rowptr.data(),
              b->r_rowptr.size() * sizeof(int32_t));
  std::memcpy(r_colidx, b->r_colidx.data(),
              b->r_colidx.size() * sizeof(int32_t));
}

extern "C" void coo2_all_free(void* h) {
  delete static_cast<Coo2AllBuffer*>(h);
}

// ---------------------------------------------------------------------------
// SELL-8D slot-mode packer (formats/sell8d.py role): greedy sequential
// placement with an open-addressing s-cell table.  The numpy pipeline runs
// balanced-init + synchronized wrap-repair rounds (2.5-15 s at 4M nnz on
// this contended host); the sequential first-fit here resolves the same
// constraints per entry in one pass.  Placements may differ from Python's
// (both are valid packings — parity tests compare RECONSTRUCTION, not
// bytes).
// ---------------------------------------------------------------------------

namespace {

struct Sell8dBuffer {
  std::vector<int32_t> tinfo;       // (ntiles)
  std::vector<int32_t> ginfo;       // (nsteps)
  std::vector<int16_t> meta;        // ntiles * 1024
  std::vector<int64_t> slot_flat;   // per kept entry
  std::vector<int64_t> kept_idx;    // original nnz index per kept entry
  std::vector<int64_t> spill_idx;   // original nnz index per spilled entry
  int64_t ntiles = 0;
  int cap = 0;
};

// open-addressing int64->int8 map (linear probe, power-of-2, key!=-1)
struct CellMap {
  std::vector<int64_t> keys;
  std::vector<int8_t> vals;
  size_t mask = 0;
  explicit CellMap(size_t want) {
    size_t cap = 16;
    while (cap < want * 2) cap <<= 1;
    keys.assign(cap, -1);
    vals.assign(cap, 0);
    mask = cap - 1;
  }
  // returns stored value for key; inserts if absent. -1 sentinel unused.
  inline int8_t* probe(int64_t key) {
    size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ull) & mask;
    while (true) {
      if (keys[h] == key) return &vals[h];
      if (keys[h] == -1) { keys[h] = key; vals[h] = -1; return &vals[h]; }
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

// Slice-aligned row ranges with ~equal nnz for the parallel pack phases.
// Every phase below is independent per 1024-row slice (cell keys embed the
// pair id = slice*nb + bundle; masks are per-row), so slice-aligned ranges
// make the threaded result IDENTICAL to the sequential one.
static std::vector<std::pair<int64_t, int64_t>> slice_ranges(
    int64_t m, const int32_t* rowptr, int nthreads) {
  std::vector<std::pair<int64_t, int64_t>> out;
  const int64_t nnz = rowptr[m];
  const int64_t per = (nnz + nthreads - 1) / nthreads;
  int64_t r0 = 0;
  while (r0 < m) {
    int64_t target = rowptr[r0] + per;
    int64_t r1 = r0 + 1024;                 // at least one slice
    while (r1 < m && rowptr[std::min<int64_t>(r1, m)] < target) r1 += 1024;
    if (r1 > m) r1 = m;
    out.emplace_back(r0, r1);
    r0 = r1;
  }
  return out;
}

extern "C" void* sell8d_pack(
    int64_t m, int64_t n, const int32_t* rowptr, const int32_t* colidx,
    int nw, int g, int depth_cap /* <=0: auto */, double tile_ns,
    double spill_ns, double pair_spill_ns, double max_spill,
    int cell_w /* round 5: window-select joins s in the cell table */,
    int cap_within_gate /* the cap's tail within max_spill while any fits */,
    int64_t* out_ntiles, int64_t* out_nkept, int64_t* out_nspill,
    int* out_cap) {
  if (m <= 0 || n <= 0 || rowptr[m] <= 0) return nullptr;
  const int64_t nnz = rowptr[m];
  int lb = 0;
  while ((1 << lb) < nw) ++lb;
  const int64_t bcols = static_cast<int64_t>(kWindow) << lb;
  const int64_t nb = std::max<int64_t>((n + bcols - 1) / bcols, 1);
  const int64_t nslices = std::max<int64_t>((m + kWindow - 1) / kWindow, 1);
  // thread the O(nnz) phases on large packs (measured: the sequential
  // pack was 27.5 s at 32M nnz — the 75.6 s scattered-4M predeal outlier,
  // VERDICT round-3 item 2; per-range cell maps also fit cache where the
  // single 1 GB map thrashed DRAM)
  int nthreads = 1;
  if (nnz >= (1 << 20)) {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = static_cast<int>(std::min<unsigned>(hw ? hw : 1, 8));
  }
  const auto ranges = slice_ranges(m, rowptr, nthreads);

  auto par_for = [&](auto&& fn) {
    if (ranges.size() <= 1) {
      for (size_t i = 0; i < ranges.size(); ++i) fn(i);
      return;
    }
    std::vector<std::thread> ts;
    std::atomic<size_t> next{0};
    const int nt = std::min<int>(nthreads, static_cast<int>(ranges.size()));
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&]() {
        for (size_t i = next.fetch_add(1); i < ranges.size();
             i = next.fetch_add(1))
          fn(i);
      });
    for (auto& th : ts) th.join();
  };

  // --- group sizes per (row, bundle) + per-pair dmax (full set) ----------
  // Per row: bundle counts via a small scan (columns need not be sorted);
  // rows rarely touch more than a few hundred bundles.
  std::vector<int64_t> dmax(static_cast<size_t>(nslices) * nb, 0);
  std::vector<int32_t> gsize(nnz);        // group size stamped per entry
  std::vector<int32_t> grank(nnz);        // rank within the group
  par_for([&](size_t ri) {
    std::vector<int32_t> cnt;             // per-row scratch: bundle -> count
    cnt.assign(static_cast<size_t>(nb), 0);
    std::vector<int64_t> touched;
    for (int64_t r = ranges[ri].first; r < ranges[ri].second; ++r) {
      const int64_t p0 = rowptr[r], p1 = rowptr[r + 1];
      if (p0 == p1) continue;
      touched.clear();
      for (int64_t p = p0; p < p1; ++p) {
        const int64_t b = colidx[p] >> (10 + lb);
        grank[p] = cnt[b]++;
        if (grank[p] == 0) touched.push_back(b);
      }
      const int64_t slice = r >> 10;
      for (int64_t b : touched) {
        const int64_t pr = slice * nb + b;
        if (cnt[b] > dmax[pr]) dmax[pr] = cnt[b];
      }
      for (int64_t p = p0; p < p1; ++p)
        gsize[p] = cnt[colidx[p] >> (10 + lb)];
      for (int64_t b : touched) cnt[b] = 0;
    }
  });

  // --- cost-model depth cap (mirrors formats/sell8d.py _cost_cap) --------
  int cap = depth_cap;
  if (cap <= 0) {
    int64_t smax = 0;
    for (int64_t p = 0; p < nnz; ++p)
      if (grank[p] == gsize[p] - 1 && gsize[p] > smax) smax = gsize[p];
    const int64_t cm = std::min<int64_t>(smax, 1024);
    std::vector<int64_t> hs(cm + 2, 0), hd(cm + 2, 0);
    int64_t excess_s = 0, excess_d = 0;
    for (int64_t p = 0; p < nnz; ++p)
      if (grank[p] == gsize[p] - 1) {     // one hit per group
        int64_t s = gsize[p];
        if (s > cm + 1) { excess_s += s - (cm + 1); s = cm + 1; }
        ++hs[s];
      }
    for (size_t pr = 0; pr < dmax.size(); ++pr)
      if (dmax[pr] > 0) {
        int64_t d = dmax[pr];
        if (d > cm + 1) { excess_d += d - (cm + 1); d = cm + 1; }
        ++hd[d];
      }
    // suffix sums
    std::vector<int64_t> cs(cm + 3, 0), ss(cm + 3, 0), cd(cm + 3, 0),
        sd(cm + 3, 0);
    for (int64_t i = cm + 1; i >= 0; --i) {
      cs[i] = cs[i + 1] + hs[i];
      ss[i] = ss[i + 1] + hs[i] * i;
      cd[i] = cd[i + 1] + hd[i];
      sd[i] = sd[i + 1] + hd[i] * i;
    }
    const int64_t total_d = sd[0] + excess_d;
    const int64_t budget = cap_within_gate
        ? static_cast<int64_t>(max_spill * static_cast<double>(nnz)) : -1;
    double best = 1e300;
    bool fits = false;
    cap = 1;
    for (int64_t d = 1; d <= cm; ++d) {
      const int64_t tail = (ss[d + 1] + excess_s) - d * cs[d + 1];
      const int64_t tiles = (total_d - (sd[d + 1] + excess_d)) + d * cd[d + 1];
      const double cost = tiles * tile_ns + tail * spill_ns;
      // formats/sell8d._cost_cap's budget: a fitting cap beats any other
      const bool f = budget >= 0 && tail <= budget;
      if ((f && !fits) || (f == fits && cost < best)) {
        best = cost; cap = static_cast<int>(d); fits = f;
      }
    }
  }

  // --- pair-level spill (round 4, formats/sell8d._pair_spill_set) --------
  // pairs whose whole kept payload costs less as XLA stragglers than as
  // tiles drop entirely (isolated scattered links — the webbase Zipf
  // tail — otherwise pay a 1024-slot tile for 1-3 nonzeros); budgeted
  // within max_spill after the rank tail, best win first.
  std::vector<uint8_t> pair_drop;
  {
    std::vector<int32_t> pkept(dmax.size(), 0);
    std::vector<int64_t> tail_r(ranges.size(), 0);
    par_for([&](size_t ri) {
      int64_t tail = 0;
      for (int64_t r = ranges[ri].first; r < ranges[ri].second; ++r) {
        const int64_t slice = r >> 10;
        for (int64_t p = rowptr[r]; p < rowptr[r + 1]; ++p)
          if (grank[p] == gsize[p] - 1) {
            const int64_t pr = slice * nb + (colidx[p] >> (10 + lb));
            const int64_t kept =
                std::min<int64_t>(gsize[p], cap);
            pkept[pr] += static_cast<int32_t>(kept);
            tail += gsize[p] - kept;
          }
      }
      tail_r[ri] = tail;
    });
    int64_t tail_n = 0;
    for (int64_t t : tail_r) tail_n += t;
    int64_t budget =
        static_cast<int64_t>(max_spill * static_cast<double>(nnz)) - tail_n;
    if (budget > 0) {
      // (win, pair) candidates, best win first, deterministic tie-break
      std::vector<std::pair<double, int64_t>> cands;
      for (size_t pr = 0; pr < dmax.size(); ++pr) {
        if (dmax[pr] <= 0) continue;
        const int64_t d = std::min<int64_t>(dmax[pr], cap);
        if (pkept[pr] * pair_spill_ns < d * tile_ns)
          cands.emplace_back(pkept[pr] * pair_spill_ns - d * tile_ns,
                             static_cast<int64_t>(pr));
      }
      if (!cands.empty()) {
        std::sort(cands.begin(), cands.end());
        pair_drop.assign(dmax.size(), 0);
        int64_t used = 0;
        bool any = false;
        for (auto& c : cands) {
          const int64_t pr = c.second;
          if (used + pkept[pr] > budget) break;   // prefix, like Python
          used += pkept[pr];
          pair_drop[pr] = 1;
          any = true;
        }
        if (!any) pair_drop.clear();
      }
    }
  }

  // --- greedy placement ---------------------------------------------------
  // parallel per slice-range: cell keys embed the pair id, so per-range
  // CellMaps (sized to the range, cache-resident) decide EXACTLY like the
  // old single whole-nnz map (which thrashed DRAM at 32M nnz)
  auto* buf = new Sell8dBuffer();
  buf->cap = cap;
  std::vector<int32_t> pair_maxd(dmax.size(), -1);   // realized max depth
  const int64_t maxd_stride = 2 * static_cast<int64_t>(cap) + 80;
  std::vector<int64_t> e_pair(nnz), e_depth(nnz);
  std::vector<int8_t> e_keep(nnz, 0);
  const int64_t mask_words = (2 * static_cast<int64_t>(cap) + 144) / 64 + 1;
  par_for([&](size_t ri) {
  const int64_t r_lo = ranges[ri].first, r_hi = ranges[ri].second;
  CellMap cells(static_cast<size_t>(rowptr[r_hi] - rowptr[r_lo]) + 16);
  // per-row scratch: bundle -> index into the row's used-depth bitsets
  std::vector<int32_t> mask_idx(static_cast<size_t>(nb), -1);
  std::vector<uint64_t> masks;          // row-local arena
  std::vector<int64_t> touched;
  for (int64_t r = r_lo; r < r_hi; ++r) {
    const int64_t p0 = rowptr[r], p1 = rowptr[r + 1];
    if (p0 == p1) continue;
    masks.clear();
    touched.clear();
    const int i_sub = static_cast<int>((r & 1023) >> 7);
    for (int64_t p = p0; p < p1; ++p) {
      if (grank[p] >= cap) continue;                // rank tail -> spill
      const int64_t c = colidx[p];
      const int64_t b = c >> (10 + lb);
      const int64_t pr = (r >> 10) * nb + b;
      if (!pair_drop.empty() && pair_drop[pr]) continue;  // pair spill
      const int64_t budget = std::min<int64_t>(dmax[pr], cap);
      const int rres = static_cast<int>(c & 127);
      // cell agreement value: classic shares s per (i, r) cell; cell_w
      // shares (s, w) jointly — 6 bits, fits the int8 cell slot
      int8_t s_want = static_cast<int8_t>((c >> 7) & 7);
      if (cell_w && lb)
        s_want = static_cast<int8_t>(s_want |
                                     (((c >> 10) & (nw - 1)) << 3));
      if (mask_idx[b] < 0) {
        mask_idx[b] = static_cast<int32_t>(masks.size() / mask_words);
        masks.resize(masks.size() + mask_words, 0);
        touched.push_back(b);
      }
      uint64_t* used = &masks[static_cast<size_t>(mask_idx[b]) * mask_words];
      int64_t d = (grank[p] + r) % budget;
      int64_t placed = -1;
      for (int64_t probe = 0; probe < budget; ++probe) {
        if (!(used[d >> 6] >> (d & 63) & 1)) {
          const int64_t key =
              (pr * maxd_stride + d) * kWindow + i_sub * kLanes + rres;
          int8_t* cell = cells.probe(key);
          if (*cell == -1 || *cell == s_want) {
            *cell = s_want;
            placed = d;
            break;
          }
        }
        d = (d + 1) % budget;
      }
      if (placed < 0) {
        // overflow levels above the budget
        const int64_t hi = std::min<int64_t>(budget + 64, mask_words * 64);
        for (d = budget; d < hi; ++d) {
          if (used[d >> 6] >> (d & 63) & 1) continue;
          const int64_t key =
              (pr * maxd_stride + d) * kWindow + i_sub * kLanes + rres;
          int8_t* cell = cells.probe(key);
          if (*cell == -1 || *cell == s_want) {
            *cell = s_want;
            placed = d;
            break;
          }
        }
      }
      if (placed < 0) continue;                     // pathological -> spill
      used[placed >> 6] |= 1ull << (placed & 63);
      e_keep[p] = 1;
      e_pair[p] = pr;
      e_depth[p] = placed;
      if (placed > pair_maxd[pr]) pair_maxd[pr] = static_cast<int32_t>(placed);
    }
    for (int64_t b : touched) mask_idx[b] = -1;
  }
  });

  // --- layout: per-pair runs, per-slice G padding -------------------------
  std::vector<int64_t> slice_tiles(nslices, 0);
  for (size_t pr = 0; pr < pair_maxd.size(); ++pr)
    if (pair_maxd[pr] >= 0)
      slice_tiles[pr / nb] += pair_maxd[pr] + 1;
  std::vector<int64_t> slice_base(nslices + 1, 0);
  int64_t ntiles = 0;
  std::vector<int64_t> slice_padded(nslices, 0);
  for (int64_t s = 0; s < nslices; ++s) {
    int64_t t = ((slice_tiles[s] + g - 1) / g) * g;
    if (t < g) t = g;
    slice_padded[s] = t;
    slice_base[s] = ntiles;
    ntiles += t;
  }
  slice_base[nslices] = ntiles;
  // pair base offsets within slices (pair ids ascending = slice-major)
  std::vector<int64_t> pair_base(pair_maxd.size(), -1);
  {
    std::vector<int64_t> run(nslices, 0);
    for (size_t pr = 0; pr < pair_maxd.size(); ++pr) {
      if (pair_maxd[pr] < 0) continue;
      const int64_t s = pr / nb;
      pair_base[pr] = slice_base[s] + run[s];
      run[s] += pair_maxd[pr] + 1;
    }
  }

  buf->ntiles = ntiles;
  buf->tinfo.assign(ntiles, 0);
  for (size_t pr = 0; pr < pair_maxd.size(); ++pr) {
    if (pair_maxd[pr] < 0) continue;
    const int32_t w = static_cast<int32_t>(pr % nb) << 3;
    for (int64_t t = 0; t <= pair_maxd[pr]; ++t)
      buf->tinfo[pair_base[pr] + t] = w;
  }
  const int64_t nsteps = ntiles / g;
  buf->ginfo.assign(nsteps, 0);
  {
    int64_t step = 0;
    for (int64_t s = 0; s < nslices; ++s) {
      const int64_t k = slice_padded[s] / g;
      for (int64_t j = 0; j < k; ++j, ++step)
        buf->ginfo[step] =
            static_cast<int32_t>((s << 1) | (j == 0 ? 1 : 0));
    }
  }
  buf->meta.assign(static_cast<size_t>(ntiles) * kWindow, 0);
  // meta writes land in the range's own slices (disjoint tile spans);
  // kept/spill indices collect per range and concatenate in range order so
  // the output ordering matches the sequential pass exactly
  std::vector<std::vector<int64_t>> kept_r(ranges.size()),
      slot_r(ranges.size()), spill_r(ranges.size());
  par_for([&](size_t ri) {
    auto& kept = kept_r[ri];
    auto& slots = slot_r[ri];
    auto& spills = spill_r[ri];
    kept.reserve(rowptr[ranges[ri].second] - rowptr[ranges[ri].first]);
    slots.reserve(kept.capacity());
    for (int64_t r = ranges[ri].first; r < ranges[ri].second; ++r) {
      const int64_t p0 = rowptr[r], p1 = rowptr[r + 1];
      const int i_sub = static_cast<int>((r & 1023) >> 7);
      const int l_lane = static_cast<int>(r & 127);
      for (int64_t p = p0; p < p1; ++p) {
        if (!e_keep[p]) {
          spills.push_back(p);
          continue;
        }
        const int64_t c = colidx[p];
        const int64_t tile = pair_base[e_pair[p]] + e_depth[p];
        const int64_t base = tile * kWindow;
        const int64_t slot = base + i_sub * kLanes + l_lane;
        const int64_t cellp = base + i_sub * kLanes + (c & 127);
        uint16_t slot_bits = static_cast<uint16_t>(c & 127);
        if (lb && !cell_w)
          slot_bits |= static_cast<uint16_t>(((c >> 10) & (nw - 1)) << 10);
        buf->meta[slot] = static_cast<int16_t>(
            static_cast<uint16_t>(buf->meta[slot]) | slot_bits);
        uint16_t cell_bits = static_cast<uint16_t>(((c >> 7) & 7) << 7);
        if (lb && cell_w)
          cell_bits |= static_cast<uint16_t>(((c >> 10) & (nw - 1)) << 10);
        buf->meta[cellp] = static_cast<int16_t>(
            static_cast<uint16_t>(buf->meta[cellp]) | cell_bits);
        kept.push_back(p);
        slots.push_back(slot);
      }
    }
  });
  buf->kept_idx.reserve(nnz);
  buf->slot_flat.reserve(nnz);
  for (size_t ri = 0; ri < ranges.size(); ++ri) {
    buf->kept_idx.insert(buf->kept_idx.end(), kept_r[ri].begin(),
                         kept_r[ri].end());
    buf->slot_flat.insert(buf->slot_flat.end(), slot_r[ri].begin(),
                          slot_r[ri].end());
    buf->spill_idx.insert(buf->spill_idx.end(), spill_r[ri].begin(),
                          spill_r[ri].end());
  }
  *out_ntiles = ntiles;
  *out_nkept = static_cast<int64_t>(buf->kept_idx.size());
  *out_nspill = static_cast<int64_t>(buf->spill_idx.size());
  *out_cap = cap;
  return buf;
}

extern "C" void sell8d_copy(void* h, int32_t* tinfo, int32_t* ginfo,
                            int16_t* meta, int64_t* slot_flat,
                            int64_t* kept_idx, int64_t* spill_idx) {
  auto* buf = static_cast<Sell8dBuffer*>(h);
  std::memcpy(tinfo, buf->tinfo.data(), buf->tinfo.size() * 4);
  std::memcpy(ginfo, buf->ginfo.data(), buf->ginfo.size() * 4);
  std::memcpy(meta, buf->meta.data(), buf->meta.size() * 2);
  std::memcpy(slot_flat, buf->slot_flat.data(), buf->slot_flat.size() * 8);
  std::memcpy(kept_idx, buf->kept_idx.data(), buf->kept_idx.size() * 8);
  if (!buf->spill_idx.empty())
    std::memcpy(spill_idx, buf->spill_idx.data(),
                buf->spill_idx.size() * 8);
}

extern "C" void sell8d_free(void* h) { delete static_cast<Sell8dBuffer*>(h); }

// ---------------------------------------------------------------------------
// SELL-8D bundle-width statistics (estimate_sell8d_auto's hot loop): for
// each nw in {1,2,4,8}, the cost-model depth cap, the budget tile count
// Σ_pairs min(dmax, cap), and the rank-tail spill.  One pass over nnz per
// width; no per-entry arrays.
// ---------------------------------------------------------------------------
extern "C" void sell8d_stats(int64_t m, int64_t n, const int32_t* rowptr,
                             const int32_t* colidx, const double* tile_ns,
                             double spill_ns, double pair_spill_ns,
                             double max_spill, int cap_within_gate,
                             int64_t* out_tiles,
                             int64_t* out_cap, int64_t* out_spill) {
  const int64_t nnz_total = rowptr[m];
  for (int wi = 0; wi < 4; ++wi) {
    const int lb = wi;                       // nw = 1,2,4,8
    const int64_t bcols = static_cast<int64_t>(kWindow) << lb;
    const int64_t nb = std::max<int64_t>((n + bcols - 1) / bcols, 1);
    const int64_t nslices = std::max<int64_t>((m + kWindow - 1) / kWindow,
                                              1);
    std::vector<int32_t> dmax(static_cast<size_t>(nslices) * nb, 0);
    // per-pair total nnz — the pair-level spill rule needs it after the
    // cap is chosen (kept = min(sum, sum − tail); tails recomputed below)
    std::vector<int64_t> psum(static_cast<size_t>(nslices) * nb, 0);
    // size histogram built on the fly (group sizes via per-row counters)
    const int64_t cm = 1024;
    std::vector<int64_t> hs(cm + 2, 0);
    int64_t excess_s = 0;
    {
      std::vector<int32_t> cnt(static_cast<size_t>(nb), 0);
      std::vector<int64_t> touched;
      for (int64_t r = 0; r < m; ++r) {
        const int64_t p0 = rowptr[r], p1 = rowptr[r + 1];
        if (p0 == p1) continue;
        touched.clear();
        for (int64_t p = p0; p < p1; ++p) {
          const int64_t b = colidx[p] >> (10 + lb);
          if (cnt[b]++ == 0) touched.push_back(b);
        }
        const int64_t slice = r >> 10;
        for (int64_t b : touched) {
          const int64_t s = cnt[b];
          const int64_t pr = slice * nb + b;
          if (s > dmax[pr]) dmax[pr] = static_cast<int32_t>(s);
          psum[pr] += s;
          if (s > cm + 1) { excess_s += s - (cm + 1); ++hs[cm + 1]; }
          else ++hs[s];
          cnt[b] = 0;
        }
      }
    }
    std::vector<int64_t> hd(cm + 2, 0);
    int64_t excess_d = 0;
    for (size_t pr = 0; pr < dmax.size(); ++pr)
      if (dmax[pr] > 0) {
        int64_t d = dmax[pr];
        if (d > cm + 1) { excess_d += d - (cm + 1); d = cm + 1; }
        ++hd[d];
      }
    std::vector<int64_t> cs(cm + 3, 0), ss(cm + 3, 0), cd(cm + 3, 0),
        sd(cm + 3, 0);
    for (int64_t i = cm + 1; i >= 0; --i) {
      cs[i] = cs[i + 1] + hs[i];
      ss[i] = ss[i + 1] + hs[i] * i;
      cd[i] = cd[i + 1] + hd[i];
      sd[i] = sd[i + 1] + hd[i] * i;
    }
    const int64_t total_d = sd[0] + excess_d;
    const int64_t cap_budget = cap_within_gate
        ? static_cast<int64_t>(max_spill * static_cast<double>(nnz_total))
        : -1;
    double best = 1e300;
    bool fits = false;
    int64_t bcap = 1, btiles = 0, bspill = 0;
    for (int64_t d = 1; d <= cm; ++d) {
      const int64_t tail = (ss[d + 1] + excess_s) - d * cs[d + 1];
      const int64_t tiles =
          (total_d - (sd[d + 1] + excess_d)) + d * cd[d + 1];
      const double cost = tiles * tile_ns[wi] + tail * spill_ns;
      const bool f = cap_budget >= 0 && tail <= cap_budget;
      if ((f && !fits) || (f == fits && cost < best)) {
        best = cost;
        fits = f;
        bcap = d;
        btiles = tiles;
        bspill = tail;
      }
    }
    // pair-level spill adjustment (round 4, see sell8d_pack): pairs with
    // dmax ≤ cap (kept == psum exactly there) whose payload is cheaper
    // as stragglers, best win first within the max_spill budget
    int64_t budget =
        static_cast<int64_t>(max_spill * static_cast<double>(nnz_total))
        - bspill;
    if (budget > 0) {
      std::vector<std::pair<double, int64_t>> cands;
      for (size_t pr = 0; pr < dmax.size(); ++pr) {
        const int64_t d = dmax[pr];
        if (d <= 0 || d > bcap) continue;
        if (psum[pr] * pair_spill_ns < d * tile_ns[wi])
          cands.emplace_back(psum[pr] * pair_spill_ns - d * tile_ns[wi],
                             static_cast<int64_t>(pr));
      }
      std::sort(cands.begin(), cands.end());
      for (auto& c : cands) {
        const int64_t pr = c.second;
        if (psum[pr] > budget) break;
        budget -= psum[pr];
        bspill += psum[pr];
        btiles -= std::min<int64_t>(dmax[pr], bcap);
      }
    }
    out_tiles[wi] = btiles;
    out_cap[wi] = bcap;
    out_spill[wi] = bspill;
  }
}
