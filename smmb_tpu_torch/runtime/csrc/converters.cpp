// smmb_tpu native runtime: format constructors (host-side preprocessing).
//
// TPU-native equivalents of the reference's C constructors — same contracts,
// re-designed for multicore hosts feeding TPU jobs:
//   - tcsc_from_dense        (ref: the reference's sparse/tcsc.c:6-66)
//   - bcsr_from_dense        (ref: the reference's sparse/bcsr.c:19-139,
//                             with the all-zero-block-row bug fixed)
//   - pack_ternary           (net-new: the 2-bit group-strided execution
//                             format of smmb_tpu/formats/packed.py)
//
// All functions use exact ±1.0f compares like the reference
// (the reference's sparse/tcsc.c:54-57). Parallelized with OpenMP over
// columns/groups — unlike the reference's single-threaded constructors, these
// run while the previous batch executes on the TPU, so conversion never sits
// on the critical path.
//
// Exposed as a plain C ABI consumed via ctypes (smmb_tpu/runtime/native.py).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------- TCSC

// Pass 1: count +1/-1 entries per column; fills col_start_{pos,neg}
// (cols+1 each, exclusive prefix) and returns totals via out params.
void tcsc_count(const float* w, int64_t rows, int64_t cols,
                int32_t* col_start_pos, int32_t* col_start_neg,
                int64_t* n_pos, int64_t* n_neg) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < cols; ++j) {
    int32_t cp = 0, cn = 0;
    for (int64_t i = 0; i < rows; ++i) {
      float v = w[i * cols + j];
      cp += (v == 1.0f);
      cn += (v == -1.0f);
    }
    col_start_pos[j + 1] = cp;  // per-column counts; prefixed below
    col_start_neg[j + 1] = cn;
  }
  col_start_pos[0] = 0;
  col_start_neg[0] = 0;
  for (int64_t j = 0; j < cols; ++j) {
    col_start_pos[j + 1] += col_start_pos[j];
    col_start_neg[j + 1] += col_start_neg[j];
  }
  *n_pos = col_start_pos[cols];
  *n_neg = col_start_neg[cols];
}

// Pass 2: fill row_index planes (sized by tcsc_count's totals). Column-major
// append order — the reference's layout contract.
void tcsc_fill(const float* w, int64_t rows, int64_t cols,
               const int32_t* col_start_pos, const int32_t* col_start_neg,
               int32_t* row_index_pos, int32_t* row_index_neg) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < cols; ++j) {
    int32_t p = col_start_pos[j], n = col_start_neg[j];
    for (int64_t i = 0; i < rows; ++i) {
      float v = w[i * cols + j];
      if (v == 1.0f) row_index_pos[p++] = (int32_t)i;
      else if (v == -1.0f) row_index_neg[n++] = (int32_t)i;
    }
  }
}

// ---------------------------------------------------------------- packed 2-bit

// Group-strided 2-bit packing (layout: smmb_tpu/formats/packed.py).
// out is int8[pad_rows/4, cols]; pad_rows must be a multiple of 512 and
// >= rows; logical rows >= `rows` are zero.
void pack_ternary(const float* w, int64_t rows, int64_t cols,
                  int64_t pad_rows, int8_t* out) {
  const int64_t SUBL = 128, GROUP = 512;
  const int64_t groups = pad_rows / GROUP;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t g = 0; g < groups; ++g) {
    for (int64_t p = 0; p < SUBL; ++p) {
      int8_t* dst = out + (g * SUBL + p) * cols;
      for (int64_t n = 0; n < cols; ++n) {
        uint8_t byte = 0;
        for (int64_t f = 0; f < 4; ++f) {
          int64_t i = g * GROUP + f * SUBL + p;
          if (i < rows) {
            float v = w[i * cols + n];
            uint8_t code = (v == 1.0f) ? 1u : (v == -1.0f) ? 3u : 0u;
            byte |= (uint8_t)(code << (2 * f));
          }
        }
        dst[n] = (int8_t)byte;
      }
    }
  }
}

// ---------------------------------------------------------------- BCSR

// Pass 1: mark blocks containing any exact ±1; returns block count and fills
// b_row_start (br+1, cumulative — correct for all-zero block rows, unlike
// the reference's sparse/bcsr.c:101-117).
int64_t bcsr_count(const float* w, int64_t rows, int64_t cols,
                   int64_t r, int64_t c, int32_t* b_row_start,
                   uint8_t* valid /* br*bc scratch */) {
  const int64_t br = rows / r, bc = cols / c;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t bi = 0; bi < br; ++bi) {
    for (int64_t bj = 0; bj < bc; ++bj) {
      uint8_t hit = 0;
      for (int64_t i = bi * r; i < (bi + 1) * r && !hit; ++i)
        for (int64_t j = bj * c; j < (bj + 1) * c; ++j) {
          float v = w[i * cols + j];
          if (v == 1.0f || v == -1.0f) { hit = 1; break; }
        }
      valid[bi * bc + bj] = hit;
    }
  }
  b_row_start[0] = 0;
  for (int64_t bi = 0; bi < br; ++bi) {
    int32_t cnt = 0;
    for (int64_t bj = 0; bj < bc; ++bj) cnt += valid[bi * bc + bj];
    b_row_start[bi + 1] = b_row_start[bi] + cnt;
  }
  return b_row_start[br];
}

// Pass 2: fill b_col_idx (k) and b_values (k*r*c) in row-major block order.
void bcsr_fill(const float* w, int64_t rows, int64_t cols,
               int64_t r, int64_t c, const int32_t* b_row_start,
               const uint8_t* valid, int32_t* b_col_idx, float* b_values) {
  const int64_t br = rows / r, bc = cols / c;
#pragma omp parallel for schedule(static)
  for (int64_t bi = 0; bi < br; ++bi) {
    int64_t k = b_row_start[bi];
    for (int64_t bj = 0; bj < bc; ++bj) {
      if (!valid[bi * bc + bj]) continue;
      b_col_idx[k] = (int32_t)bj;
      float* dst = b_values + k * r * c;
      for (int64_t i = 0; i < r; ++i)
        for (int64_t j = 0; j < c; ++j)
          dst[i * c + j] = w[(bi * r + i) * cols + (bj * c + j)];
      ++k;
    }
  }
}

int omp_thread_count() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// --------------------------------------------------------------- data loader
// Training-corpus batching (smmb_tpu/runtime/data.py): the corpus is a flat
// uint32 token file the Python side memory-maps; the native layer supplies
// the two hot host-side steps — a deterministic epoch permutation (seeded
// splitmix64 Fisher-Yates; tens of millions of windows in milliseconds) and
// the OpenMP window gather into the batch buffer (parallel strided copies
// the GIL would otherwise serialize).

static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// out[0..n): a permutation of 0..n-1, deterministic in seed.
void shuffle_offsets(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(splitmix64(&s) % (uint64_t)(i + 1));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Gather b windows of w tokens each from the mmap'd corpus into out
// (int32, row-major b*w). starts are element offsets (caller bounds them).
void gather_windows(const uint32_t* corpus, const int64_t* starts,
                    int64_t b, int64_t w, int32_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < b; ++i) {
    const uint32_t* src = corpus + starts[i];
    int32_t* dst = out + i * w;
    for (int64_t t = 0; t < w; ++t) dst[t] = (int32_t)src[t];
  }
}

}  // extern "C"
