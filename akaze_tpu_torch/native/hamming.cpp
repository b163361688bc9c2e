// Host-side brute-force Hamming matcher over packed uint32 descriptors.
//
// Native counterpart of akaze_tpu/matching/hamming.py (same semantics:
// argmin popcount(xor), Lowe ratio, mutual-best, absolute distance gate).
// The reference implements this path natively too (Rust, SURVEY.md §3.4);
// here it serves the host runtime: the single-core CPU baseline measurement
// for BASELINE.md and a low-latency fallback for host-driven SfM loops when
// descriptor sets are tiny (device dispatch would dominate).
//
// Built on demand with g++ -O3 (see akaze_tpu/native/__init__.py); exposed
// through a plain C ABI consumed via ctypes — no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int hamming(const uint32_t* a, const uint32_t* b, int words) {
  int d = 0;
  for (int w = 0; w < words; ++w) {
    d += __builtin_popcount(a[w] ^ b[w]);
  }
  return d;
}

}  // namespace

extern "C" {

// For each row of `a` (na x words): best match in `b` (nb x words).
// Outputs (size na): out_idx (best b index), out_dist (best distance),
// out_accepted (1 if ratio/mutual/max_distance filters all passed).
// Returns the number of accepted matches.
int akaze_match_hamming(const uint32_t* a, int na, const uint32_t* b, int nb,
                        int words, float ratio, int mutual, int max_distance,
                        int32_t* out_idx, int32_t* out_dist,
                        uint8_t* out_accepted) {
  if (na <= 0 || nb <= 0) return 0;
  std::vector<int32_t> nn_b(na, -1), best(na, INT32_MAX), second(na, INT32_MAX);
  for (int i = 0; i < na; ++i) {
    const uint32_t* ai = a + static_cast<size_t>(i) * words;
    int32_t b1 = INT32_MAX, b2 = INT32_MAX, bi = -1;
    for (int j = 0; j < nb; ++j) {
      int d = hamming(ai, b + static_cast<size_t>(j) * words, words);
      if (d < b1) {
        b2 = b1;
        b1 = d;
        bi = j;
      } else if (d < b2) {
        b2 = d;
      }
    }
    nn_b[i] = bi;
    best[i] = b1;
    second[i] = b2;
  }
  std::vector<int32_t> nn_a;
  if (mutual) {
    nn_a.assign(nb, -1);
    std::vector<int32_t> bbest(nb, INT32_MAX);
    for (int j = 0; j < nb; ++j) {
      const uint32_t* bj = b + static_cast<size_t>(j) * words;
      for (int i = 0; i < na; ++i) {
        int d = hamming(a + static_cast<size_t>(i) * words, bj, words);
        if (d < bbest[j]) {
          bbest[j] = d;
          nn_a[j] = i;
        }
      }
    }
  }
  int accepted = 0;
  for (int i = 0; i < na; ++i) {
    out_idx[i] = nn_b[i];
    out_dist[i] = best[i];
    bool ok = best[i] <= max_distance &&
              static_cast<float>(best[i]) < ratio * static_cast<float>(second[i]);
    if (mutual && ok) ok = nn_a[nn_b[i]] == i;
    out_accepted[i] = ok ? 1 : 0;
    accepted += ok ? 1 : 0;
  }
  return accepted;
}

}  // extern "C"
