// First-party edit-distance kernel (replaces the reference's third-party
// python-Levenshtein C extension; reference util.py:9, 237-262).
//
// Operates on int32 codepoint arrays so Python hands over raw buffers once
// instead of re-encoding per call.  Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Levenshtein distance between two codepoint sequences.
int32_t edit_distance_i32(const int32_t* a, int32_t na,
                          const int32_t* b, int32_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int32_t> dist(nb + 1);
  for (int32_t j = 0; j <= nb; ++j) dist[j] = j;
  for (int32_t i = 1; i <= na; ++i) {
    int32_t pre = i;  // dist[i][0]
    int32_t cur = i;
    for (int32_t j = 1; j <= nb; ++j) {
      if (a[i - 1] == b[j - 1]) {
        cur = dist[j - 1];
      } else {
        cur = std::min({pre, dist[j], dist[j - 1]}) + 1;
      }
      dist[j - 1] = pre;
      pre = cur;
    }
    dist[nb] = cur;
  }
  return dist[nb];
}

// Batched CER: sequences packed back to back with offset tables
// (offsets have n+1 entries).  Writes per-pair distance / len(ref) into out.
void batch_cer_i32(const int32_t* preds, const int64_t* pred_offsets,
                   const int32_t* refs, const int64_t* ref_offsets,
                   int32_t n, double* out) {
  for (int32_t i = 0; i < n; ++i) {
    const int32_t* p = preds + pred_offsets[i];
    const int32_t np = static_cast<int32_t>(pred_offsets[i + 1] - pred_offsets[i]);
    const int32_t* r = refs + ref_offsets[i];
    const int32_t nr = static_cast<int32_t>(ref_offsets[i + 1] - ref_offsets[i]);
    const int32_t d = edit_distance_i32(p, np, r, nr);
    out[i] = nr > 0 ? static_cast<double>(d) / nr : (np > 0 ? 1.0 : 0.0);
  }
}

}  // extern "C"
