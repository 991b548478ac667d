// First-party 4-bit block-adaptive ADPCM wire encoder (host side).
//
// Mirror of chinese_asr_tpu/audio/features.py adpcm_encode_flat — the
// integer state machine MUST stay bit-identical to the numpy reference
// and to the device decode scan (features.adpcm_decode_flat); parity is
// pinned by tests/test_wire.py.  The numpy encoder costs ~1 s/batch at
// the offline bench size (256 python-level vector steps); this kernel
// runs the same math cache-blocked: groups of 64 blocks (32 KB of PCM,
// L1-resident) with a data-parallel inner lane loop the compiler can
// vectorize (no cross-block dependencies).
//
// Wire layout (uint8, nb = n / 256 blocks):
//   [0,   nb) predictor lo byte      (initial predictor = last original
//   [nb, 2nb) predictor hi byte       sample of the previous block)
//   [2nb,3nb) initial step index
//   [3nb, ..) nibbles as a [128, nb] matrix: byte (j, b) holds codes
//             (2j, 2j+1) of block b in (lo, hi) nibble order.

#include <algorithm>
#include <cstdint>

namespace {

constexpr int K = 256;        // samples per block (features.ADPCM_K)
constexpr int IDX_MAX = 95;

inline int32_t step_of(int32_t idx) {
  return (8 + (idx & 7)) << (idx >> 3);
}

}  // namespace

extern "C" void adpcm_encode_i16(const int16_t* x, int64_t n, uint8_t* out) {
  const int64_t nb = n / K;
  uint8_t* lo = out;
  uint8_t* hi = out + nb;
  uint8_t* ix = out + 2 * nb;
  uint8_t* nib = out + 3 * nb;

  // step table for the integer initial-index search (lower_bound ==
  // numpy searchsorted side='left')
  int32_t table[IDX_MAX + 1];
  for (int i = 0; i <= IDX_MAX; ++i) table[i] = step_of(i);

  constexpr int G = 64;       // blocks per cache-resident group
  int32_t pred[G], idx[G];
  uint8_t codes[K][G];

  for (int64_t b0 = 0; b0 < nb; b0 += G) {
    const int g = static_cast<int>(std::min<int64_t>(G, nb - b0));
    for (int b = 0; b < g; ++b) {
      const int64_t blk = b0 + b;
      const int16_t* xb = x + blk * K;
      const int32_t p0 = blk ? static_cast<int32_t>(xb[-1]) : 0;
      int64_t acc = 0;        // sum |first difference| over the block
      int32_t prev = p0;
      for (int t = 0; t < K; ++t) {
        const int32_t v = xb[t];
        acc += v > prev ? v - prev : prev - v;
        prev = v;
      }
      // initial step ~ 2 * mean|diff| (pure integer: acc >> 7 == 2*mean
      // for K = 256), exact mirror of the numpy searchsorted
      const int32_t target =
          static_cast<int32_t>(std::max<int64_t>(acc >> 7, 8));
      const int32_t i0 = static_cast<int32_t>(
          std::lower_bound(table, table + IDX_MAX + 1,
                           std::min(target, table[IDX_MAX])) - table);
      pred[b] = p0;
      idx[b] = i0;
      lo[blk] = static_cast<uint8_t>(p0 & 255);
      hi[blk] = static_cast<uint8_t>((p0 >> 8) & 255);
      ix[blk] = static_cast<uint8_t>(i0);
    }
    for (int t = 0; t < K; ++t) {
      for (int b = 0; b < g; ++b) {
        const int32_t s = x[(b0 + b) * K + t];
        const int32_t st = step_of(idx[b]);
        const int32_t diff = s - pred[b];
        const int32_t sign = diff < 0;
        const int32_t ad = sign ? -diff : diff;
        const int32_t mag = std::min((ad << 2) / st, 7);
        const int32_t dq = ((2 * mag + 1) * st) >> 3;
        pred[b] = std::min(std::max(pred[b] + (sign ? -dq : dq), -32768),
                           32767);
        idx[b] = std::min(std::max(idx[b] + (mag < 4 ? -1 : 2 * (mag - 3)),
                                   0), IDX_MAX);
        codes[t][b] = static_cast<uint8_t>((sign << 3) | mag);
      }
    }
    for (int j = 0; j < K / 2; ++j) {
      uint8_t* row = nib + static_cast<int64_t>(j) * nb + b0;
      for (int b = 0; b < g; ++b)
        row[b] = static_cast<uint8_t>(codes[2 * j][b] |
                                      (codes[2 * j + 1][b] << 4));
    }
  }
}
