// Host-side fused affine uint16 quantizer for the host-to-card payloads
// (--quantize serving, --quantize-transfer training), and the uint8 mask
// codec. A copy of plumekit/native/quant.cpp. The numpy codec
// (plumekit_torch/ops/quant.py) makes seven passes and four temporaries;
// this one makes two passes and none: (1) fused per-channel min/max and
// finiteness scan, (2) quantize straight into the caller's uint16 buffer.
//
// Bit-exactness with the numpy path is part of the contract (tested in
// tests/test_torch_native.py): all arithmetic is IEEE float32 in the same
// order -- lo = min, scale = max(hi-lo, 1e-12f)/65535.0f, q =
// rint((v-lo)/scale) with round-half-to-even (nearbyintf under the default
// rounding mode, matching np.round). No -ffast-math anywhere in the build
// for this reason.
//
// C ABI, loaded with ctypes; built together with ccl.cpp by
// plumekit_torch/native/build.py.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// in: row-major (n, c) float32. out: (n, c) uint16. lo/scale: (c,) float32.
// Returns 0 on success, -1 if any value is non-finite (out/lo/scale then
// undefined; the Python wrapper raises the codec's documented ValueError).
int32_t plumekit_quantize_uint16(const float* in, int64_t n, int32_t c,
                                 uint16_t* out, float* lo, float* scale) {
  std::vector<float> mn(c, FLT_MAX), mx(c, -FLT_MAX);
  uint32_t nonfinite = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* row = in + i * c;
    for (int32_t ch = 0; ch < c; ++ch) {
      float v = row[ch];
      // exponent-all-ones <=> inf or nan; branch-free so the scan stays
      // vectorizable (NaN also slips past the min/max compares below,
      // so the flag — not the accumulators — is the detector)
      uint32_t bits;
      __builtin_memcpy(&bits, &v, 4);
      nonfinite |= ((bits & 0x7f800000u) == 0x7f800000u);
      mn[ch] = v < mn[ch] ? v : mn[ch];
      mx[ch] = v > mx[ch] ? v : mx[ch];
    }
  }
  if (nonfinite) return -1;
  for (int32_t ch = 0; ch < c; ++ch) {
    lo[ch] = mn[ch];
    float span = mx[ch] - mn[ch];
    scale[ch] = (span > 1e-12f ? span : 1e-12f) / 65535.0f;
  }
  for (int64_t i = 0; i < n; ++i) {
    const float* row = in + i * c;
    uint16_t* orow = out + i * c;
    for (int32_t ch = 0; ch < c; ++ch) {
      // same-order float32 ops as the numpy path; value is in
      // [0, 65535] by construction (lo/scale come from this data)
      orow[ch] =
          (uint16_t)nearbyintf((row[ch] - lo[ch]) / scale[ch]);
    }
  }
  return 0;
}

// Label-mask codec: uint8 = rint(clip(v, 0, 1) * 255). Exact for the
// {0,1} masks every standard path produces; soft (distillation) labels
// survive to within 1/510 — same contract as train/data.quantize_samples.
void plumekit_quantize_mask_uint8(const float* in, int64_t n,
                                  uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i];
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    out[i] = (uint8_t)nearbyintf(v * 255.0f);
  }
}

}  // extern "C"
