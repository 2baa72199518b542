// Native data-plane kernels for any4: multithreaded host-side weight
// preparation (group quantization + planar nibble packing) used when
// converting multi-GB checkpoints. The device compute path is JAX/Pallas;
// this covers the CPU side the reference implements inside its CUDA
// extension's host code and Python quantizers (tinygemm_lib/utils.py:27-67,
// TinyGemmConvertB.cu) -- re-designed for the planar layout
// (any4/ops/packing.py).
//
// Build: cc -O3 -march=native -shared -fPIC -fopenmp (see __init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
constexpr int kPackBlock = 1024;  // k per planar block
constexpr int kPlanes = 8;        // nibbles per int32
constexpr int kLanes = 128;       // plane width

inline int64_t padded_k(int64_t k) {
  return (k + kPackBlock - 1) / kPackBlock * kPackBlock;
}
}  // namespace

extern "C" {

// Planar-pack 4-bit codes [n, k] (values 0..15) into int32 [n, kp/8].
// `shards` > 1 packs contiguous k-shards independently (row-parallel TP).
// out must hold n * (shards * padded_k(k/shards) / 8) int32.
void pack_int4_planar(const uint8_t* codes, int32_t* out, int64_t n,
                      int64_t k, int64_t shards) {
  const int64_t ks = k / shards;
  const int64_t kps = padded_k(ks);
  const int64_t words_per_shard = kps / kPlanes;
  const int64_t words_total = shards * words_per_shard;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = codes + r * k;
    int32_t* orow = out + r * words_total;
    std::memset(orow, 0, words_total * sizeof(int32_t));
    for (int64_t s = 0; s < shards; ++s) {
      const uint8_t* src = row + s * ks;
      int32_t* dst = orow + s * words_per_shard;
      for (int64_t kb = 0; kb * kPackBlock < ks; ++kb) {
        const int64_t base = kb * kPackBlock;
        const int64_t limit = std::min<int64_t>(ks - base, kPackBlock);
        int32_t* wblock = dst + kb * kLanes;
        for (int64_t j = 0; j < kPlanes; ++j) {
          const int64_t off = j * kLanes;
          if (off >= limit) break;
          const int64_t span = std::min<int64_t>(limit - off, kLanes);
          for (int64_t l = 0; l < span; ++l) {
            wblock[l] |= static_cast<int32_t>(src[base + off + l] & 0xF)
                         << (4 * j);
          }
        }
      }
    }
  }
}

// Inverse of pack_int4_planar: int32 [n, words] -> codes [n, k].
void unpack_int4_planar(const int32_t* packed, uint8_t* out, int64_t n,
                        int64_t k, int64_t shards) {
  const int64_t ks = k / shards;
  const int64_t kps = padded_k(ks);
  const int64_t words_per_shard = kps / kPlanes;
  const int64_t words_total = shards * words_per_shard;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const int32_t* prow = packed + r * words_total;
    uint8_t* orow = out + r * k;
    for (int64_t s = 0; s < shards; ++s) {
      const int32_t* src = prow + s * words_per_shard;
      uint8_t* dst = orow + s * ks;
      for (int64_t i = 0; i < ks; ++i) {
        const int64_t kb = i / kPackBlock;
        const int64_t within = i % kPackBlock;
        const int64_t j = within / kLanes;
        const int64_t l = within % kLanes;
        dst[i] = (static_cast<uint32_t>(src[kb * kLanes + l]) >> (4 * j))
                 & 0xF;
      }
    }
  }
}

// Asymmetric per-group uniform quantization of f32 weights [n, k]:
// scales=(max-min)/(2^bits-1) clamped at 1e-6, zeros=min+scales*2^(bits-1),
// codes=round((w-min)/scales) in [0, 2^bits-1]. Matches
// any4/ops/quant.py group_quantize (reference
// tinygemm_lib/utils.py:27-67).
void group_quantize_f32(const float* w, int64_t n, int64_t k,
                        int64_t group_size, int bits, uint8_t* codes,
                        float* scales, float* zeros) {
  const int64_t groups = k / group_size;
  const float max_int = static_cast<float>((1 << bits) - 1);
  const float half = static_cast<float>(1 << (bits - 1));
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const float* row = w + r * k;
    for (int64_t g = 0; g < groups; ++g) {
      const float* seg = row + g * group_size;
      float mn = seg[0], mx = seg[0];
      for (int64_t i = 1; i < group_size; ++i) {
        mn = std::min(mn, seg[i]);
        mx = std::max(mx, seg[i]);
      }
      float scale = std::max(mx - mn, 1e-6f) / max_int;
      scales[r * groups + g] = scale;
      zeros[r * groups + g] = mn + scale * half;
      uint8_t* crow = codes + r * k + g * group_size;
      for (int64_t i = 0; i < group_size; ++i) {
        // true division, not multiply-by-reciprocal: the jnp reference
        // divides, and the last-ULP difference flips codes at rounding
        // boundaries (observed ~1e-5 of elements at checkpoint scale)
        float q = std::nearbyint((seg[i] - mn) / scale);
        q = std::min(std::max(q, 0.0f), max_int);
        crow[i] = static_cast<uint8_t>(q);
      }
    }
  }
}

// Nearest-entry assignment against a per-row 16-entry LUT (the any4
// encode step once LUTs are learned): wg [n, k] group-normalized values,
// lut [n, 16] -> codes [n, k].
void lut_assign_rows(const float* wg, const float* lut, uint8_t* codes,
                     int64_t n, int64_t k) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const float* row = wg + r * k;
    const float* t = lut + r * 16;
    uint8_t* crow = codes + r * k;
    for (int64_t i = 0; i < k; ++i) {
      float best = 1e30f;
      int bi = 0;
      for (int c = 0; c < 16; ++c) {
        float d = std::fabs(row[i] - t[c]);
        if (d < best) {
          best = d;
          bi = c;
        }
      }
      crow[i] = static_cast<uint8_t>(bi);
    }
  }
}

// bf16 (raw uint16) -> f32 widening, used when streaming safetensors
// shards without torch.
void bf16_to_f32(const uint16_t* src, float* dst, int64_t count) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
    std::memcpy(&dst[i], &bits, sizeof(float));
  }
}

int native_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
