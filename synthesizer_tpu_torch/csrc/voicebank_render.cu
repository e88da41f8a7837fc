// Fused voice-bank render for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel synthesizer_tpu/ops/kernels.py::_kernel (launched
// by render_stereo_pallas).  It computes what the reference's plain
// render_block (synthesizer_tpu/models/voicebank.py) computes for a bank
// layout, glide and the wavetable included, with render_block's formulas
// where the Pallas kernel differs from it:
//   * native uint32 DDS phase, x = f32(p) * 2^-32 (no folded int32 form);
//   * ADSR time f32(int32(n - start)) * f32(1/sr), exact past 2^24 frames;
//   * reciprocal ADSR slopes and an envelope clipped to [0, 1];
//   * pluck decay from g = cosf(pi*k*ratio);
//   * the FM offset cast saturates (__float2int_rz), as XLA's f32->i32 does.
// Wavetable voices (wave 11) gather from their 256-sample row inside the
// kernel: the TPU kernel had to leave them to an XLA side path.
//
// Design: one thread per output frame, 256 threads a block.  Each thread
// walks the groups and, inside each, the voices in packed order, and sums L
// and R serially in f32 registers; it writes one float2.  Every thread of a
// block reads the same voice's parameters at the same time, so the loads
// broadcast.  A frame's value depends only on its absolute index n and the
// parameters, never on n0 or the launch shape: the output is deterministic
// and chunk-invariant by construction (no atomics).  Built with -fmad=false
// so every multiply and add rounds as in the plain PyTorch version.
//
// What bounds it on this card: compute.  A voice-frame costs about 10-60 f32
// and integer operations (8 turn-unit sine polynomials for a harmonics
// voice, 8 hashed partials with cosf/logf/expf for a pluck voice), while a
// frame writes only 8 bytes and the parameters stay in L1.  This first
// design does nothing about that yet: it evaluates every voice at every
// frame, silent ones included, with FMA contraction off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 16;
constexpr int kTableLen = 256;

// Columns of the [V, kCols] int32 parameter matrix (f32 fields bit-cast);
// the order matches KERNEL_COLUMNS in ops/kernels.py.
enum Col {
  WAVE, BASE_INC, PHASE0, AMP, BIAS, PAN, START, GATE, ATTACK, DECAY,
  SUSTAIN, RELEASE, FM_INC, FM_PHASE0, FM_DEPTH, FM_R, FM_C0, PULSE_WIDTH,
  SEED, NOISE_HOLD, DAMPING, GLIDE_INC0, GLIDE_D, GLIDE_FRAMES, kCols
};

// (wave id or -1 for a mixed group, has_fm, first voice, voice count)
struct Groups {
  int n;
  int wid[kMaxGroups];
  int has_fm[kMaxGroups];
  int start[kMaxGroups];
  int count[kMaxGroups];
};

// f32 constants, bit-exact to the numpy values the reference uses
constexpr float kTwoNeg32 = 0x1p-32f;
constexpr float kTwoNeg23 = 0x1p-23f;
constexpr float kTwo32 = 4294967296.0f;
constexpr float kEps = 0x1.4484c0p-100f;     // f32(1e-30)
constexpr float kMinDt = 0x1.12e0bep-30f;    // f32(1e-9)
constexpr float kPi = 0x1.921fb6p+1f;        // f32(pi)

__device__ __forceinline__ float as_f32(int32_t bits) {
  return __int_as_float(bits);
}

__device__ __forceinline__ float phase_x(uint32_t p) {
  return __uint2float_rn(p) * kTwoNeg32;
}

// sin(2*pi*x), x in turns: fold to [-0.5, 0.5], odd minimax polynomial
// (coefficients of ops/trig.py, same Horner order)
__device__ __forceinline__ float sin_turns(float x) {
  const float v = x - rintf(x);
  const float v2 = v * v;
  float acc = 0x1.96cd96p+1f;
  acc = acc * v2 + -0x1.db3f4ap+3f;
  acc = acc * v2 + 0x1.501666p+5f;
  acc = acc * v2 + -0x1.32cd9cp+6f;
  acc = acc * v2 + 0x1.466b7ep+6f;
  acc = acc * v2 + -0x1.4abbcap+5f;
  acc = acc * v2 + 0x1.921fb6p+2f;
  return acc * v;
}

__device__ __forceinline__ float cos_turns(float x) {
  return sin_turns(x + 0.25f);
}

__device__ __forceinline__ uint32_t noise_u32(uint32_t idx, uint32_t seed) {
  uint32_t x = idx * 0x9E3779B9u + seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float noise(uint32_t idx, uint32_t seed) {
  return __uint2float_rn(noise_u32(idx, seed) >> 8) * kTwoNeg23 - 1.0f;
}

// m*(m-1)/2 mod 2^32: halve the even factor before the wrapped multiply
__device__ __forceinline__ uint32_t tri_u32(uint32_t m) {
  const bool even = (m & 1u) == 0u;
  const uint32_t a = even ? m >> 1 : m;
  const uint32_t b = even ? m - 1u : (m - 1u) >> 1;
  return a * b;
}

__device__ __forceinline__ float triangle(float x) {
  return x < 0.25f ? 4.0f * x : (x < 0.75f ? 2.0f - 4.0f * x : 4.0f * x - 4.0f);
}

__device__ __forceinline__ float blep(float t, float dt) {
  const float u0 = t / dt;
  const float lo = (u0 + u0) - u0 * u0 - 1.0f;
  const float u1 = (t - 1.0f) / dt;
  const float hi = u1 * u1 + (u1 + u1) + 1.0f;
  return t < dt ? lo : (t > 1.0f - dt ? hi : 0.0f);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Karplus-Strong in spectral form (spec: goldref/spec.py)
__device__ float pluck(uint32_t p, uint32_t inc, uint32_t seed, float damping,
                       int m, int H) {
  const int K = H > 1 ? H : 1;
  const float ratio = __uint2float_rn(inc) * kTwoNeg32;
  const float nrel = (float)(m > 0 ? m : 0);
  float denom = 0.0f;
  for (int k = 1; k <= K; ++k) {
    const bool active = inc <= 0x7FFFFFFFu / (uint32_t)k && inc > 0u;
    denom = denom + (active ? fabsf(noise((uint32_t)k, seed)) : 0.0f);
  }
  denom = fmaxf(denom, kEps);
  float acc = 0.0f;
  for (int k = 1; k <= K; ++k) {
    if (!(inc <= 0x7FFFFFFFu / (uint32_t)k && inc > 0u)) continue;
    const float u = noise((uint32_t)k, seed);
    const uint32_t phi = noise_u32((uint32_t)(K + k), seed);
    const float g = cosf(kPi * (float)k * ratio);
    const float alpha = damping * ratio * logf(fmaxf(g, kEps));
    const uint32_t pk = p * (uint32_t)k + phi;
    acc = acc + (u / denom) * expf(nrel * alpha) * sin_turns(phase_x(pk));
  }
  return acc;
}

__device__ float wave_value(int wid, uint32_t p, uint32_t inst_inc,
                            const int32_t* row, const float* harm,
                            const float* table, int n, int m, int H) {
  const float x = phase_x(p);
  switch (wid) {
    case 0:
      return sin_turns(x);
    case 1:
      return triangle(x);
    case 2:
      return p < 0x80000000u ? 1.0f : -1.0f;
    case 3:
      return 2.0f * x - 1.0f;
    case 4: {
      const uint32_t wu = __float2uint_rz(as_f32(row[PULSE_WIDTH]) * kTwo32);
      return p < wu ? 1.0f : -1.0f;
    }
    case 5: {
      if (x < 0.5f) {
        const float y = 4.0f * x - 1.0f;
        return sqrtf(fmaxf(1.0f - y * y, 0.0f));
      }
      const float y = 4.0f * x - 3.0f;
      return -sqrtf(fmaxf(1.0f - y * y, 0.0f));
    }
    case 6: {
      const float t = triangle(x);
      return t * t * t;
    }
    case 7: {
      const uint32_t idx = (uint32_t)floor_div(n, row[NOISE_HOLD]);
      return noise(idx, (uint32_t)row[SEED]);
    }
    case 8: {
      float acc = 0.0f;
      for (int k = 1; k <= H; ++k)
        acc = acc + harm[k - 1] * sin_turns(phase_x(p * (uint32_t)k));
      return acc;
    }
    case 9:
    case 10: {
      const float dt = fmaxf(__uint2float_rn(inst_inc) * kTwoNeg32, kMinDt);
      const float b = blep(x, dt);
      if (wid == 9) return (2.0f * x - 1.0f) - b;
      const float naive = p < 0x80000000u ? 1.0f : -1.0f;
      const float x2 = x < 0.5f ? x + 0.5f : x - 0.5f;
      return naive + b - blep(x2, dt);
    }
    case 11: {
      const float pos = x * (float)kTableLen;
      const int i = min(__float2int_rz(pos), kTableLen - 1);
      const float frac = pos - (float)i;
      const float lo = table[i];
      const float hi = table[(i + 1) % kTableLen];
      return lo + (hi - lo) * frac;
    }
    case 12:
      return pluck(p, (uint32_t)row[BASE_INC], (uint32_t)row[SEED],
                   as_f32(row[DAMPING]), m, H);
    default:
      return 0.0f;
  }
}

__device__ __forceinline__ float adsr(const int32_t* row, int m, float sr_r) {
  const float t = (float)m * sr_r;
  const float a = fmaxf(as_f32(row[ATTACK]), 0.0f);
  const float d = fmaxf(as_f32(row[DECAY]), 0.0f);
  const float r = fmaxf(as_f32(row[RELEASE]), 0.0f);
  const float sl = as_f32(row[SUSTAIN]);
  const float gate = (float)row[GATE] * sr_r;
  const float s = fmaxf(gate - a - d, 0.0f);
  const float t2 = a + d;
  const float t4 = t2 + s + r;
  const float t3 = t2 + s;
  const float a_r = 1.0f / fmaxf(a, kEps);
  const float d_r = 1.0f / fmaxf(d, kEps);
  const float r_r = 1.0f / fmaxf(r, kEps);
  float g = t < a ? t * a_r
          : t < t2 ? 1.0f + (sl - 1.0f) * (t - a) * d_r
          : t < t3 ? sl
          : t < t4 ? sl * (t4 - t) * r_r
          : 0.0f;
  if (t < 0.0f) g = 0.0f;
  return fminf(fmaxf(g, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
render_kernel(const int32_t* __restrict__ params,
              const float* __restrict__ harm, int harm_stride,
              const float* __restrict__ table, Groups groups, int H, int n0,
              int nframes, float sr_r, int use_glide,
              float2* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nframes) return;
  const int n = n0 + i;
  const uint32_t nu = (uint32_t)n;
  float acc_l = 0.0f, acc_r = 0.0f;
  for (int g = 0; g < groups.n; ++g) {
    const int gwid = groups.wid[g];
    const bool gfm = groups.has_fm[g] != 0;
    const int vend = groups.start[g] + groups.count[g];
    for (int v = groups.start[g]; v < vend; ++v) {
      const int32_t* row = params + (size_t)v * kCols;
      const int wid = gwid < 0 ? row[WAVE] : gwid;
      const uint32_t inc = (uint32_t)row[BASE_INC];
      const uint32_t phase0 = (uint32_t)row[PHASE0];
      const int m = n - row[START];                  // note-relative frame
      uint32_t p = phase0 + nu * inc;
      uint32_t inst = inc;
      if (use_glide && row[GLIDE_FRAMES] > 0) {
        // linear-in-increment integer chirp, closed form (reference _phases)
        const int G = row[GLIDE_FRAMES];
        const uint32_t inc0 = (uint32_t)row[GLIDE_INC0];
        const uint32_t d = (uint32_t)row[GLIDE_D];
        const uint32_t mu = (uint32_t)m, Gu = (uint32_t)G;
        if (row[WAVE] != 12) {                        // pluck keeps one pitch
          const uint32_t during = inc0 * mu + d * tri_u32(mu);
          const uint32_t phase_g = inc0 * Gu + d * tri_u32(Gu);
          const uint32_t inc_g = inc0 + d * Gu;
          const uint32_t after = phase_g + (mu - Gu) * inc_g;
          p = phase0 + (m < G ? during : after);
        }
        inst = inc0 + (uint32_t)min(max(m, 0), G) * d;
      }
      if (gfm) {
        // exact discrete FM integral: delta = inc * depth * S_n
        const uint32_t finc = (uint32_t)row[FM_INC];
        const float depth = as_f32(row[FM_DEPTH]);
        if (depth != 0.0f && finc != 0u) {
          const uint32_t fp = (uint32_t)row[FM_PHASE0] + nu * finc;
          const float xh = phase_x(fp - (finc >> 1));
          const float s_n = (as_f32(row[FM_C0]) - cos_turns(xh)) * as_f32(row[FM_R]);
          const float delta = __uint2float_rn(inc) * depth * s_n;
          const float q = delta * kTwoNeg32;
          const float frac = q - rintf(q);
          p += (uint32_t)__float2int_rz(frac * kTwo32);
        }
      }
      const float w = wave_value(wid, p, inst, row,
                                 harm + (size_t)v * harm_stride,
                                 table + (size_t)v * kTableLen, n, m, H);
      const float sig = (as_f32(row[BIAS]) + as_f32(row[AMP]) * w)
                        * adsr(row, m, sr_r);
      const float pan = as_f32(row[PAN]);
      acc_l = acc_l + sig * fminf(1.0f, 1.0f - pan);
      acc_r = acc_r + sig * fminf(1.0f, 1.0f + pan);
    }
  }
  out[i] = make_float2(acc_l, acc_r);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// `groups` is a host array of ngroups (wid, has_fm, start, count) rows.
extern "C" int voicebank_render(const int32_t* params, const float* harm,
                                int harm_stride, const float* table,
                                const int32_t* groups, int ngroups, int H,
                                int n0, int nframes, float sr_r, int use_glide,
                                float* out, void* stream) {
  if (ngroups < 1 || ngroups > kMaxGroups || nframes <= 0)
    return (int)cudaErrorInvalidValue;
  Groups gs;
  gs.n = ngroups;
  for (int g = 0; g < ngroups; ++g) {
    gs.wid[g] = groups[4 * g];
    gs.has_fm[g] = groups[4 * g + 1];
    gs.start[g] = groups[4 * g + 2];
    gs.count[g] = groups[4 * g + 3];
  }
  for (int g = ngroups; g < kMaxGroups; ++g)
    gs.wid[g] = gs.has_fm[g] = gs.start[g] = gs.count[g] = 0;
  const int blocks = (nframes + kThreads - 1) / kThreads;
  render_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      params, harm, harm_stride, table, gs, H, n0, nframes, sr_r, use_glide,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
