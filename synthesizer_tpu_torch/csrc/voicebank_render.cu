// Fused voice-bank render for NVIDIA Hopper (sm_90a): a per-voice setup
// kernel and a tiled render kernel that skips silent voice-tiles.
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
// kernel: the TPU kernel had to leave them to an XLA side path.  So do the
// pitch, amplitude and FM-depth curves (MIDI bend, CC7/CC11, CC1 and
// pressure), which the Pallas engine rejects: render_block's use_bend,
// use_amp and use_dmod branches, segment by segment.  And the sparse rows
// of VoiceBank.sparse_plan: with idx [nchunks, K], a tile takes its
// candidate voices from its chunk's row instead of walking all V slots.
//
// What bounds it on this card: operations on the audible voice-frames.  A
// voice-frame costs about 20-200 f32 and integer operations (8 turn-unit
// sine polynomials for a harmonics voice, 8 hashed partials with expf for
// a pluck voice), a frame writes 8 bytes and the parameters are kilobytes.
// A voice sounds only from its start for gate + release, so in a song most
// voice-frames (95% on config 5) have an envelope of exactly 0.
//
// What the design does about it:
//   * setup_kernel runs once per call, one warp per voice, and writes
//     every value that does not depend on the frame (ADSR breakpoints and
//     reciprocal slopes, pan gains, the pulse threshold, glide's phase and
//     increment at the glide's end, f32(inc) * FM depth, pluck's per-
//     partial amplitude, phase and decay) into a [V, C] u32 buffer.  Each
//     value is the same f32 expression, in the same order, as the per-
//     frame code it replaces, so hoisting changes no bit.
//   * render_kernel gives each block a tile of kTile contiguous frames,
//     kFrames a thread (strided by kThreads, so every store is coalesced),
//     one f32 L/R accumulator pair per frame.  512-frame tiles give a
//     131072-frame chunk 256 blocks and a 60 s song 5168, both well over
//     the card's 132 SMs.
//   * At the start of a tile the block tests each voice in packed order
//     and keeps, with a ballot and a prefix count, an order-preserving list
//     of the voices that may sound in it; their constants are staged in
//     shared memory.  The test is exact: t = f32(m) * sr_r is monotone in
//     the frame, so the envelope is 0 on the whole tile iff t at its last
//     frame is < 0 or t at its first is >= t4 (the same f32 t4 the
//     envelope compares with).  A silent voice adds (bias + amp*w) * 0 *
//     gain = +-0 to an accumulator that starts at +0 and so is never -0,
//     which changes no bit -- provided w and the gains are finite.  The
//     setup kernel marks a voice cull-safe only where that is guaranteed
//     (every amplitude, bias, pan, harmonic and table value within
//     +-2^32, and for pluck 0 <= damping <= 2^32); any other voice is
//     evaluated on every tile, as the plain version does.
//   * The tile then loops over the active list: voices outside, the
//     thread's frames inside, so the waveform switch is block-uniform and
//     a partial's amplitude or a harmonic's weight is loaded once for
//     kFrames frames.  Voices are walked in chunks of kThreads, so any V
//     fits the fixed shared memory.
//   * The block adds the voice-tiles it evaluated to one int32 (integer
//     atomics: the total does not depend on the order).
//   * Curves: a voice's active segment at frame m is the count of its
//     segment starts <= m, minus one, clamped to [0, S-1], as the plain
//     version counts it.  The starts of a packed row are non-decreasing,
//     so a binary search over the row gives that count; the setup kernel
//     checks each row and a row that is not sorted is counted linearly.
//     Bend and depth curves move only the phase, which stays an integer,
//     so a culled voice's waveform stays finite.  An amplitude curve
//     scales the envelope: the setup kernel keeps such a voice cull-safe
//     only if every gain its segments can reach (the ends of each ramp,
//     g0 + f32(L) * dg) lies within +-2^32.  The curve code lives only
//     in render_kernel<true>, launched for banks with curves: a
//     curve-free bank runs render_kernel<false>, the code without them
//     (the curves' registers would otherwise slow it), and curve-free
//     voices in a curve bank skip every curve branch (block-uniform
//     flags).
//   * Sparse rows: a tile's chunk row lists the voices that may sound in
//     the chunk in ascending packed order, sentinel slots (== V) skipped;
//     the exact tile test then applies as before.  Rows the plan dropped
//     would add exact zeros to the flat sum, so the sparse render equals
//     the flat one bit for bit.  A tile never straddles two chunks: the
//     chunk is a multiple of kTile frames.
// The sum stays serial in packed voice order, as the plain version sums,
// so the output is bit-identical to it, deterministic and chunk-invariant
// (a frame depends only on its absolute index).  That pinned order is why
// wgmma does not apply (a matrix product would reorder the sum), and TMA
// neither: the kernel reads kilobytes and writes each output byte once.
// Built with -fmad=false so every multiply and add rounds as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFrames = 4;                    // frames per thread
constexpr int kTile = kThreads * kFrames;     // frames per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 16;
constexpr int kTableLen = 256;

// The VoiceParams columns the setup kernel reads, in the order of
// KERNEL_COLUMNS in ops/kernels.py.  u32 fields are int64 tensors holding
// the u32 value, i32 fields int32, the rest float32 (kColType).
enum Col {
  WAVE, BASE_INC, PHASE0, AMP, BIAS, PAN, START, GATE, ATTACK, DECAY,
  SUSTAIN, RELEASE, FM_INC, FM_PHASE0, FM_DEPTH, FM_R, FM_C0, PULSE_WIDTH,
  SEED, NOISE_HOLD, DAMPING, GLIDE_INC0, GLIDE_D, GLIDE_FRAMES, kCols
};
enum ColType { I32, U32, F32 };
constexpr ColType kColType[kCols] = {
  I32, U32, U32, F32, F32, F32, I32, I32, F32, F32,
  F32, F32, U32, U32, F32, F32, F32, F32,
  U32, I32, F32, U32, U32, I32
};

// Words of one voice's row in the [V, C] constants buffer, in the order of
// CONST_COLUMNS in ops/kernels.py; f32 values bit-cast from K_AMP on.
// After kBase come 3 words per pluck partial k = 1..max(H, 1):
// u / denom (f32), phase offset phi (u32), decay rate alpha (f32).
enum Const {
  K_WAVE, K_INC, K_PHASE0, K_START, K_FM_INC, K_FM_PHASE0, K_SEED,
  K_NOISE_HOLD, K_GLIDE_INC0, K_GLIDE_D, K_GLIDE_FRAMES, K_PHASE_G, K_INC_G,
  K_PULSE_WU, K_FLAGS, K_PLUCK_KA,
  K_AMP, K_BIAS, K_LG, K_RG, K_A, K_T2, K_T3, K_T4, K_SL, K_A_R, K_D_R,
  K_R_R, K_FM_C0, K_FM_R, K_FM_SCALE, kBase
};
// K_FLAGS bits
constexpr uint32_t kSafe = 1u;        // cull-safe for every waveform but pluck
constexpr uint32_t kPluckSafe = 2u;   // cull-safe as a pluck voice
constexpr uint32_t kFmOn = 4u;        // fm_depth != 0 and fm_inc != 0
constexpr uint32_t kBend = 8u;        // pitch curve: bend_start[0] == 0
constexpr uint32_t kAmpCurve = 16u;   // amplitude curve: acurve_start[0] == 0
constexpr uint32_t kDc = 32u;         // depth curve: dcurve_start[0] == 0, fm_inc != 0
constexpr uint32_t kBendSorted = 64u;   // the row's starts are non-decreasing
constexpr uint32_t kAmpSorted = 128u;
constexpr uint32_t kDcSorted = 256u;
// bits of the render's `modes` argument (the bank's static flags)
constexpr int kGlide = 1, kUseBend = 2, kUseAmp = 4, kUseDmod = 8;
constexpr float kCullMax = 4294967296.0f;   // 2^32

// (wave id or -1 for a mixed group, has_fm, first voice, voice count) and
// each group's first slot in the walk over all groups' voices
struct Groups {
  int n;
  int nslots;
  int wid[kMaxGroups];
  int has_fm[kMaxGroups];
  int start[kMaxGroups];
  int count[kMaxGroups];
  int slot0[kMaxGroups];
};

struct Columns {
  const void* p[kCols];
};

// The curve segment arrays, [V, S], [V, KA] and [V, KD] row-major, in the
// order of CURVE_COLUMNS in ops/kernels.py.  u32 fields are int64 tensors
// holding the u32 value.
struct Curves {
  const int32_t* bend_start;
  const int64_t* bend_phase;
  const int64_t* bend_inc;
  const int64_t* bend_d;
  const int32_t* acurve_start;
  const float* acurve_g0;
  const float* acurve_dg;
  const int32_t* dcurve_start;
  const float* dcurve_c;
  const float* dcurve_a;
  const float* dcurve_b;
  int S, KA, KD;
};
constexpr int kCurveCols = 11;

// f32 constants, bit-exact to the numpy values the reference uses
constexpr float kTwoNeg32 = 0x1p-32f;
constexpr float kTwoNeg23 = 0x1p-23f;
constexpr float kTwo32 = 4294967296.0f;
constexpr float kEps = 0x1.4484c0p-100f;     // f32(1e-30)
constexpr float kMinDt = 0x1.12e0bep-30f;    // f32(1e-9)
constexpr float kPi = 0x1.921fb6p+1f;        // f32(pi)

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

__device__ __forceinline__ float f32_of(const uint32_t* c, int k) {
  return __uint_as_float(c[k]);
}

__device__ __forceinline__ bool within(float x) {
  return fabsf(x) <= kCullMax;                 // false for NaN and +-inf
}

// The active segment of a curve row at note-relative frame m: the count of
// starts <= m, minus one, clamped to [0, S-1].  A sorted row is searched
// (upper bound), any other row counted.
__device__ __forceinline__ int seg_index(const int32_t* st, int S, int m,
                                         bool sorted) {
  int cnt = 0;
  if (sorted) {
    int hi = S;
    while (cnt < hi) {
      const int mid = (cnt + hi) >> 1;
      if (st[mid] <= m) cnt = mid + 1; else hi = mid;
    }
  } else {
    for (int s = 0; s < S; ++s) cnt += st[s] <= m ? 1 : 0;
  }
  return min(max(cnt - 1, 0), S - 1);
}

// warp-wide: are the row's starts non-decreasing?
__device__ __forceinline__ bool row_sorted(const int32_t* st, int S, int lane) {
  bool ok = true;
  for (int s = lane; s + 1 < S; s += 32) ok = ok & (st[s] <= st[s + 1]);
  return __all_sync(0xffffffffu, ok);
}

// ---------------------------------------------------------------------------
// Setup: one warp per voice -> one [C] row of frame-independent values.
// The lanes share the voice's harmonic and table values (coalesced) for
// the cull-safety test and its pluck partials; every lane computes the
// scalar values (broadcast loads) and lane 0 stores them.
// ---------------------------------------------------------------------------

constexpr int kSetupWarps = 4;                // voices per setup block

__global__ void __launch_bounds__(32 * kSetupWarps)
setup_kernel(Columns cols, Curves cv, const float* __restrict__ harm,
             int harm_stride, const float* __restrict__ table, int V, int H,
             float sr_r, uint32_t* __restrict__ consts, int C,
             int* __restrict__ voice_tiles) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *voice_tiles = 0;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kSetupWarps + (threadIdx.x >> 5);
  if (v >= V) return;                           // the whole warp
  auto i32 = [&](int col) { return static_cast<const int32_t*>(cols.p[col])[v]; };
  auto u32 = [&](int col) {
    return (uint32_t)static_cast<const int64_t*>(cols.p[col])[v];
  };
  auto f32 = [&](int col) { return static_cast<const float*>(cols.p[col])[v]; };
  uint32_t* c = consts + (size_t)v * C;

  // cull-safety of the rows: every harmonic and table value in range
  bool rows_ok = true;
  const float* hrow = harm + (size_t)v * harm_stride;
  for (int k = lane; k < H; k += 32) rows_ok = rows_ok & within(hrow[k]);
  const float* trow = table + (size_t)v * kTableLen;
  for (int k = lane; k < kTableLen; k += 32) rows_ok = rows_ok & within(trow[k]);
  rows_ok = __all_sync(0xffffffffu, rows_ok);

  // curve rows: sorted starts, and every gain an amplitude curve can reach
  // (each ramp's ends g0 and g0 + f32(L) * dg, L the distance to the next
  // start, or to INT32_MAX for the last segment) within +-2^32
  const int32_t* bst = cv.bend_start + (size_t)v * cv.S;
  const int32_t* ast = cv.acurve_start + (size_t)v * cv.KA;
  const int32_t* dst = cv.dcurve_start + (size_t)v * cv.KD;
  const bool bend_sorted = row_sorted(bst, cv.S, lane);
  const bool amp_sorted = row_sorted(ast, cv.KA, lane);
  const bool dc_sorted = row_sorted(dst, cv.KD, lane);
  bool gains_ok = true;
  for (int k = lane; k < cv.KA; k += 32) {
    const long long next = k + 1 < cv.KA ? ast[k + 1] : 2147483647LL;
    const float g0 = cv.acurve_g0[(size_t)v * cv.KA + k];
    const float dg = cv.acurve_dg[(size_t)v * cv.KA + k];
    const float g1 = g0 + (float)(next - ast[k]) * dg;
    gains_ok = gains_ok & within(g0) & within(g1);
  }
  gains_ok = __all_sync(0xffffffffu, gains_ok);

  // pluck: partial k sounds iff k*inc < 2^31, which holds for k <= ka;
  // the denominator is summed serially in k order by every lane
  const int K = H > 1 ? H : 1;
  const uint32_t inc = u32(BASE_INC);
  const uint32_t seed = u32(SEED);
  const float damping = f32(DAMPING);
  const float ratio = __uint2float_rn(inc) * kTwoNeg32;
  float denom = 0.0f;
  int ka = 0;
  for (int k = 1; k <= K; ++k) {
    const bool active = inc <= 0x7FFFFFFFu / (uint32_t)k && inc > 0u;
    if (active) ka = k;
    denom = denom + (active ? fabsf(noise((uint32_t)k, seed)) : 0.0f);
  }
  denom = fmaxf(denom, kEps);
  for (int k = lane + 1; k <= K; k += 32) {     // lane k-1 takes partial k
    uint32_t* pk = c + kBase + 3 * (k - 1);
    if (k > ka) {
      pk[0] = pk[1] = pk[2] = 0u;
      continue;
    }
    const float g = cosf(kPi * (float)k * ratio);
    pk[0] = __float_as_uint(noise((uint32_t)k, seed) / denom);
    pk[1] = noise_u32((uint32_t)(K + k), seed);
    pk[2] = __float_as_uint(damping * ratio * logf(fmaxf(g, kEps)));
  }
  if (lane != 0) return;

  const uint32_t inc0 = u32(GLIDE_INC0), gd = u32(GLIDE_D);
  const uint32_t Gu = (uint32_t)i32(GLIDE_FRAMES);
  c[K_WAVE] = (uint32_t)i32(WAVE);
  c[K_INC] = inc;
  c[K_PHASE0] = u32(PHASE0);
  c[K_START] = (uint32_t)i32(START);
  c[K_FM_INC] = u32(FM_INC);
  c[K_FM_PHASE0] = u32(FM_PHASE0);
  c[K_SEED] = seed;
  c[K_NOISE_HOLD] = (uint32_t)i32(NOISE_HOLD);
  c[K_GLIDE_INC0] = inc0;
  c[K_GLIDE_D] = gd;
  c[K_GLIDE_FRAMES] = Gu;
  c[K_PHASE_G] = inc0 * Gu + gd * tri_u32(Gu);      // phase at m == G
  c[K_INC_G] = inc0 + gd * Gu;
  c[K_PULSE_WU] = __float2uint_rz(f32(PULSE_WIDTH) * kTwo32);
  c[K_PLUCK_KA] = (uint32_t)ka;

  auto put = [&](int k, float x) { c[k] = __float_as_uint(x); };
  // pan gains
  const float amp = f32(AMP), bias = f32(BIAS), pan = f32(PAN);
  put(K_AMP, amp);
  put(K_BIAS, bias);
  put(K_LG, fminf(1.0f, 1.0f - pan));
  put(K_RG, fminf(1.0f, 1.0f + pan));

  // ADSR breakpoints and slopes
  const float a = fmaxf(f32(ATTACK), 0.0f);
  const float d = fmaxf(f32(DECAY), 0.0f);
  const float r = fmaxf(f32(RELEASE), 0.0f);
  const float gate = (float)i32(GATE) * sr_r;
  const float s = fmaxf(gate - a - d, 0.0f);
  const float t2 = a + d;
  const float t3 = t2 + s;
  put(K_A, a);
  put(K_T2, t2);
  put(K_T3, t3);
  put(K_T4, t3 + r);
  put(K_SL, f32(SUSTAIN));
  put(K_A_R, 1.0f / fmaxf(a, kEps));
  put(K_D_R, 1.0f / fmaxf(d, kEps));
  put(K_R_R, 1.0f / fmaxf(r, kEps));

  // FM: delta = (f32(inc) * depth) * S_n
  const float depth = f32(FM_DEPTH);
  put(K_FM_C0, f32(FM_C0));
  put(K_FM_R, f32(FM_R));
  put(K_FM_SCALE, __uint2float_rn(inc) * depth);

  const bool has_amp = ast[0] == 0;
  const bool safe = rows_ok && within(amp) && within(bias) && within(pan)
                    && (!has_amp || (amp_sorted && gains_ok));
  const bool pluck_safe = damping >= 0.0f && damping <= kCullMax;
  c[K_FLAGS] = (safe ? kSafe : 0u) | (pluck_safe ? kPluckSafe : 0u)
             | (depth != 0.0f && u32(FM_INC) != 0u ? kFmOn : 0u)
             | (bst[0] == 0 ? kBend : 0u) | (has_amp ? kAmpCurve : 0u)
             | (dst[0] == 0 && u32(FM_INC) != 0u ? kDc : 0u)
             | (bend_sorted ? kBendSorted : 0u)
             | (amp_sorted ? kAmpSorted : 0u) | (dc_sorted ? kDcSorted : 0u);
}

// ---------------------------------------------------------------------------
// Render: one voice's contribution to the thread's kFrames frames.
// ---------------------------------------------------------------------------

template <int WID, bool CURVES>
__device__ __forceinline__ void add_voice(
    const uint32_t* c, const uint32_t* __restrict__ partials,
    const float* __restrict__ harm, const float* __restrict__ table, int H,
    bool fm, int modes, const Curves& cv, size_t v, const int (&n)[kFrames],
    float sr_r, float (&acc_l)[kFrames], float (&acc_r)[kFrames]) {
  const uint32_t inc = c[K_INC], phase0 = c[K_PHASE0];
  const uint32_t start = c[K_START], flags = c[K_FLAGS];
  uint32_t p[kFrames], inst[kFrames];
  int m[kFrames];                                   // note-relative frame
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    m[f] = (int)((uint32_t)n[f] - start);
    p[f] = phase0 + (uint32_t)n[f] * inc;
    inst[f] = inc;
  }
  const bool chirp = c[K_WAVE] != 12u;              // pluck keeps one pitch
  if (CURVES && (modes & kUseBend) && (flags & kBend)
      && (chirp || WID == 9 || WID == 10)) {
    // pitch curve: the glide chirp per segment, anchored at the segment's
    // exact phase (reference _phases and _inst_inc)
    const int32_t* st = cv.bend_start + v * cv.S;
    const bool sorted = (flags & kBendSorted) != 0;
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int j = seg_index(st, cv.S, m[f], sorted);
      const uint32_t ph = (uint32_t)cv.bend_phase[v * cv.S + j];
      const uint32_t bi = (uint32_t)cv.bend_inc[v * cv.S + j];
      const uint32_t bd = (uint32_t)cv.bend_d[v * cv.S + j];
      const uint32_t mrel = (uint32_t)m[f] - (uint32_t)st[j];
      if (chirp) p[f] = phase0 + ph + mrel * bi + bd * tri_u32(mrel);
      inst[f] = bi + (uint32_t)max((int)mrel, 0) * bd;
    }
  }
  const int G = (int)c[K_GLIDE_FRAMES];
  if ((modes & kGlide) && G > 0) {
    // linear-in-increment integer chirp, closed form (reference _phases)
    const uint32_t inc0 = c[K_GLIDE_INC0], d = c[K_GLIDE_D];
    const uint32_t Gu = (uint32_t)G, phase_g = c[K_PHASE_G], inc_g = c[K_INC_G];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const uint32_t mu = (uint32_t)m[f];
      if (chirp) {
        const uint32_t during = inc0 * mu + d * tri_u32(mu);
        const uint32_t after = phase_g + (mu - Gu) * inc_g;
        p[f] = phase0 + (m[f] < G ? during : after);
      }
      inst[f] = inc0 + (uint32_t)min(max(m[f], 0), G) * d;
    }
  }
  const bool dc = CURVES && (modes & kUseDmod) && (flags & kDc);
  if (dc || ((fm || (CURVES && (modes & kUseDmod))) && (flags & kFmOn))) {
    // exact discrete FM integral: delta = inc * depth * S_n, or under a
    // depth curve the reference's _dmod_delta (eight trig evaluations)
    const uint32_t finc = c[K_FM_INC], fp0 = c[K_FM_PHASE0];
    const uint32_t half = finc >> 1;
    const float c0 = f32_of(c, K_FM_C0), rr = f32_of(c, K_FM_R);
    const float scale = f32_of(c, K_FM_SCALE);
    const int32_t* st = cv.dcurve_start + v * cv.KD;
    const bool sorted = (flags & kDcSorted) != 0;
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const uint32_t fp = fp0 + (uint32_t)n[f] * finc;
      float delta;
      if (dc) {
        const int j = seg_index(st, cv.KD, m[f], sorted);
        const float cj = cv.dcurve_c[v * cv.KD + j];
        const float a = cv.dcurve_a[v * cv.KD + j];
        const float b = cv.dcurve_b[v * cv.KD + j];
        const uint32_t ph_j = fp0 + (start + (uint32_t)st[j]) * finc;
        const float r2 = rr * rr;
        const float s1 = (cos_turns(phase_x(ph_j - half))
                          - cos_turns(phase_x(fp - half))) * rr;
        int K = (int)((uint32_t)m[f] - (uint32_t)st[j] - 1u);
        K = K > 0 ? K : 0;                          // L-1, clamped
        const uint32_t Ku = (uint32_t)K;
        const float xK = phase_x(Ku * finc);
        const float xKh = phase_x(Ku * finc + half);
        const float Kf = (float)K;
        const float A = sin_turns(xK) * r2 - Kf * cos_turns(xKh) * rr;
        const float B = Kf * sin_turns(xKh) * rr - (1.0f - cos_turns(xK)) * r2;
        const float xj = phase_x(ph_j);
        const float s2 = sin_turns(xj) * B + cos_turns(xj) * A;
        delta = __uint2float_rn(inc) * (cj + a * s1 + b * s2);
      } else {
        const float s_n = (c0 - cos_turns(phase_x(fp - half))) * rr;
        delta = scale * s_n;
      }
      const float q = delta * kTwoNeg32;
      const float frac = q - rintf(q);
      p[f] += (uint32_t)__float2int_rz(frac * kTwo32);
    }
  }
  // amplitude curve: gain g0 + f32(max(m - start_j, 0)) * dg
  float gain[kFrames];
  const bool amp_curve = CURVES && (modes & kUseAmp) && (flags & kAmpCurve);
  if (amp_curve) {
    const int32_t* st = cv.acurve_start + v * cv.KA;
    const bool sorted = (flags & kAmpSorted) != 0;
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int j = seg_index(st, cv.KA, m[f], sorted);
      const int k = (int)((uint32_t)m[f] - (uint32_t)st[j]);
      gain[f] = cv.acurve_g0[v * cv.KA + j]
              + (float)(k > 0 ? k : 0) * cv.acurve_dg[v * cv.KA + j];
    }
  }

  float w[kFrames];
  if constexpr (WID == 8 || WID == 12) {
#pragma unroll
    for (int f = 0; f < kFrames; ++f) w[f] = 0.0f;
  }
  if constexpr (WID == 8) {
    for (int k = 1; k <= H; ++k) {
      const float h = harm[k - 1];
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        w[f] = w[f] + h * sin_turns(phase_x(p[f] * (uint32_t)k));
    }
  } else if constexpr (WID == 12) {
    // Karplus-Strong in spectral form (spec: goldref/spec.py)
    float nrel[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) nrel[f] = (float)(m[f] > 0 ? m[f] : 0);
    const int ka = (int)c[K_PLUCK_KA];
    for (int k = 1; k <= ka; ++k, partials += 3) {
      const float ud = __uint_as_float(partials[0]);
      const uint32_t phi = partials[1];
      const float alpha = __uint_as_float(partials[2]);
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        w[f] = w[f] + ud * expf(nrel[f] * alpha)
                    * sin_turns(phase_x(p[f] * (uint32_t)k + phi));
    }
  } else {
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float x = phase_x(p[f]);
      if constexpr (WID == 0) {
        w[f] = sin_turns(x);
      } else if constexpr (WID == 1) {
        w[f] = triangle(x);
      } else if constexpr (WID == 2) {
        w[f] = p[f] < 0x80000000u ? 1.0f : -1.0f;
      } else if constexpr (WID == 3) {
        w[f] = 2.0f * x - 1.0f;
      } else if constexpr (WID == 4) {
        w[f] = p[f] < c[K_PULSE_WU] ? 1.0f : -1.0f;
      } else if constexpr (WID == 5) {
        if (x < 0.5f) {
          const float y = 4.0f * x - 1.0f;
          w[f] = sqrtf(fmaxf(1.0f - y * y, 0.0f));
        } else {
          const float y = 4.0f * x - 3.0f;
          w[f] = -sqrtf(fmaxf(1.0f - y * y, 0.0f));
        }
      } else if constexpr (WID == 6) {
        const float t = triangle(x);
        w[f] = t * t * t;
      } else if constexpr (WID == 7) {
        const uint32_t idx = (uint32_t)floor_div(n[f], (int)c[K_NOISE_HOLD]);
        w[f] = noise(idx, c[K_SEED]);
      } else if constexpr (WID == 9 || WID == 10) {
        const float dt = fmaxf(__uint2float_rn(inst[f]) * kTwoNeg32, kMinDt);
        const float b = blep(x, dt);
        if constexpr (WID == 9) {
          w[f] = (2.0f * x - 1.0f) - b;
        } else {
          const float naive = p[f] < 0x80000000u ? 1.0f : -1.0f;
          const float x2 = x < 0.5f ? x + 0.5f : x - 0.5f;
          w[f] = naive + b - blep(x2, dt);
        }
      } else if constexpr (WID == 11) {
        const float pos = x * (float)kTableLen;
        const int i = min(__float2int_rz(pos), kTableLen - 1);
        const float frac = pos - (float)i;
        const float lo = table[i];
        const float hi = table[(i + 1) % kTableLen];
        w[f] = lo + (hi - lo) * frac;
      } else {
        w[f] = 0.0f;                                // unknown wave id
      }
    }
  }

  const float amp = f32_of(c, K_AMP), bias = f32_of(c, K_BIAS);
  const float lg = f32_of(c, K_LG), rg = f32_of(c, K_RG);
  const float a = f32_of(c, K_A), t2 = f32_of(c, K_T2), t3 = f32_of(c, K_T3);
  const float t4 = f32_of(c, K_T4), sl = f32_of(c, K_SL);
  const float a_r = f32_of(c, K_A_R), d_r = f32_of(c, K_D_R);
  const float r_r = f32_of(c, K_R_R);
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const float t = (float)m[f] * sr_r;
    float g = t < a ? t * a_r
            : t < t2 ? 1.0f + (sl - 1.0f) * (t - a) * d_r
            : t < t3 ? sl
            : t < t4 ? sl * (t4 - t) * r_r
            : 0.0f;
    if (t < 0.0f) g = 0.0f;
    g = fminf(fmaxf(g, 0.0f), 1.0f);
    if (amp_curve) g = g * gain[f];
    const float sig = (bias + amp * w[f]) * g;
    acc_l[f] = acc_l[f] + sig * lg;
    acc_r[f] = acc_r[f] + sig * rg;
  }
}

template <bool CURVES>
__global__ void __launch_bounds__(kThreads)
render_kernel(const uint32_t* __restrict__ consts, int C,
              const float* __restrict__ harm, int harm_stride,
              const float* __restrict__ table, Groups groups, Curves cv,
              int H, int n0, int nframes, float sr_r, int modes,
              const int32_t* __restrict__ idx, int K, int chunk_frames, int V,
              float2* __restrict__ out, int* __restrict__ voice_tiles) {
  __shared__ uint32_t s_const[kThreads][kBase];
  __shared__ int s_voice[kThreads];
  __shared__ int s_wid[kThreads];       // wave id | 0x100 if the group has FM
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kTile;
  const int ilast = min(i0 + kTile, nframes) - 1;
  const uint32_t n_first = (uint32_t)(n0 + i0), n_last = (uint32_t)(n0 + ilast);
  // sparse rows: the tile's chunk row holds its candidate voices
  const int32_t* row = idx ? idx + (size_t)((n0 + i0) / chunk_frames) * K
                           : nullptr;
  const int nslots = idx ? K : groups.nslots;
  int n[kFrames];
  float acc_l[kFrames], acc_r[kFrames];
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    n[f] = n0 + min(i0 + f * kThreads + tid, nframes - 1);
    acc_l[f] = 0.0f;
    acc_r[f] = 0.0f;
  }
  int evaluated = 0;
  for (int base = 0; base < nslots; base += kThreads) {
    // which voices of this chunk may sound in the tile (exact, see above)
    const int s = base + tid;
    bool active = false;
    int v = 0, code = 0;
    if (s < nslots) {
      int g = 0;
      if (row) {
        v = row[s];                     // one mixed group; V = sentinel
      } else {
        while (g + 1 < groups.n && s >= groups.slot0[g + 1]) ++g;
        v = groups.start[g] + (s - groups.slot0[g]);
      }
      if (v >= 0 && v < V) {
        const uint32_t* c = consts + (size_t)v * C;
        const int wid = groups.wid[g] < 0 ? (int)c[K_WAVE] : groups.wid[g];
        code = wid | (groups.has_fm[g] ? 0x100 : 0);
        const uint32_t flags = c[K_FLAGS];
        const bool safe = (flags & kSafe)
                          && (wid != 12 || (flags & kPluckSafe));
        const int m_first = (int)(n_first - c[K_START]);
        const int m_last = (int)(n_last - c[K_START]);
        const bool silent = safe && m_first <= m_last
            && ((float)m_last * sr_r < 0.0f
                || (float)m_first * sr_r >= f32_of(c, K_T4));
        active = !silent;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      pos += k < warp ? s_count[k] : 0;
      total += s_count[k];
    }
    if (active) {
      s_voice[pos] = v;
      s_wid[pos] = code;
    }
    __syncthreads();
    for (int e = tid; e < total * kBase; e += kThreads) {
      const int j = e / kBase, k = e - j * kBase;
      s_const[j][k] = consts[(size_t)s_voice[j] * C + k];
    }
    __syncthreads();
    for (int j = 0; j < total; ++j) {
      const int vj = s_voice[j];
      const uint32_t* c = s_const[j];
      const uint32_t* partials = consts + (size_t)vj * C + kBase;
      const float* hrow = harm + (size_t)vj * harm_stride;
      const float* trow = table + (size_t)vj * kTableLen;
      const bool fm = (s_wid[j] & 0x100) != 0;
#define VOICE(W) add_voice<W, CURVES>(c, partials, hrow, trow, H, fm, modes, cv, \
                              (size_t)vj, n, sr_r, acc_l, acc_r)
      switch (s_wid[j] & 0xff) {
        case 0: VOICE(0); break;
        case 1: VOICE(1); break;
        case 2: VOICE(2); break;
        case 3: VOICE(3); break;
        case 4: VOICE(4); break;
        case 5: VOICE(5); break;
        case 6: VOICE(6); break;
        case 7: VOICE(7); break;
        case 8: VOICE(8); break;
        case 9: VOICE(9); break;
        case 10: VOICE(10); break;
        case 11: VOICE(11); break;
        case 12: VOICE(12); break;
        default: VOICE(-1); break;
      }
#undef VOICE
    }
    evaluated += total;
    __syncthreads();                    // the next chunk reuses s_*
  }
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const int i = i0 + f * kThreads + tid;
    if (i < nframes) out[i] = make_float2(acc_l[f], acc_r[f]);
  }
  if (tid == 0 && evaluated > 0) atomicAdd(voice_tiles, evaluated);
}

Curves make_curves(const void* const* p, const int* dims) {
  Curves cv;
  cv.bend_start = static_cast<const int32_t*>(p[0]);
  cv.bend_phase = static_cast<const int64_t*>(p[1]);
  cv.bend_inc = static_cast<const int64_t*>(p[2]);
  cv.bend_d = static_cast<const int64_t*>(p[3]);
  cv.acurve_start = static_cast<const int32_t*>(p[4]);
  cv.acurve_g0 = static_cast<const float*>(p[5]);
  cv.acurve_dg = static_cast<const float*>(p[6]);
  cv.dcurve_start = static_cast<const int32_t*>(p[7]);
  cv.dcurve_c = static_cast<const float*>(p[8]);
  cv.dcurve_a = static_cast<const float*>(p[9]);
  cv.dcurve_b = static_cast<const float*>(p[10]);
  cv.S = dims[0];
  cv.KA = dims[1];
  cv.KD = dims[2];
  return cv;
}

}  // namespace

// The layout the wrapper must agree with: words before the pluck partials,
// frames per tile.
extern "C" void voicebank_info(int* base_words, int* tile) {
  *base_words = kBase;
  *tile = kTile;
}

// Launch the setup kernel on `stream`; returns cudaGetLastError() (0 = ok).
// `cols` is a host array of kCols device pointers (the VoiceParams columns
// in enum Col order), `curves` one of kCurveCols (the curve arrays in
// struct Curves order) and `dims` their widths (S, KA, KD); `consts` is
// [V, C] with C = kBase + 3 * max(H, 1); the kernel also sets *voice_tiles
// to 0.
extern "C" int voicebank_setup(const void* const* cols,
                               const void* const* curves, const int* dims,
                               const float* harm, int harm_stride,
                               const float* table, int V, int H, float sr_r,
                               uint32_t* consts, int C, int* voice_tiles,
                               void* stream) {
  if (V <= 0 || H < 0 || C != kBase + 3 * (H > 1 ? H : 1)
      || dims[0] < 1 || dims[1] < 1 || dims[2] < 1)
    return (int)cudaErrorInvalidValue;
  Columns cs;
  for (int k = 0; k < kCols; ++k) cs.p[k] = cols[k];
  setup_kernel<<<(V + kSetupWarps - 1) / kSetupWarps, 32 * kSetupWarps, 0,
                 (cudaStream_t)stream>>>(cs, make_curves(curves, dims), harm,
                                         harm_stride, table, V, H, sr_r,
                                         consts, C, voice_tiles);
  return (int)cudaGetLastError();
}

// Launch the render kernel on `stream`; returns cudaGetLastError() after
// the launch (0 = ok).  `groups` is a host array of ngroups (wid, has_fm,
// start, count) rows; `consts` is the setup kernel's output; `modes` holds
// the kGlide/kUseBend/kUseAmp/kUseDmod bits.  With `idx` (device [nchunks,
// K] int32 rows of voice indices, V = an empty slot; one group;
// chunk_frames a multiple of kTile and n0 one of chunk_frames; the wrapper
// checks that the rows cover the window) the tile at absolute frame n
// takes its voices from row n / chunk_frames.
extern "C" int voicebank_render(const uint32_t* consts, int C,
                                const float* harm, int harm_stride,
                                const float* table, const int32_t* groups,
                                int ngroups, const void* const* curves,
                                const int* dims, int H, int n0, int nframes,
                                float sr_r, int modes, const int32_t* idx,
                                int K, int chunk_frames, int V, float* out,
                                int* voice_tiles, void* stream) {
  if (ngroups < 1 || ngroups > kMaxGroups || nframes <= 0
      || (idx && (ngroups != 1 || K < 1 || chunk_frames <= 0
                  || chunk_frames % kTile != 0 || n0 % chunk_frames != 0)))
    return (int)cudaErrorInvalidValue;
  Groups gs = {};
  gs.n = ngroups;
  for (int g = 0; g < ngroups; ++g) {
    gs.wid[g] = groups[4 * g];
    gs.has_fm[g] = groups[4 * g + 1];
    gs.start[g] = groups[4 * g + 2];
    gs.count[g] = groups[4 * g + 3];
    gs.slot0[g] = gs.nslots;
    gs.nslots += gs.count[g];
  }
  const int blocks = (nframes + kTile - 1) / kTile;
  auto kernel = modes & (kUseBend | kUseAmp | kUseDmod) ? render_kernel<true>
                                                        : render_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      consts, C, harm, harm_stride, table, gs, make_curves(curves, dims), H,
      n0, nframes, sr_r, modes, idx, K, chunk_frames, V,
      reinterpret_cast<float2*>(out), voice_tiles);
  return (int)cudaGetLastError();
}
