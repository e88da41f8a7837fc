// Fused voice-bank render for NVIDIA Hopper (sm_90a): a per-voice setup
// kernel and a tiled render kernel that skips silent voice-tiles and looks
// curve segments up once per voice and tile.
//
// Replaces the TPU kernel synthesizer_tpu/ops/kernels.py::_kernel (launched
// by render_stereo_pallas).  It computes what the reference's plain
// render_block (synthesizer_tpu/models/voicebank.py) computes for a bank
// layout, glide and the wavetable included, with render_block's formulas
// where the Pallas kernel differs from it:
//   * native uint32 DDS phase, x = f32(p) * 2^-32 (no folded int32 form);
//   * ADSR time f32(int32(n - start)) * f32(1/sr), exact past 2^24 frames;
//   * reciprocal ADSR slopes and an envelope clipped to [0, 1];
//   * pluck decay from g = cos(pi*k*ratio), its log and exp as the f32
//     polynomials exp_f32/log_f32 (ops/trig.py), which give the same bits
//     on the card and the CPU;
//   * the FM offset cast saturates (__float2int_rz), as XLA's f32->i32 does.
// Wavetable voices (wave 11) gather from their 256-sample row inside the
// kernel: the TPU kernel had to leave them to an XLA side path.  So do the
// pitch, amplitude and FM-depth curves (MIDI bend, CC7/CC11, CC1 and
// pressure), which the Pallas engine rejects: render_block's use_bend,
// use_amp and use_dmod branches, segment by segment.  And the sparse rows
// of VoiceBank.sparse_plan: with idx [nchunks, K], a tile takes its
// candidate voices from its chunk's row instead of walking all V slots.
// And the segment buses of render_block(seg=, nseg=), which the sequencer's
// per-track effects need: each voice's stereo signal goes to its own bus.
//
// What bounds it on this card: operations on the audible voice-frames.  A
// voice-frame costs about 20-200 f32 and integer operations (8 turn-unit
// sine polynomials for a harmonics voice, 8 hashed partials with exp_f32 for
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
//   * render_kernel gives each block a tile of kTile = 512 contiguous
//     frames, a few frames a thread (strided by the block's threads, so
//     every store is coalesced: 4 frames on 128 threads in the curve-free
//     kernel, 2 on 256 in the curve kernel), one f32 L/R accumulator pair
//     per frame.  512-frame tiles give a 131072-frame chunk 256 blocks and
//     a 60 s song 5168, both well over the card's 132 SMs.
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
//     a partial's amplitude or a harmonic's weight is loaded once for the
//     thread's frames.  Voices are walked in chunks of the block's threads,
//     so any V fits the fixed shared memory.
//   * The block adds the voice-tiles it evaluated, and the curve kernel
//     the windows it looked up and those it left to the whole-row search,
//     to int32 counters (integer atomics: the totals do not depend on the
//     order).
//   * Curves: a voice's active segment at frame m is the count of its
//     segment starts <= m, minus one, clamped to [0, S-1], as the plain
//     version counts it.  The starts of a packed row are non-decreasing,
//     so a binary search (upper bound) over the row gives that count; the
//     setup kernel checks each row and a row that is not sorted is counted
//     linearly.  Searched per frame in global memory, as a first version
//     did, the curves bound the kernel by latency, not by operations: up
//     to 21 dependent loads a voice-frame before any arithmetic.  A
//     512-frame tile is 11.6 ms of audio, and a controller curve has a
//     segment or two in it, so the lookups are made per (voice, tile) and
//     the segments' values per (voice, segment):
//       - the setup kernel's per-segment pass (lanes over segments) packs
//         each curve row into 16-byte entries (struct Segments): the u32
//         bend values out of their int64 columns, and for a depth segment
//         the three of the integral's eight trig evaluations that depend
//         only on the segment's first frame.  Same f32 expressions, same
//         order: no bit changes.  Only rows of voices that carry the
//         curve are written; a curve-free bank has no such buffer;
//       - render_kernel<true> walks a tile's list kBatch voices at a
//         time.  For each listed voice and curve one thread finds the
//         segment at the tile's first frame (the one binary search),
//         reads that entry and the next kWin with independent 16-byte
//         loads, counts those that start by the tile's last frame, and
//         stages up to kWin entries in shared memory (struct Window);
//       - per frame, voice_phase counts the starts <= m over the window's
//         entries after the first (none for the usual one-segment
//         window) and reads the entry from shared memory.  The count
//         over the whole row is the first segment's index plus that
//         count, because the row is sorted;
//       - a span of more than kWin segments, an unsorted row, or note-
//         relative frames that wrap i32 inside the tile leave the tile
//         without a window: its frames search the whole row in global
//         memory as before (counted, so a run can tell their share).
//     kBatch = 32 keeps the block's shared memory at about 15 KB (4 KB of
//     constants, 8 KB of windows), so shared memory allows 15 blocks an
//     SM and the registers decide the occupancy.
//     Bend and depth curves move only the phase, which stays an integer,
//     so a culled voice's waveform stays finite.  An amplitude curve
//     scales the envelope: the setup kernel keeps such a voice cull-safe
//     only if every gain its segments can reach (the ends of each ramp,
//     g0 + f32(L) * dg) lies within +-2^32.
//   * Two kernels from one source.  The curve code lives only in
//     render_kernel<true>, launched for banks with curves: a curve-free
//     bank runs render_kernel<false>, the code without them, with every
//     part of a voice specialised per waveform, in 48 registers.  In the
//     curve kernel that layout (the curve code once per waveform) made a
//     program of tens of thousands of SASS operations, most of them
//     fetched once per voice and tile, and fetching the code, not the
//     arithmetic, bound it.  So there the voice is cut in three: phase and
//     curves (voice_phase) and envelope and mix (voice_mix) are held once,
//     and only the waveform (voice_wave) is switched; the whole-row
//     searches stay rolled loops.  That program is about a tenth as long.
//     What then bounds it is the dispatch rate with too few independent
//     chains in flight, so the curve kernel takes 2 frames a thread on 256
//     threads in 64 registers (4 blocks = 32 warps an SM, no spill) rather
//     than 4 frames on 128 threads in 80 or more.
//   * Work the data does not need is skipped where that changes no bit:
//     a harmonic of weight 0 (most General-MIDI timbres use 4 or 5 of the
//     8) is not evaluated.
//   * Sparse rows: a tile's chunk row lists the voices that may sound in
//     the chunk in ascending packed order, sentinel slots (== V) skipped;
//     the exact tile test then applies as before.  Rows the plan dropped
//     would add exact zeros to the flat sum, so the sparse render equals
//     the flat one bit for bit.  A tile never straddles two chunks: the
//     chunk is a multiple of kTile frames.
//   * Segment buses (a per-voice bus column, out[i * nseg + bus]) run their
//     own code, render_bus_tile, so the flat kernels keep theirs.  A block
//     that walked every voice once per (tile, bus) paid nseg * V tests a
//     tile for a few dozen audible voices, and wrote each 32-byte sector
//     in nseg parts tens of megabytes apart.  Instead:
//       - span_kernel makes one pass over the voices for each span of
//         span_tiles tiles (16384 frames or more) and writes the ordered
//         list of those that may sound in it on a bus in [0, nseg): the
//         same exact test over the span's first and last frame, so a voice
//         silent on the span is silent on each of its tiles; a voice that
//         is not cull-safe is in every list.  An entry carries what a tile
//         needs to test it (start, t4, bus, code, the cull-safe bit);
//       - a tile's block walks only its span's list, once whatever nseg,
//         admits with the flat render's exact tile test (so the voice-tile
//         count is the flat render's), buckets the admitted voices stably
//         by bus in shared memory (an entry's place is the count of
//         entries with a lower bus or the same bus and an earlier place),
//         and renders bus after bus: a bus's voices still add serially in
//         packed order, so bus b is the render of bus b's voices alone,
//         bit for bit.  At a change of bus the accumulators go to out and
//         the buses without a voice get zeros, so one block writes every
//         bus of its frames, whole sectors within microseconds.  More
//         than kBusList admitted voices are taken in pieces: a later
//         piece reloads the sums the block stored (a stored f32 reloads
//         the same bits), so the sum stays serial;
//       - a launch of few tiles (a 32768-frame streamed chunk is 64) splits
//         a tile's frames over 2-8 blocks of fewer threads, then its buses
//         over blocks run back to back, for at least 2 blocks an SM.  The
//         test stays the whole tile's and only the first frame part counts
//         its voice-tiles and windows.
//     What bounds it then is the voices' arithmetic, the flat kernels'
//     code: on an H100 the demo song 14 times as long (2 voices a tile)
//     read 0.160 ms with the stores left out against 0.170 ms with them,
//     and 0.216-0.240 ms through the flat kernel on one bus.  Holding the
//     span list and its voices' constants in shared memory for a group of
//     tiles gained nothing there and cost up to 2x with larger groups.
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

constexpr int kTile = 512;                    // frames per block
// threads per block: 4 frames a thread in the curve-free kernel, 2 in the
// curve kernel
constexpr int kPlainThreads = 128;
constexpr int kCurveThreads = 256;
// blocks an SM the curve kernel is held to (64 registers a thread)
constexpr int kCurveBlocks = 4;
constexpr int kMaxGroups = 16;
constexpr int kTableLen = 256;
constexpr int kBatch = 32;    // voices staged at a time by the curve kernel
constexpr int kWin = 4;       // segments of one curve in a tile's window
// the segment buses: the span pass's threads, the admitted voices a bus
// tile buckets at a time, and the fields of a span entry's key word (bus
// id, the render's wave code, evaluated on every tile)
constexpr int kSpanThreads = 256;
constexpr int kBusList = 256;
constexpr int kKeyCodeShift = 16;
constexpr int kKeyUnsafe = 1 << 25;

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
// the int32 counters after the constants: voice-tiles the render evaluated,
// and from the curve kernel the curve windows it looked up (one per
// voice-tile and curve the voice carries) and those of them that search the
// whole row per frame
constexpr int kCounts = 3;

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

// The per-segment buffer the setup kernel writes for a bank with curves,
// in 16-byte entries: bend rows [V, S] (start, bend_phase, bend_inc,
// bend_d), then amplitude rows [V, KA] (start, g0, dg, 0), then depth rows
// [V, KD] of two entries (start, c, a, b) and (ph_j, cos_turns(x(ph_j -
// fm_inc / 2)), sin_turns(x(ph_j)), cos_turns(x(ph_j))), ph_j the LFO
// phase at the segment's first frame; f32 values as their bits.  Only the
// rows of voices that carry the curve's flag are written and read.
struct Segments {
  uint4* bend;
  uint4* amp;
  uint4* depth;
};

__device__ __forceinline__ Segments segment_rows(uint32_t* seg, int V,
                                                 const Curves& cv) {
  Segments sg;
  sg.bend = reinterpret_cast<uint4*>(seg);
  sg.amp = sg.bend + (size_t)V * cv.S;
  sg.depth = sg.amp + (size_t)V * cv.KA;
  return sg;
}

// One listed voice on one tile, as the curve kernel's window pass leaves
// it in shared memory: for each curve (bend, amplitude, depth) the segments
// the tile's frames can reach (`width` entries from the first one at
// s + k * kWin; 0 = the tile searches the whole row in global memory, -1 =
// the voice does not carry the curve).
struct Window {
  const uint4* s;
  int width[3];
};

// f32 constants, bit-exact to the numpy values the reference uses
constexpr float kTwoNeg32 = 0x1p-32f;
constexpr float kTwoNeg23 = 0x1p-23f;
constexpr float kTwo32 = 4294967296.0f;
constexpr float kEps = 0x1.4484c0p-100f;     // f32(1e-30)
constexpr float kMinDt = 0x1.12e0bep-30f;    // f32(1e-9)

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

// e^x and ln(x) for the pluck waveform: the polynomials of ops/trig.py
// (exp_f32, log_f32), same constants and order.  expf/logf/cosf differ in
// the last bit between CUDA and the CPU's library; these give the same
// bits on both.
__device__ __forceinline__ float exp_f32(float x) {
  const float t = x * 0x1.715476p+0f;               // log2(e)
  const float nf = rintf(t);
  const float f = t - nf;
  float acc = 0x1.ffcbfcp-17f;                      // (ln 2)^k / k!
  acc = acc * f + 0x1.430912p-13f;
  acc = acc * f + 0x1.5d87fep-10f;
  acc = acc * f + 0x1.3b2ab6p-7f;
  acc = acc * f + 0x1.c6b08ep-5f;
  acc = acc * f + 0x1.ebfbe0p-3f;
  acc = acc * f + 0x1.62e430p-1f;
  acc = acc * f + 1.0f;
  if (t > 128.0f) return __int_as_float(0x7f800000);   // +inf
  if (t < -125.0f) return 0.0f;
  const int e = (int)fminf(fmaxf(nf, -125.0f), 127.0f);
  return acc * __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float log_f32(float x) {
  int ei;
  float m = frexpf(x, &ei);                          // m in [0.5, 1)
  if (m < 0x1.6a09e6p-1f) {                          // sqrt(1/2)
    m = m * 2.0f;
    ei -= 1;
  }
  const float e = (float)ei;
  const float s = (m - 1.0f) / (m + 1.0f);
  const float z = s * s;
  float acc = 0x1.745d18p-4f;                        // 1/11
  acc = acc * z + 0x1.c71c72p-4f;                    // 1/9
  acc = acc * z + 0x1.24924ap-3f;                    // 1/7
  acc = acc * z + 0x1.99999ap-3f;                    // 1/5
  acc = acc * z + 0x1.555556p-2f;                    // 1/3
  acc = acc * z + 1.0f;
  const float r = (s * 2.0f) * acc;
  return (r + e * 0x1.7f7d1cp-20f) + e * 0x1.62e400p-1f;   // ln 2, lo+hi
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
#pragma unroll 1
    while (cnt < hi) {
      const int mid = (cnt + hi) >> 1;
      if (st[mid] <= m) cnt = mid + 1; else hi = mid;
    }
  } else {
#pragma unroll 1
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
             uint32_t* __restrict__ seg, int* __restrict__ counts) {
  if (blockIdx.x == 0 && threadIdx.x < kCounts) counts[threadIdx.x] = 0;
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

  // per-segment constants of the voice's curves, lanes over segments: each
  // value the same expression as the per-frame code it replaces
  if (seg != nullptr) {
    const Segments sg = segment_rows(seg, V, cv);
    if (bst[0] == 0) {
      uint4* row = sg.bend + (size_t)v * cv.S;
      const size_t at = (size_t)v * cv.S;
      for (int k = lane; k < cv.S; k += 32)
        row[k] = make_uint4((uint32_t)bst[k], (uint32_t)cv.bend_phase[at + k],
                            (uint32_t)cv.bend_inc[at + k],
                            (uint32_t)cv.bend_d[at + k]);
    }
    if (ast[0] == 0) {
      uint4* row = sg.amp + (size_t)v * cv.KA;
      const size_t at = (size_t)v * cv.KA;
      for (int k = lane; k < cv.KA; k += 32)
        row[k] = make_uint4((uint32_t)ast[k],
                            __float_as_uint(cv.acurve_g0[at + k]),
                            __float_as_uint(cv.acurve_dg[at + k]), 0u);
    }
    const uint32_t finc = u32(FM_INC);
    if (dst[0] == 0 && finc != 0u) {
      uint4* row = sg.depth + (size_t)v * cv.KD * 2;
      const size_t at = (size_t)v * cv.KD;
      const uint32_t fp0 = u32(FM_PHASE0), half = finc >> 1;
      const uint32_t start = (uint32_t)i32(START);
      for (int k = lane; k < cv.KD; k += 32) {
        const uint32_t ph_j = fp0 + (start + (uint32_t)dst[k]) * finc;
        const float xj = phase_x(ph_j);
        row[2 * k] = make_uint4((uint32_t)dst[k],
                                __float_as_uint(cv.dcurve_c[at + k]),
                                __float_as_uint(cv.dcurve_a[at + k]),
                                __float_as_uint(cv.dcurve_b[at + k]));
        row[2 * k + 1] = make_uint4(
            ph_j, __float_as_uint(cos_turns(phase_x(ph_j - half))),
            __float_as_uint(sin_turns(xj)), __float_as_uint(cos_turns(xj)));
      }
    }
  }

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
    const float g = cos_turns((float)k * ratio * 0.5f);
    pk[0] = __float_as_uint(noise((uint32_t)k, seed) / denom);
    pk[1] = noise_u32((uint32_t)(K + k), seed);
    pk[2] = __float_as_uint(damping * ratio * log_f32(fmaxf(g, kEps)));
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
// Render: one voice's contribution to the thread's NF frames.
// ---------------------------------------------------------------------------

// Curve k's active segment at each of the thread's frames m, as an index
// into the voice-tile's window: the count of starts <= m over the window
// in shared memory (its first entry is the tile's first segment, so the
// count runs over the others), or, where the tile has no window, the
// search of the whole row in global memory.  STRIDE entries a segment.
template <int STRIDE, int NF>
__device__ __forceinline__ void segment_at(
    const Window& win, int k, const int32_t* st, int S, bool sorted,
    const int (&m)[NF], int (&at)[NF]) {
  const int width = win.width[k];
  if (width > 0) {
#pragma unroll
    for (int f = 0; f < NF; ++f) at[f] = 0;
    for (int w = 1; w < width; ++w) {
      const int start = (int)win.s[k * kWin + STRIDE * w].x;
#pragma unroll
      for (int f = 0; f < NF; ++f) at[f] += start <= m[f] ? 1 : 0;
    }
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f) at[f] = seg_index(st, S, m[f], sorted);
  }
}

// entry i of curve k's window or, without a window, of the voice's whole
// row `g` of the per-segment buffer
__device__ __forceinline__ uint4 entry(const Window& win, int k,
                                       const uint4* g, int i) {
  return win.width[k] > 0 ? win.s[k * kWin + i] : g[i];
}

// A voice's contribution in three parts.  The first and the last do not
// depend on the waveform, so the curve kernel, whose first part is long,
// holds them once and switches only over the second (voice_wave); the
// curve-free kernel holds all three once per waveform (eval_voice).

// Part 1: the note-relative frame m, the phase p and the instantaneous
// increment inst at each of the thread's frames, under glide, FM and the
// pitch and depth curves, and the amplitude curve's gain -> whether the
// voice has an amplitude curve.
template <bool CURVES, int NF>
__device__ __forceinline__ bool voice_phase(
    const uint32_t* c, bool fm, int modes, const Curves& cv,
    const Segments& sg, const Window& win, size_t v,
    const int (&n)[NF], int (&m)[NF], uint32_t (&p)[NF],
    uint32_t (&inst)[NF], float (&gain)[NF]) {
  const uint32_t inc = c[K_INC], phase0 = c[K_PHASE0];
  const uint32_t start = c[K_START], flags = c[K_FLAGS];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    m[f] = (int)((uint32_t)n[f] - start);
    p[f] = phase0 + (uint32_t)n[f] * inc;
    inst[f] = inc;
  }
  const bool chirp = c[K_WAVE] != 12u;              // pluck keeps one pitch
  if (CURVES && win.width[0] >= 0) {
    // pitch curve: the glide chirp per segment, anchored at the segment's
    // exact phase (reference _phases and _inst_inc)
    int at[NF];
    segment_at<1, NF>(win, 0, cv.bend_start + v * cv.S, cv.S,
                  (flags & kBendSorted) != 0, m, at);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const uint4 e = entry(win, 0, sg.bend + v * cv.S, at[f]);
      // start, phase, inc, d
      const uint32_t mrel = (uint32_t)m[f] - e.x;
      if (chirp) p[f] = phase0 + e.y + mrel * e.z + e.w * tri_u32(mrel);
      inst[f] = e.z + (uint32_t)max((int)mrel, 0) * e.w;
    }
  }
  const int G = (int)c[K_GLIDE_FRAMES];
  if ((modes & kGlide) && G > 0) {
    // linear-in-increment integer chirp, closed form (reference _phases)
    const uint32_t inc0 = c[K_GLIDE_INC0], d = c[K_GLIDE_D];
    const uint32_t Gu = (uint32_t)G, phase_g = c[K_PHASE_G], inc_g = c[K_INC_G];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const uint32_t mu = (uint32_t)m[f];
      if (chirp) {
        const uint32_t during = inc0 * mu + d * tri_u32(mu);
        const uint32_t after = phase_g + (mu - Gu) * inc_g;
        p[f] = phase0 + (m[f] < G ? during : after);
      }
      inst[f] = inc0 + (uint32_t)min(max(m[f], 0), G) * d;
    }
  }
  const bool dc = CURVES && win.width[2] >= 0;
  if (dc || ((fm || (CURVES && (modes & kUseDmod))) && (flags & kFmOn))) {
    // exact discrete FM integral: delta = inc * depth * S_n, or under a
    // depth curve the reference's _dmod_delta: of its eight trig
    // evaluations the three at the segment's first frame come from the
    // setup kernel, five are left per frame
    const uint32_t finc = c[K_FM_INC], fp0 = c[K_FM_PHASE0];
    const uint32_t half = finc >> 1;
    const float c0 = f32_of(c, K_FM_C0), rr = f32_of(c, K_FM_R);
    const float scale = f32_of(c, K_FM_SCALE);
    const float r2 = rr * rr;
    int at[NF];
    if (dc)
      segment_at<2, NF>(win, 2, cv.dcurve_start + v * cv.KD, cv.KD,
                    (flags & kDcSorted) != 0, m, at);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const uint32_t fp = fp0 + (uint32_t)n[f] * finc;
      float delta;
      if (dc) {
        // (start, c, a, b) and (ph_j, cos(x(ph_j - half)), sin(x(ph_j)),
        // cos(x(ph_j)))
        const uint4* g = sg.depth + v * cv.KD * 2;
        const uint4 lo = entry(win, 2, g, 2 * at[f]);
        const uint4 hi = entry(win, 2, g, 2 * at[f] + 1);
        const float s1 = (__uint_as_float(hi.y)
                          - cos_turns(phase_x(fp - half))) * rr;
        int K = (int)((uint32_t)m[f] - lo.x - 1u);
        K = K > 0 ? K : 0;                          // L-1, clamped
        const uint32_t Ku = (uint32_t)K;
        const float xK = phase_x(Ku * finc);
        const float xKh = phase_x(Ku * finc + half);
        const float Kf = (float)K;
        const float A = sin_turns(xK) * r2 - Kf * cos_turns(xKh) * rr;
        const float B = Kf * sin_turns(xKh) * rr - (1.0f - cos_turns(xK)) * r2;
        const float s2 = __uint_as_float(hi.z) * B + __uint_as_float(hi.w) * A;
        delta = __uint2float_rn(inc) * (__uint_as_float(lo.y)
                                        + __uint_as_float(lo.z) * s1
                                        + __uint_as_float(lo.w) * s2);
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
  const bool amp_curve = CURVES && win.width[1] >= 0;
  if (amp_curve) {
    int at[NF];
    segment_at<1, NF>(win, 1, cv.acurve_start + v * cv.KA, cv.KA,
                  (flags & kAmpSorted) != 0, m, at);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const uint4 e = entry(win, 1, sg.amp + v * cv.KA, at[f]);
      // start, g0, dg
      const int k = (int)((uint32_t)m[f] - e.x);
      gain[f] = __uint_as_float(e.y)
              + (float)(k > 0 ? k : 0) * __uint_as_float(e.z);
    }
  }
  return amp_curve;
}

// Part 2: the waveform WID at phase p (and, for polyBLEP, increment inst);
// with SKIP, harmonics of weight 0 are not evaluated
template <int WID, bool SKIP, int NF>
__device__ __forceinline__ void voice_wave(
    const uint32_t* c, const uint32_t* __restrict__ partials,
    const float* __restrict__ harm, const float* __restrict__ table, int H,
    const int (&n)[NF], const int (&m)[NF],
    const uint32_t (&p)[NF], const uint32_t (&inst)[NF],
    float (&w)[NF]) {
  if constexpr (WID == 8 || WID == 12) {
#pragma unroll
    for (int f = 0; f < NF; ++f) w[f] = 0.0f;
  }
  if constexpr (WID == 8) {
    // a harmonic of weight 0 adds +-0 to w, which starts at +0 and so is
    // never -0: skipping it changes no bit
    for (int k = 1; k <= H; ++k) {
      const float h = harm[k - 1];
      if (SKIP && h == 0.0f) continue;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        w[f] = w[f] + h * sin_turns(phase_x(p[f] * (uint32_t)k));
    }
  } else if constexpr (WID == 12) {
    // Karplus-Strong in spectral form (spec: goldref/spec.py)
    float nrel[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) nrel[f] = (float)(m[f] > 0 ? m[f] : 0);
    const int ka = (int)c[K_PLUCK_KA];
    for (int k = 1; k <= ka; ++k, partials += 3) {
      const float ud = __uint_as_float(partials[0]);
      const uint32_t phi = partials[1];
      const float alpha = __uint_as_float(partials[2]);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        w[f] = w[f] + ud * exp_f32(nrel[f] * alpha)
                    * sin_turns(phase_x(p[f] * (uint32_t)k + phi));
    }
  } else {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
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
}

// Part 3: the ADSR envelope (times the amplitude curve's gain), amplitude,
// bias and pan, added to the thread's accumulators
template <int NF>
__device__ __forceinline__ void voice_mix(
    const uint32_t* c, const int (&m)[NF], const float (&w)[NF],
    const float (&gain)[NF], bool amp_curve, float sr_r,
    float (&acc_l)[NF], float (&acc_r)[NF]) {
  const float amp = f32_of(c, K_AMP), bias = f32_of(c, K_BIAS);
  const float lg = f32_of(c, K_LG), rg = f32_of(c, K_RG);
  const float a = f32_of(c, K_A), t2 = f32_of(c, K_T2), t3 = f32_of(c, K_T3);
  const float t4 = f32_of(c, K_T4), sl = f32_of(c, K_SL);
  const float a_r = f32_of(c, K_A_R), d_r = f32_of(c, K_D_R);
  const float r_r = f32_of(c, K_R_R);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
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

// One voice of the tile's list, by its waveform (block-uniform).  The
// curve kernel switches over voice_wave alone: with the curve code once
// per waveform its program would be some ten times as long, fetched once
// a voice-tile, and fetching the code would bound it.
template <bool CURVES, int NF>
__device__ __forceinline__ void eval_voice(
    int code, const uint32_t* c, const uint32_t* __restrict__ consts, int C,
    const float* __restrict__ harm, int harm_stride,
    const float* __restrict__ table, int H, int modes, const Curves& cv,
    const Segments& sg, const Window& win, int vj, const int (&n)[NF],
    float sr_r, float (&acc_l)[NF], float (&acc_r)[NF]) {
  const uint32_t* partials = consts + (size_t)vj * C + kBase;
  const float* hrow = harm + (size_t)vj * harm_stride;
  const float* trow = table + (size_t)vj * kTableLen;
  const bool fm = (code & 0x100) != 0;
  const int wid = code & 0xff;
  int m[NF];
  uint32_t p[NF], inst[NF];
  float gain[NF], w[NF];
  bool amp_curve = false;
  if constexpr (CURVES)
    amp_curve = voice_phase<true, NF>(c, fm, modes, cv, sg, win, (size_t)vj, n,
                                  m, p, inst, gain);
#define VOICE(W)                                                           \
  if constexpr (!CURVES)                                                   \
    voice_phase<false, NF>(c, fm, modes, cv, sg, win, (size_t)vj, n, m,  \
                           p, inst, gain);                                 \
  voice_wave<W, CURVES, NF>(c, partials, hrow, trow, H, n, m, p, inst, w); \
  if constexpr (!CURVES)                                                   \
    voice_mix(c, m, w, gain, false, sr_r, acc_l, acc_r)
  switch (wid) {
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
  if constexpr (CURVES)
    voice_mix(c, m, w, gain, amp_curve, sr_r, acc_l, acc_r);
}

// The curve kernel's window pass for one listed voice and one curve k
// (0 bend, 1 amplitude, 2 depth), by one thread: where the voice carries
// the curve, find the segment at the tile's first note-relative frame
// (upper bound over the sorted starts), read that entry and the kWin after
// it from the per-segment buffer, and count those that start by the tile's
// last frame.  Up to kWin segments are staged in `dst` and the width
// returned; 0 (the tile searches the whole row per frame, counted in
// nwin[1]) for a wider span, a row that is not sorted, or note-relative
// frames that wrap i32 inside the tile; -1 where the voice does not carry
// the curve.
__device__ __forceinline__ int stage_window(
    int k, const uint32_t* c, int wid, int modes, const Curves& cv,
    const Segments& sg, size_t v, uint32_t n_first, uint32_t n_last,
    uint4* dst, int* nwin) {
  const uint32_t flags = c[K_FLAGS];
  const int32_t* st;
  const uint4* row;
  int S;
  bool need, sorted;
  if (k == 0) {
    need = (modes & kUseBend) && (flags & kBend)
           && (c[K_WAVE] != 12u || wid == 9 || wid == 10);
    sorted = (flags & kBendSorted) != 0;
    S = cv.S;
    st = cv.bend_start + v * S;
    row = sg.bend + v * S;
  } else if (k == 1) {
    need = (modes & kUseAmp) && (flags & kAmpCurve);
    sorted = (flags & kAmpSorted) != 0;
    S = cv.KA;
    st = cv.acurve_start + v * S;
    row = sg.amp + v * S;
  } else {
    need = (modes & kUseDmod) && (flags & kDc);
    sorted = (flags & kDcSorted) != 0;
    S = cv.KD;
    st = cv.dcurve_start + v * S;
    row = sg.depth + v * S * 2;
  }
  if (!need) return -1;
  atomicAdd(&nwin[0], 1);
  const int stride = k == 2 ? 2 : 1;
  const int m_first = (int)(n_first - c[K_START]);
  const int m_last = (int)(n_last - c[K_START]);
  int width = 0;
  if (sorted && m_first <= m_last) {
    int cnt = 0, hi = S;
#pragma unroll 1
    while (cnt < hi) {
      const int mid = (cnt + hi) >> 1;
      if (st[mid] <= m_first) cnt = mid + 1; else hi = mid;
    }
    const int first = max(cnt - 1, 0);
    uint4 e[kWin + 1];
#pragma unroll
    for (int w = 0; w <= kWin; ++w)
      e[w] = row[(size_t)min(first + w, S - 1) * stride];
    width = 1;
#pragma unroll
    for (int w = 1; w <= kWin; ++w)
      width += (first + w < S && (int)e[w].x <= m_last) ? 1 : 0;
    if (width > kWin) {
      width = 0;
    } else {
#pragma unroll
      for (int w = 0; w < kWin; ++w) dst[w * stride] = e[w];
      if (k == 2) {
#pragma unroll
        for (int w = 0; w < kWin; ++w)
          dst[2 * w + 1] = row[(size_t)min(first + w, S - 1) * 2 + 1];
      }
    }
  }
  if (width == 0) atomicAdd(&nwin[1], 1);
  return width;
}

// the render's arguments (see voicebank_render below)
struct Render {
  const uint32_t* consts;
  int C;
  const float* harm;
  int harm_stride;
  const float* table;
  Groups groups;
  Curves cv;
  const uint32_t* seg;
  int H, n0, nframes;
  float sr_r;
  int modes;
  const int32_t* idx;
  int K, chunk_frames, V;
  const int32_t* bus;   // per-voice bus [V], or null for one bus
  int nseg;
  float2* out;
  int* counts;
  // the segment buses: the span lists ([spans, nslots] entries, their
  // lengths), tiles a span, and the blocks a tile's frames and buses are
  // split over
  int4* cand;
  int* ncand;
  int span_tiles, fparts, bparts;
};

// one block's tile of the flat render
template <bool CURVES>
__device__ __forceinline__ void render_tile(const Render& r) {
  const uint32_t* __restrict__ consts = r.consts;
  const float* __restrict__ harm = r.harm;
  const float* __restrict__ table = r.table;
  const uint32_t* __restrict__ seg = r.seg;
  const int32_t* __restrict__ idx = r.idx;
  float2* __restrict__ out = r.out;
  int* __restrict__ counts = r.counts;
  const Groups& groups = r.groups;
  const Curves& cv = r.cv;
  const int C = r.C, harm_stride = r.harm_stride, H = r.H, n0 = r.n0;
  const int nframes = r.nframes, modes = r.modes, K = r.K, V = r.V;
  const int chunk_frames = r.chunk_frames;
  const float sr_r = r.sr_r;
  constexpr int kThreads = CURVES ? kCurveThreads : kPlainThreads;
  constexpr int kFrames = kTile / kThreads;     // frames per thread
  constexpr int kWarps = kThreads / 32;
  // the curve kernel stages its list kBatch voices at a time, so that the
  // windows fit beside the constants
  constexpr int kStaged = CURVES ? kBatch : kThreads;
  __shared__ uint32_t s_const[kStaged][kBase];
  __shared__ int s_voice[kThreads];
  __shared__ int s_wid[kThreads];       // wave id | 0x100 if the group has FM
  __shared__ int s_count[kWarps];
  // the block's share of the curve kernel's counters (counts[1..])
  __shared__ int s_nwin[kCounts - 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (CURVES && tid < kCounts - 1) s_nwin[tid] = 0;
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
    if constexpr (CURVES) {
      // the list kBatch voices at a time: their constants and, by one
      // thread per (voice, curve), their windows of curve segments
      __shared__ uint4 s_seg[kBatch][4 * kWin];   // bend, amp, depth x 2
      __shared__ int s_width[kBatch][3];
      const Segments sg = segment_rows(const_cast<uint32_t*>(seg), V, cv);
      for (int b0 = 0; b0 < total; b0 += kBatch) {
        const int nb = min(kBatch, total - b0);
        for (int e = tid; e < nb * kBase; e += kThreads) {
          const int j = e / kBase, k = e - j * kBase;
          s_const[j][k] = consts[(size_t)s_voice[b0 + j] * C + k];
        }
        for (int e = tid; e < nb * 3; e += kThreads) {
          const int j = e / 3, k = e - j * 3;
          const int vj = s_voice[b0 + j];
          s_width[j][k] = stage_window(k, consts + (size_t)vj * C,
                                       s_wid[b0 + j] & 0xff, modes, cv, sg,
                                       (size_t)vj, n_first, n_last,
                                       s_seg[j] + k * kWin, s_nwin);
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
          const int vj = s_voice[b0 + j];
          Window win;
          win.s = s_seg[j];
#pragma unroll
          for (int k = 0; k < 3; ++k) win.width[k] = s_width[j][k];
          eval_voice<true, kFrames>(s_wid[b0 + j], s_const[j], consts, C,
                                    harm, harm_stride, table, H, modes, cv,
                                    sg, win, vj, n, sr_r, acc_l, acc_r);
        }
        __syncthreads();                // the next batch reuses s_*
      }
    } else {
      for (int e = tid; e < total * kBase; e += kThreads) {
        const int j = e / kBase, k = e - j * kBase;
        s_const[j][k] = consts[(size_t)s_voice[j] * C + k];
      }
      __syncthreads();
      for (int j = 0; j < total; ++j)
        eval_voice<false, kFrames>(s_wid[j], s_const[j], consts, C, harm,
                                   harm_stride, table, H, modes, cv,
                                   Segments(), Window(), s_voice[j], n, sr_r,
                                   acc_l, acc_r);
      __syncthreads();                  // the next chunk reuses s_*
    }
    evaluated += total;
  }
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const int i = i0 + f * kThreads + tid;
    if (i < nframes) out[(size_t)i] = make_float2(acc_l[f], acc_r[f]);
  }
  if (tid == 0 && evaluated > 0) atomicAdd(counts, evaluated);
  if (CURVES && tid < kCounts - 1 && s_nwin[tid] > 0)
    atomicAdd(counts + 1 + tid, s_nwin[tid]);
}

// The flat render's exact tile test for a cull-safe voice of the given
// start and envelope end t4: silent on frames [n_first, n_last] iff its
// note-relative frames there do not wrap i32 and lie wholly before its
// start or at or after t4 (see the header).
__device__ __forceinline__ bool silent_on(uint32_t start, float t4,
                                          uint32_t n_first, uint32_t n_last,
                                          float sr_r) {
  const int m_first = (int)(n_first - start);
  const int m_last = (int)(n_last - start);
  return m_first <= m_last
         && ((float)m_last * sr_r < 0.0f || (float)m_first * sr_r >= t4);
}

// The bus render's span pass, one block a span of r.span_tiles tiles: the
// voices that may sound on the span's frames on a bus in [0, nseg), in the
// flat render's slot (packed) order, as entries (voice, key, start, t4's
// bits), key = bus | (wave code & 0x1ff) << kKeyCodeShift | kKeyUnsafe for
// a voice that is not cull-safe, at cand[span * nslots]; their count at
// ncand[span].
__global__ void __launch_bounds__(kSpanThreads)
span_kernel(const __grid_constant__ Render r) {
  constexpr int kWarps = kSpanThreads / 32;
  __shared__ int s_count[kWarps];
  const Groups& groups = r.groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = (long long)blockIdx.x * r.span_tiles * kTile;
  const long long iend = i0 + (long long)r.span_tiles * kTile;
  const long long ilast = (iend < r.nframes ? iend : r.nframes) - 1;
  const uint32_t n_first = (uint32_t)(r.n0 + i0);
  const uint32_t n_last = (uint32_t)(r.n0 + ilast);
  int4* __restrict__ list = r.cand + (size_t)blockIdx.x * groups.nslots;
  int count = 0;
  for (int base = 0; base < groups.nslots; base += kSpanThreads) {
    const int s = base + tid;
    bool keep = false;
    int4 e = make_int4(0, 0, 0, 0);
    if (s < groups.nslots) {
      int g = 0;
      while (g + 1 < groups.n && s >= groups.slot0[g + 1]) ++g;
      const int v = groups.start[g] + (s - groups.slot0[g]);
      const int b = v >= 0 && v < r.V ? r.bus[v] : -1;
      if (b >= 0 && b < r.nseg) {
        const uint32_t* c = r.consts + (size_t)v * r.C;
        const int wid = groups.wid[g] < 0 ? (int)c[K_WAVE] : groups.wid[g];
        const int code = wid | (groups.has_fm[g] ? 0x100 : 0);
        const uint32_t flags = c[K_FLAGS];
        const bool safe = (flags & kSafe)
                          && (wid != 12 || (flags & kPluckSafe));
        const uint32_t start = c[K_START];
        const float t4 = f32_of(c, K_T4);
        keep = !(safe && silent_on(start, t4, n_first, n_last, r.sr_r));
        e = make_int4(v, b | ((code & 0x1ff) << kKeyCodeShift)
                             | (safe ? 0 : kKeyUnsafe),
                      (int)start, __float_as_int(t4));
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = count + __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      pos += k < warp ? s_count[k] : 0;
      total += s_count[k];
    }
    if (keep) list[pos] = e;
    count += total;
    __syncthreads();                    // the next round reuses s_count
  }
  if (tid == 0) r.ncand[blockIdx.x] = count;
}

// One block of the bus render (see the header): a tile or, in a launch of
// few tiles, a contiguous 1/fparts of its frames, strided by the block's
// threads; on the buses [b_lo, b_hi) of its bus part.  Blocks run in tile
// order, bus part fastest.
template <bool CURVES>
__device__ __forceinline__ void render_bus_tile(const Render& r) {
  const uint32_t* __restrict__ consts = r.consts;
  const float* __restrict__ harm = r.harm;
  const float* __restrict__ table = r.table;
  float2* __restrict__ out = r.out;
  const Curves& cv = r.cv;
  const int C = r.C, harm_stride = r.harm_stride, H = r.H, n0 = r.n0;
  const int nframes = r.nframes, modes = r.modes, nseg = r.nseg;
  const float sr_r = r.sr_r;
  constexpr int kThreads = CURVES ? kCurveThreads : kPlainThreads;
  constexpr int kFrames = kTile / kThreads;     // frames per thread
  // voices whose constants (and, with curves, windows) are staged at a time
  constexpr int kStaged = CURVES ? kBatch : kThreads;
  __shared__ uint32_t s_const[kStaged][kBase];
  // the admitted voices, their keys, and their order bus by bus
  __shared__ int s_voice[kBusList];
  __shared__ int s_key[kBusList];
  __shared__ int s_order[kBusList];
  __shared__ int s_count[kThreads / 32];
  __shared__ int s_nwin[kCounts - 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int bp = blockIdx.x % r.bparts;
  const int fp = (blockIdx.x / r.bparts) % r.fparts;
  const int tile = blockIdx.x / (r.bparts * r.fparts);
  const int b_lo = (int)((long long)nseg * bp / r.bparts);
  const int b_hi = (int)((long long)nseg * (bp + 1) / r.bparts);
  const int span = tile / r.span_tiles;
  const int4* __restrict__ cand = r.cand + (size_t)span * r.groups.nslots;
  const int ncand = r.ncand[span];
  const Segments sg = CURVES ? segment_rows(const_cast<uint32_t*>(r.seg),
                                            r.V, cv)
                             : Segments();
  if (CURVES && tid < kCounts - 1) s_nwin[tid] = 0;
  int evaluated = 0;
  // the whole tile's ends for the test and the windows, as the flat
  // render takes them
  const int i0 = tile * kTile;
  const int ilast = min(i0 + kTile, nframes) - 1;
  const uint32_t n_first = (uint32_t)(n0 + i0);
  const uint32_t n_last = (uint32_t)(n0 + ilast);
  const int j0 = i0 + fp * nthreads * kFrames;  // the block's first frame
  int n[kFrames];
  float acc_l[kFrames], acc_r[kFrames];
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    n[f] = n0 + min(j0 + f * nthreads + tid, nframes - 1);
    acc_l[f] = 0.0f;
    acc_r[f] = 0.0f;
  }
  // bus b's sums (or zeros) to out, and back
  auto store = [&](int b, bool zero) {
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int i = j0 + f * nthreads + tid;
      if (i < nframes)
        out[(size_t)i * nseg + b] = zero ? make_float2(0.0f, 0.0f)
                                         : make_float2(acc_l[f], acc_r[f]);
    }
  };
  auto load = [&](int b) {
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int i = j0 + f * nthreads + tid;
      const float2 x = i < nframes ? out[(size_t)i * nseg + b]
                                   : make_float2(0.0f, 0.0f);
      acc_l[f] = x.x;
      acc_r[f] = x.y;
    }
  };
  // at a change of bus: the held bus's sums to out, in the first piece
  // zeros for the buses between, then the new bus's sums from 0 (first
  // piece) or as stored
  auto to_bus = [&](int& cur, int b, bool first) {
    if (cur >= 0) store(cur, false);
    if (first)
      for (int z = cur + 1; z < b; ++z) store(z, true);
    cur = b;
    if (first) {
#pragma unroll
      for (int f = 0; f < kFrames; ++f) acc_l[f] = acc_r[f] = 0.0f;
    } else {
      load(b);
    }
  };
  int next = 0;
  bool first = true;                  // the first piece writes every bus
  do {
    // admit the span's next candidates that may sound in the tile, in
    // packed order, up to kBusList
    int count = 0;
    while (next < ncand && count + nthreads <= kBusList) {
      const int s = next + tid;
      bool active = false;
      int4 e = make_int4(0, 0, 0, 0);
      if (s < ncand) {
        e = cand[s];
        const int b = e.y & 0xffff;
        active = b >= b_lo && b < b_hi
                 && ((e.y & kKeyUnsafe)
                     || !silent_on((uint32_t)e.z, __int_as_float(e.w),
                                   n_first, n_last, sr_r));
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, active);
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int pos = count + __popc(ballot & ((1u << lane) - 1u)), total = 0;
      for (int k = 0; k < nwarps; ++k) {
        pos += k < warp ? s_count[k] : 0;
        total += s_count[k];
      }
      if (active) {
        s_voice[pos] = e.x;
        s_key[pos] = e.y;
      }
      count += total;
      next += nthreads;
      __syncthreads();                // the next round reuses s_count
    }
    // bucket the list stably by bus: entry j goes to the count of
    // entries with a lower bus, or the same bus and a lower index
    for (int j = tid; j < count; j += nthreads) {
      int at = j;
      if (b_hi - b_lo > 1) {
        const int bj = s_key[j] & 0xffff;
        at = 0;
        for (int k = 0; k < count; ++k) {
          const int bk = s_key[k] & 0xffff;
          at += (bk < bj || (bk == bj && k < j)) ? 1 : 0;
        }
      }
      s_order[at] = j;
    }
    __syncthreads();
    // bus after bus; a bus's voices in packed order
    int cur = first ? b_lo : -1;      // the bus the accumulators hold
    for (int b0 = 0; b0 < count; b0 += kStaged) {
      const int nb = min(kStaged, count - b0);
      for (int e = tid; e < nb * kBase; e += nthreads) {
        const int j = e / kBase, k = e - j * kBase;
        s_const[j][k] = consts[(size_t)s_voice[s_order[b0 + j]] * C + k];
      }
      if constexpr (CURVES) {
        __shared__ uint4 s_seg[kBatch][4 * kWin];   // bend, amp, depth x 2
        __shared__ int s_width[kBatch][3];
        for (int e = tid; e < nb * 3; e += nthreads) {
          const int j = e / 3, k = e - j * 3;
          const int at = s_order[b0 + j];
          const int vj = s_voice[at];
          s_width[j][k] = stage_window(
              k, consts + (size_t)vj * C,
              (s_key[at] >> kKeyCodeShift) & 0xff, modes, cv, sg,
              (size_t)vj, n_first, n_last, s_seg[j] + k * kWin, s_nwin);
        }
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
          const int at = s_order[b0 + j];
          const int key = s_key[at];
          if ((key & 0xffff) != cur) to_bus(cur, key & 0xffff, first);
          Window win;
          win.s = s_seg[j];
#pragma unroll
          for (int k = 0; k < 3; ++k) win.width[k] = s_width[j][k];
          eval_voice<true, kFrames>(
              (key >> kKeyCodeShift) & 0x1ff,
              s_const[j], consts, C, harm, harm_stride, table, H, modes,
              cv, sg, win, s_voice[at], n, sr_r, acc_l, acc_r);
        }
      } else {
        __syncthreads();
        for (int j = 0; j < nb; ++j) {
          const int at = s_order[b0 + j];
          const int key = s_key[at];
          if ((key & 0xffff) != cur) to_bus(cur, key & 0xffff, first);
          eval_voice<false, kFrames>(
              (key >> kKeyCodeShift) & 0x1ff,
              s_const[j], consts, C, harm, harm_stride, table, H, modes,
              cv, Segments(), Window(), s_voice[at], n, sr_r, acc_l, acc_r);
        }
      }
      __syncthreads();                // the next batch reuses s_*
    }
    if (cur >= 0) store(cur, false);
    if (first)
      for (int z = cur + 1; z < b_hi; ++z) store(z, true);
    evaluated += count;
    first = false;
  } while (next < ncand);
  if (fp == 0 && tid == 0 && evaluated > 0) atomicAdd(r.counts, evaluated);
  if (CURVES && fp == 0 && tid < kCounts - 1 && s_nwin[tid] > 0)
    atomicAdd(r.counts + 1 + tid, s_nwin[tid]);
}

// The render kernels, each without and with the segment buses: the
// curve-free one keeps the registers the compiler gives it (48, 10 blocks
// an SM; its bus mode 66, 7 blocks: held to 64 it read 3% less on the demo
// song and 3% more on the server's dense batch, held to 56 or 48 it
// spilled); the curve kernel is held to kCurveBlocks blocks an SM, since
// it runs faster with more warps in flight than with more registers each
// (its bus mode at 3 blocks and 80 registers read 11% longer on the MIDI
// bank; both on an H100).  The bus kernels launch with kThreads / fparts
// threads.
template <bool CURVES, bool BUSES>
__global__ void render_kernel(const __grid_constant__ Render r);

template <>
__global__ void __launch_bounds__(kPlainThreads)
render_kernel<false, false>(const __grid_constant__ Render r) {
  render_tile<false>(r);
}

template <>
__global__ void __launch_bounds__(kPlainThreads)
render_kernel<false, true>(const __grid_constant__ Render r) {
  render_bus_tile<false>(r);
}

template <>
__global__ void __launch_bounds__(kCurveThreads, kCurveBlocks)
render_kernel<true, false>(const __grid_constant__ Render r) {
  render_tile<true>(r);
}

template <>
__global__ void __launch_bounds__(kCurveThreads, kCurveBlocks)
render_kernel<true, true>(const __grid_constant__ Render r) {
  render_bus_tile<true>(r);
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
// frames per tile, segments per window, counters.
extern "C" void voicebank_info(int* base_words, int* tile, int* window,
                               int* counts) {
  *base_words = kBase;
  *tile = kTile;
  *window = kWin;
  *counts = kCounts;
}

// Launch the setup kernel on `stream`; returns cudaGetLastError() (0 = ok).
// `cols` is a host array of kCols device pointers (the VoiceParams columns
// in enum Col order), `curves` one of kCurveCols (the curve arrays in
// struct Curves order) and `dims` their widths (S, KA, KD); `consts` is
// [V, C] with C = kBase + 3 * max(H, 1); `seg` is the per-segment buffer
// (struct Segments: 4 * V * (S + KA + 2 * KD) words, 16-byte aligned) or
// null for a bank without curves; the kernel also sets the kCounts
// counters at `counts` to 0.
extern "C" int voicebank_setup(const void* const* cols,
                               const void* const* curves, const int* dims,
                               const float* harm, int harm_stride,
                               const float* table, int V, int H, float sr_r,
                               uint32_t* consts, int C, uint32_t* seg,
                               int* counts, void* stream) {
  if (V <= 0 || H < 0 || C != kBase + 3 * (H > 1 ? H : 1)
      || dims[0] < 1 || dims[1] < 1 || dims[2] < 1)
    return (int)cudaErrorInvalidValue;
  Columns cs;
  for (int k = 0; k < kCols; ++k) cs.p[k] = cols[k];
  setup_kernel<<<(V + kSetupWarps - 1) / kSetupWarps, 32 * kSetupWarps, 0,
                 (cudaStream_t)stream>>>(cs, make_curves(curves, dims), harm,
                                         harm_stride, table, V, H, sr_r,
                                         consts, C, seg, counts);
  return (int)cudaGetLastError();
}

// Launch the render kernel on `stream`; returns cudaGetLastError() after
// the launch (0 = ok).  `groups` is a host array of ngroups (wid, has_fm,
// start, count) rows; `consts`, `seg` and `counts` are the setup kernel's
// outputs (`seg` may be null if `modes` has no curve bit); `modes` holds the
// kGlide/kUseBend/kUseAmp/kUseDmod bits.  With `idx` (device [nchunks,
// K] int32 rows of voice indices, V = an empty slot; one group;
// chunk_frames a multiple of kTile and n0 one of chunk_frames; the wrapper
// checks that the rows cover the window) the tile at absolute frame n
// takes its voices from row n / chunk_frames.  With `bus` (device [V]
// int32 bus ids) the output is [nframes, nseg, 2] and bus b sums only the
// voices whose id is b (a voice with an id outside [0, nseg) sounds on no
// bus): span_kernel first writes the span lists into `spans` (int32,
// 16-byte aligned: spans * nslots int4 entries, then spans counts, for
// spans = ceil(tiles / span_tiles) and nslots the groups' voices), then
// the bus render reads them.  Without `bus` nseg must be 1 and the output
// is [nframes, 2].
extern "C" int voicebank_render(const uint32_t* consts, int C,
                                const float* harm, int harm_stride,
                                const float* table, const int32_t* groups,
                                int ngroups, const void* const* curves,
                                const int* dims, const uint32_t* seg, int H,
                                int n0, int nframes, float sr_r, int modes,
                                const int32_t* idx, int K, int chunk_frames,
                                int V, const int32_t* bus, int nseg,
                                int span_tiles, int32_t* spans, float* out,
                                int* counts, void* stream) {
  const bool curves_on = (modes & (kUseBend | kUseAmp | kUseDmod)) != 0;
  if (ngroups < 1 || ngroups > kMaxGroups || nframes <= 0 || nseg < 1
      || nseg > 65535 || (bus == nullptr && nseg != 1) || (bus && idx)
      || (bus && (span_tiles < 1 || (span_tiles & (span_tiles - 1)) != 0
                  || spans == nullptr))
      || (curves_on && seg == nullptr)
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
  const int tiles = (nframes + kTile - 1) / kTile;
  Render r = {consts, C, harm, harm_stride, table, gs,
              make_curves(curves, dims), seg, H, n0, nframes, sr_r,
              modes, idx, K, chunk_frames, V, bus, nseg,
              reinterpret_cast<float2*>(out), counts};
  cudaStream_t st = (cudaStream_t)stream;
  if (bus) {
    // at least 2 blocks an SM: split a tile's frames (down to a warp a
    // block), then its buses
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = 2LL * sms;
    const int threads = curves_on ? kCurveThreads : kPlainThreads;
    int fparts = 1;
    while ((long long)tiles * fparts < want && threads / (2 * fparts) >= 32)
      fparts *= 2;
    const long long per_bus = (long long)tiles * fparts;
    long long bparts = (want + per_bus - 1) / per_bus;
    bparts = bparts > nseg ? nseg : bparts < 1 ? 1 : bparts;
    const int nspans = (tiles + span_tiles - 1) / span_tiles;
    r.cand = reinterpret_cast<int4*>(spans);
    r.ncand = spans + (size_t)4 * nspans * gs.nslots;
    r.span_tiles = span_tiles;
    r.fparts = fparts;
    r.bparts = (int)bparts;
    span_kernel<<<nspans, kSpanThreads, 0, st>>>(r);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const unsigned blocks = (unsigned)(per_bus * bparts);
    if (curves_on)
      render_kernel<true, true><<<blocks, threads / fparts, 0, st>>>(r);
    else
      render_kernel<false, true><<<blocks, threads / fparts, 0, st>>>(r);
  } else if (curves_on) {
    render_kernel<true, false><<<tiles, kCurveThreads, 0, st>>>(r);
  } else {
    render_kernel<false, false><<<tiles, kPlainThreads, 0, st>>>(r);
  }
  return (int)cudaGetLastError();
}
