// Fused netem -> TBF shaping kernels for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in kubedtn_tpu/ops/pallas/shaping.py:
//
//   K1  shape_step_rows         <- _shape_kernel              (one drop-in step)
//   K2  shape_steps_cols<Given> <- _shape_kernel_steps        (S fused steps)
//   K3  shape_steps_cols<Philox><- _shape_kernel_steps_prng   (S fused steps,
//                                                              in-kernel PRNG)
//
// All three run one device function, `shape_one`, which computes what
// `_tile_step_values` computes for one edge: one packet through netem
// (duplicate -> loss -> corrupt -> delay/jitter -> reorder, AR(1) crandom)
// then TBF (burst max(rate/250, 5000), 50 ms queue drop), masked by
// have_pkt & active. The TPU's [block_rows, 128] tiles are a vector-register
// layout and are not carried over: one thread owns one edge in a 1-D grid,
// so neighbouring threads touch neighbouring addresses.
//
// What bounds them on an H100. K1 is bound by bytes: about a hundred
// operations per edge on ~162 B read and written once, so each kernel
// reads every input once, writes every output once and keeps everything
// else in registers. K2 and K3 keep the state in registers across the S
// steps; per step only depart + flags are written (and K2 reads its 5
// uniforms). K3 draws its uniforms in the thread: Philox4x32-10 keyed
// (seed, 0), counter (edge, step, j, 0), j = 0, 1 — no uniform bytes.
//
// K2 and K3 are bound by the rate the SMs dispatch instructions at, not
// by bytes (kubedtn_tpu_torch/kernel_bench.py; NVIDIA H100 80GB HBM3,
// 700 W). At
// the main path's E = 2^18, S = 10, the first K3 moved 56.6 MB (16.9 us at
// 3.35 TB/s) but ran 155 + 244 S SASS instructions on every edge: two
// Philox calls (~85) and shape_one (~160) per step, 6.8e8 thread
// instructions, ~20 us at one warp instruction per clock on each of the
// 528 schedulers at 1.98 GHz. It took T(S) = 17.4 + 2.1 S us (39.0 us at
// S = 10). Per-block %globaltimer stamps showed its loads were not
// serialised with the steps: a block had its 25 input words 0.2 us after
// it started, then computed for 12 us beside three other blocks, and the
// SMs ended between 28.5 and 33.4 us. So overlapping loads with compute
// had nothing to hide: a persistent grid staging the next tile in shared
// memory (4-byte cp.async per thread, 16-byte cp.async per block, or TMA
// 1-D bulk copies on an mbarrier) measured 42.3-47.3 us, slower than the
// hardware's own scheduling of blocks over SMs.
//
// What K2 and K3 do instead is run fewer instructions, with shape_one,
// Philox and the counter map unchanged:
//   - an inactive edge (act <= 0; 24 % of the main path's capacity) is
//     settled without a step: shape_one masks every outcome with act, so
//     it departs nothing at any step and keeps its state; it reads no
//     props, draws nothing and writes no state;
//   - an active edge calls shape_one with act = true, which the compiler
//     folds into the masks;
//   - step s+1's uniforms are drawn (K3) or loaded (K2) before step s's
//     shape_one, so that their work fills the gaps of its dependent chain.
// K3 now takes 30.6-30.9 us at S = 10 (226 instructions per active edge
// and step) and K2 41.4-41.5 us, against 38.9-39.1 and 49.1 us before
// (PERF.md).
//
// K1 reads the drop-in EdgeState layout as it lies ([E, 13] props, [E, 5]
// corr and uniforms, row-major): a warp's 32 rows are one contiguous
// 1,664-byte stretch, every byte of which the thread block uses, so L1
// serves the 13 strided loads from the same sectors. Transposing props and
// corr first, as the JAX wrapper does for the TPU, would add a full read and
// write of both to every step.
//
// Numerics: built with --fmad=false and without fast math. The plain torch
// versions round every operation separately; contracting
// `u*(1-rho) + last*rho` or `tokens + (start - t_last)*rate` into an FMA
// would drift by one ulp and, at an `x*100 < loss` boundary, flip a flag.
// Constants are double literals cast to float, as torch converts a Python
// number; the one division left is IEEE-exact (-prec-div=true).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NPROP = 13;
constexpr int NCORR = 5;
constexpr int NU = 5;

enum {
  P_LATENCY_US = 0, P_LATENCY_CORR, P_JITTER_US, P_LOSS, P_LOSS_CORR,
  P_RATE_BPS, P_GAP, P_DUPLICATE, P_DUPLICATE_CORR, P_REORDER_PROB,
  P_REORDER_CORR, P_CORRUPT_PROB, P_CORRUPT_CORR
};
enum { C_DELAY = 0, C_LOSS, C_DUP, C_REORDER, C_CORRUPT };
enum { U_LOSS = 0, U_DUP, U_CORRUPT, U_REORDER, U_DELAY };

constexpr int FLAG_DELIVERED = 1;
constexpr int FLAG_DROP_LOSS = 2;
constexpr int FLAG_DROP_QUEUE = 4;
constexpr int FLAG_CORRUPTED = 8;
constexpr int FLAG_DUPLICATED = 16;
constexpr int FLAG_REORDERED = 32;

// rate/250 and rate/8e6 as multiplications by the float reciprocal: XLA
// rewrites the JAX package's divisions by these constants so, and the plain
// versions follow it (kubedtn_tpu_torch/ops/edge_state.py, INV_250).
constexpr float INV_250 = 1.0f / 250.0f;
constexpr float INV_8E6 = 1.0f / 8e6f;

constexpr int THREADS = 256;

struct EdgeDyn {
  float tokens, t_last, next_free;
  float c[NCORR];
  int cnt;
};

// torch.maximum / torch.minimum / clamp: a NaN operand gives NaN.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// netem get_crandom: x' = u*(1-rho) + last*rho; state kept when rho == 0.
__device__ __forceinline__ float crandom(float u, float last, float rho,
                                         float* state) {
  const float one_m = 1.0f - rho;
  const float a = u * one_m;
  const float b = last * rho;
  const float val = a + b;
  *state = rho > 0.0f ? val : last;
  return val;
}

// One packet on one edge through the qdisc chain; updates `st` where
// `act`, returns depart (+inf unless delivered) and the FLAG_* word.
__device__ __forceinline__ void shape_one(const float p[NPROP],
                                          const float u[NU], EdgeDyn& st,
                                          float size, float t_arr, bool act,
                                          float* depart_out, int* flags_out) {
  const float pct = static_cast<float>(1.0 / 100.0);
  const float hundred = 100.0f;

  const float latency = p[P_LATENCY_US];
  const float lat_rho = p[P_LATENCY_CORR] * pct;
  const float jitter = p[P_JITTER_US];
  const float loss = p[P_LOSS];
  const float loss_rho = p[P_LOSS_CORR] * pct;
  const float rate = p[P_RATE_BPS];
  const int gap = static_cast<int>(p[P_GAP]);
  const float dup = p[P_DUPLICATE];
  const float dup_rho = p[P_DUPLICATE_CORR] * pct;
  const float reorder = p[P_REORDER_PROB];
  const float reo_rho = p[P_REORDER_CORR] * pct;
  const float corrupt = p[P_CORRUPT_PROB];
  const float cor_rho = p[P_CORRUPT_CORR] * pct;

  const float c_delay = st.c[C_DELAY], c_loss = st.c[C_LOSS],
              c_dup = st.c[C_DUP], c_reo = st.c[C_REORDER],
              c_cor = st.c[C_CORRUPT];

  // -- netem stage (sch_netem enqueue order) --------------------------
  float dup_state;
  const float x_dup = crandom(u[U_DUP], c_dup, dup_rho, &dup_state);
  const bool dup_hit = (dup > 0.0f) && (x_dup * hundred < dup);
  if (!(dup > 0.0f)) dup_state = c_dup;

  float loss_state;
  const float x_loss = crandom(u[U_LOSS], c_loss, loss_rho, &loss_state);
  const bool loss_hit = (loss > 0.0f) && (x_loss * hundred < loss);
  if (!(loss > 0.0f)) loss_state = c_loss;

  bool dropped = loss_hit && !dup_hit;
  bool duplicated = dup_hit && !loss_hit;
  const bool survives = !dropped;

  float cor_state;
  const float x_cor = crandom(u[U_CORRUPT], c_cor, cor_rho, &cor_state);
  bool corrupted = (corrupt > 0.0f) && (x_cor * hundred < corrupt) && survives;
  if (!((corrupt > 0.0f) && survives)) cor_state = c_cor;

  float del_state;
  const float x_del = crandom(u[U_DELAY], c_delay, lat_rho, &del_state);
  float delay = latency;
  if (jitter > 0.0f) {
    const float two_x = 2.0f * x_del;
    const float centred = two_x - 1.0f;
    const float spread = jitter * centred;
    delay = latency + spread;
  }
  delay = tmax(delay, 0.0f);
  if (!((jitter > 0.0f) && survives)) del_state = c_delay;

  float reo_state;
  const float x_reo = crandom(u[U_REORDER], c_reo, reo_rho, &reo_state);
  const bool reorder_on = reorder > 0.0f;
  const bool candidate = (gap == 0) || (st.cnt >= gap - 1);
  bool do_reorder = reorder_on && candidate && (x_reo * hundred <= reorder) &&
                    survives;
  if (!(reorder_on && candidate && survives)) reo_state = c_reo;

  if (do_reorder) delay = 0.0f;
  const int new_cnt = do_reorder ? 0 : (survives ? st.cnt + 1 : st.cnt);

  // -- TBF stage --------------------------------------------------------
  const float t_ready = t_arr + delay;
  const bool rate_on = rate > 0.0f;
  const float rate_b_us = rate * INV_8E6;
  const float burst = tmax(rate * INV_250, 5000.0f);
  const float start = tmax(t_ready, st.next_free);
  const float refill_rate = rate_on ? rate_b_us : 0.0f;
  const float elapsed = start - st.t_last;
  const float refill = elapsed * refill_rate;
  const float filled = st.tokens + refill;
  const float avail = tmin(burst, filled);
  const float need = size - avail;
  const float wait =
      need > 0.0f ? need / tmax(rate_b_us, static_cast<float>(1e-30)) : 0.0f;
  const float depart = start + wait;
  const float queued = depart - t_ready;
  bool drop_q = rate_on && (queued > 50000.0f);  // tc "latency 50ms"
  const bool accept = rate_on && !drop_q;
  float new_tokens = accept ? tmax(avail - size, 0.0f) : st.tokens;
  float new_t_last = accept ? depart : st.t_last;
  float new_next_free = accept ? depart : st.next_free;
  const float t_depart = rate_on ? depart : t_ready;

  // a netem-dropped packet never reaches TBF
  if (dropped) {
    new_tokens = st.tokens;
    new_t_last = st.t_last;
    new_next_free = st.next_free;
  }
  drop_q = drop_q && !dropped;
  bool delivered = !dropped && !drop_q;

  // -- lane mask + packed outputs ----------------------------------------
  delivered = delivered && act;
  dropped = dropped && act;
  drop_q = drop_q && act;
  corrupted = corrupted && delivered;
  duplicated = duplicated && delivered;
  do_reorder = do_reorder && delivered;

  *depart_out = delivered ? t_depart : __int_as_float(0x7f800000);  // +inf
  *flags_out = (delivered ? FLAG_DELIVERED : 0) |
               (dropped ? FLAG_DROP_LOSS : 0) |
               (drop_q ? FLAG_DROP_QUEUE : 0) |
               (corrupted ? FLAG_CORRUPTED : 0) |
               (duplicated ? FLAG_DUPLICATED : 0) |
               (do_reorder ? FLAG_REORDERED : 0);
  if (act) {
    st.tokens = new_tokens;
    st.t_last = new_t_last;
    st.next_free = new_next_free;
    st.c[C_DELAY] = del_state;
    st.c[C_LOSS] = loss_state;
    st.c[C_DUP] = dup_state;
    st.c[C_REORDER] = reo_state;
    st.c[C_CORRUPT] = cor_state;
    st.cnt = new_cnt;
  }
}

// K1: the drop-in step on the EdgeState layout. The state outputs may
// alias the inputs (the donating caller updates in place): each thread
// reads its own row before it writes it.
__global__ void __launch_bounds__(THREADS)
shape_step_rows(const float* __restrict__ props, const float* corr_in,
                const float* __restrict__ u, const float* tokens_in,
                const float* t_last_in, const float* backlog_in,
                const int* count_in, const float* __restrict__ sizes,
                const float* __restrict__ t_arr,
                const uint8_t* __restrict__ have,
                const uint8_t* __restrict__ active,
                float* __restrict__ depart, int* __restrict__ flags,
                float* tokens_out, float* t_last_out, float* backlog_out,
                float* corr_out, int* count_out, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t row = static_cast<size_t>(e);
  float p[NPROP];
#pragma unroll
  for (int k = 0; k < NPROP; ++k) p[k] = props[row * NPROP + k];
  float uu[NU];
#pragma unroll
  for (int k = 0; k < NU; ++k) uu[k] = u[row * NU + k];
  EdgeDyn st;
  st.tokens = tokens_in[e];
  st.t_last = t_last_in[e];
  st.next_free = backlog_in[e];
#pragma unroll
  for (int k = 0; k < NCORR; ++k) st.c[k] = corr_in[row * NCORR + k];
  st.cnt = count_in[e];
  const bool act = have[e] != 0 && active[e] != 0;

  float d;
  int f;
  shape_one(p, uu, st, sizes[e], t_arr[e], act, &d, &f);
  depart[e] = d;
  flags[e] = f;
  tokens_out[e] = st.tokens;
  t_last_out[e] = st.t_last;
  backlog_out[e] = st.next_free;
#pragma unroll
  for (int k = 0; k < NCORR; ++k) corr_out[row * NCORR + k] = st.c[k];
  count_out[e] = st.cnt;
}

// Uniform sources of the fused kernels.
struct GivenUniforms {  // K2: u[(s*NU + k)*E + e]
  const float* u;
  __device__ __forceinline__ void draw(int e, int s, int E,
                                       float out[NU]) const {
#pragma unroll
    for (int k = 0; k < NU; ++k)
      out[k] = u[(static_cast<size_t>(s) * NU + k) * E + e];
  }
};

// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// 24 random bits -> [0, 1) on the 2^-24 grid. The shift is on an unsigned
// word, so it is logical: no draw can come out negative (the sign-bit trap
// of the TPU kernel's signed PRNG bits).
__device__ __forceinline__ float bits_to_uniform(uint32_t x) {
  return static_cast<float>(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

struct PhiloxUniforms {  // K3: key (seed, 0), counter (e, s, j, 0)
  uint32_t seed;
  __device__ __forceinline__ void draw(int e, int s, int /*E*/,
                                       float out[NU]) const {
    uint32_t a[4] = {static_cast<uint32_t>(e), static_cast<uint32_t>(s), 0u,
                     0u};
    philox4x32_10(a, seed, 0u);
    uint32_t b[4] = {static_cast<uint32_t>(e), static_cast<uint32_t>(s), 1u,
                     0u};
    philox4x32_10(b, seed, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = bits_to_uniform(a[k]);
    out[4] = bits_to_uniform(b[0]);
  }
};

// K2 / K3: S steps with the state in registers, on the column-major tiled
// state ([NPROP, E] props, [NCORR, E] corr, [E] vectors), updated in
// place. sizes, t_arr and act stay fixed across the steps.
//
// An inactive edge (act <= 0) is settled without a step: shape_one masks
// every outcome with act and updates the state only where act, so such an
// edge departs nothing (+inf, no flags) at every step and keeps its state.
// It reads no props, draws nothing and writes no state. An active edge
// runs shape_one with act = true, which the compiler folds into the
// masks. Either way the results are shape_one's, bit for bit.
template <class Uniforms>
__global__ void __launch_bounds__(THREADS)
shape_steps_cols(Uniforms uni, const float* __restrict__ props, float* corr,
                 float* tokens, float* t_last, float* backlog, int* count,
                 const float* __restrict__ sizes,
                 const float* __restrict__ t_arr,
                 const int* __restrict__ act_in, float* __restrict__ depart,
                 int* __restrict__ flags, int E, int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  if (act_in[e] <= 0) {
    for (int s = 0; s < S; ++s) {
      depart[static_cast<size_t>(s) * E + e] = __int_as_float(0x7f800000);
      flags[static_cast<size_t>(s) * E + e] = 0;
    }
    return;
  }
  float p[NPROP];
#pragma unroll
  for (int k = 0; k < NPROP; ++k) p[k] = props[static_cast<size_t>(k) * E + e];
  EdgeDyn st;
  st.tokens = tokens[e];
  st.t_last = t_last[e];
  st.next_free = backlog[e];
#pragma unroll
  for (int k = 0; k < NCORR; ++k)
    st.c[k] = corr[static_cast<size_t>(k) * E + e];
  st.cnt = count[e];
  const float size = sizes[e];
  const float ta = t_arr[e];

  // step s+1's uniforms do not depend on step s: draw (or load) them
  // before shape_one, so that their work overlaps its dependent chain
  float uu[NU];
  uni.draw(e, 0, E, uu);
  for (int s = 0; s < S; ++s) {
    float nxt[NU];
    if (s + 1 < S) uni.draw(e, s + 1, E, nxt);
    float d;
    int f;
    shape_one(p, uu, st, size, ta, true, &d, &f);
    depart[static_cast<size_t>(s) * E + e] = d;
    flags[static_cast<size_t>(s) * E + e] = f;
#pragma unroll
    for (int k = 0; k < NU; ++k) uu[k] = nxt[k];
  }
  tokens[e] = st.tokens;
  t_last[e] = st.t_last;
  backlog[e] = st.next_free;
#pragma unroll
  for (int k = 0; k < NCORR; ++k)
    corr[static_cast<size_t>(k) * E + e] = st.c[k];
  count[e] = st.cnt;
}

inline int blocks_for(int E) { return (E + THREADS - 1) / THREADS; }

}  // namespace

// ---- plain C interface (ctypes); each returns cudaGetLastError() --------

extern "C" int kdt_shape_step_rows(
    const float* props, const float* corr_in, const float* u,
    const float* tokens_in, const float* t_last_in, const float* backlog_in,
    const int* count_in, const float* sizes, const float* t_arr,
    const uint8_t* have, const uint8_t* active, float* depart, int* flags,
    float* tokens_out, float* t_last_out, float* backlog_out,
    float* corr_out, int* count_out, int E, void* stream) {
  shape_step_rows<<<blocks_for(E), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      props, corr_in, u, tokens_in, t_last_in, backlog_in, count_in, sizes,
      t_arr, have, active, depart, flags, tokens_out, t_last_out,
      backlog_out, corr_out, count_out, E);
  return static_cast<int>(cudaGetLastError());
}

// K2 / K3 on `stream`; the state (corr, tokens, t_last, backlog, count)
// is read and written in place.
extern "C" int kdt_shape_steps_cols(
    const float* u, const float* props, float* corr, float* tokens,
    float* t_last, float* backlog, int* count, const float* sizes,
    const float* t_arr, const int* act, float* depart, int* flags, int E,
    int S, void* stream) {
  shape_steps_cols<GivenUniforms><<<blocks_for(E), THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      GivenUniforms{u}, props, corr, tokens, t_last, backlog, count, sizes,
      t_arr, act, depart, flags, E, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kdt_shape_steps_cols_philox(
    uint32_t seed, const float* props, float* corr, float* tokens,
    float* t_last, float* backlog, int* count, const float* sizes,
    const float* t_arr, const int* act, float* depart, int* flags, int E,
    int S, void* stream) {
  shape_steps_cols<PhiloxUniforms><<<blocks_for(E), THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      PhiloxUniforms{seed}, props, corr, tokens, t_last, backlog, count,
      sizes, t_arr, act, depart, flags, E, S);
  return static_cast<int>(cudaGetLastError());
}
