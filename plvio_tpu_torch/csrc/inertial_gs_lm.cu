// inertial_gs_lm — the dense LM of the IMU initialization and of the
// scale / gravity refinement in one launch: gravity direction R_wg (2
// DoF), scale (1), the shared gyro and accelerometer biases (3 + 3) and
// the keyframes' velocities (3 each) with the poses fixed, through the
// inertial edge with free gravity and scale on every link of the chain.
//
// Replaces plvio_tpu/models/kernels.py `make_inertial_init` (:1137; with
// the bias priors of information prior_g, prior_a) and `make_scale_refine`
// (:1092; only R_wg and the scale free), each running
// plvio_tpu/solver/engine.py `Problem.build_normal_equations` (:355),
// `solve_step`'s Cholesky solve (:555-557) and `optimize` without early
// exit (:697), on the residuals `make_inertial_gs` and `state_prior`
// (solver/residuals.py:348,308) with the retractions `retract_gdir` and
// `retract_scale` (:72,78).  The JAX version differentiates the edge by
// jacfwd, scatters each link's blocks into H and factors it with LAPACK's
// Cholesky, every iteration a separate XLA program step.
//
// What bounds it on the H100: latency.  At the cap of 32 keyframes (S = 9
// + 96 = 105 states, 31 links) an iteration is ~0.1 Mflop of edges, a
// 105 x 105 Cholesky (~0.4 Mflop) and two triangular solves: a few
// microseconds of arithmetic, in 20 (init) or 12 (refine) sequential
// iterations.  So the whole loop is one block, its system (44 KB), the
// links' blocks, the constants and the states in shared memory, and
// nothing returns to the host in between.
//
// Design: a warp per link (links strided over 8 warps): lane 0 evaluates
// the 9-dim residual and its analytic 9 x 15 Jacobian over (gdir, scale,
// bg, ba, v1, v2) (d g_w / d gdir = -R_wg hat(g0), d s / d ds = s, the
// rotation rows as csrc/inertial.cuh `inertial_edge`), the lanes whiten
// one column each by L^T of the link's information (factored once) and
// form the link's packed 15 x 15 block, g and cost, times the edge's mask.
// The dense H is assembled entry by entry, each summing its links in link
// order (the shared states' entries over all links, a velocity's block
// from links k-1 and k), then the bias priors; damped as H + diag(diag(H)
// lambda + 1e-6), the fixed states frozen (unit diagonal, zero rhs),
// factored by a right-looking Cholesky in place (one column a step, the
// trailing update spread over the block) and solved by two column-oriented
// triangular solves.  A pivot that is not positive makes the step NaN, as
// the reference's cho_factor does, and the step is then rejected.  The
// accept / reject and the lambda schedule are the reference's (accept if
// the cost fell; lambda x 0.5 or x 4 within [1e-8, 1e4]).
#include "inertial.cuh"

namespace {

using namespace plv;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoc = 120 + 15 + 1;       // packed 15x15 upper, g, cost
constexpr int kScr = 9 * 16;             // J [9][15] | r as column 15

struct Params {
  const float* state;    // Rwg 9, scale 1, bg 3, ba 3, vel 3 n
  const float* pre;      // [n-1, 67]
  const float* poses;    // [n, 12]: R (9) p (3)
  const float* info;     // [n-1, 81]
  const uint8_t* valid;  // [n-1]
  int n, iters, refine;
  float gravity, prior_g, prior_a;
  float* out;            // as state
};

struct Smem {
  float *H, *g, *y, *loc, *L, *pre, *poses, *st, *cand, *scr, *red;
  int S, n, ne, nst;
};

__device__ Smem carve(float* base, int n) {
  Smem m;
  m.n = n;
  m.ne = n - 1;
  m.S = 9 + 3 * n;
  m.nst = 16 + 3 * n;
  m.H = base;
  m.g = m.H + m.S * m.S;
  m.y = m.g + m.S;
  m.loc = m.y + m.S;
  m.L = m.loc + m.ne * kLoc;
  m.pre = m.L + m.ne * 81;
  m.poses = m.pre + m.ne * 67;
  m.st = m.poses + n * 12;
  m.cand = m.st + m.nst;
  m.scr = m.cand + m.nst;
  m.red = m.scr + kWarps * kScr;       // [8]: cost, lam, cost_prev, ok
  return m;
}

// residual (and Jacobian, columns 0..14 of a row of 16) of link i at the
// state x
__device__ void gs_edge(const Params& p, const Smem& m, const float* x,
                        int i, bool jac, float* J) {
  const float* Rwg = x;
  const float s = x[9];
  const float* bg = x + 10;
  const float* ba = x + 13;
  const float* v1 = x + 16 + 3 * i;
  const float* v2 = v1 + 3;
  const float* P1 = m.poses + 12 * i;
  const float* P2 = P1 + 12;
  const float* R1 = P1;
  const float* p1 = P1 + 9;
  const float* R2 = P2;
  const float* p2 = P2 + 9;
  Pre q;
  load_pre(m.pre + 67 * i, q);
  const float g0[3] = {0.f, 0.f, -p.gravity};
  float dbg[3], dba[3], gw[3];
  for (int k = 0; k < 3; ++k) {
    dbg[k] = bg[k] - q.bg0[k];
    dba[k] = ba[k] - q.ba0[k];
  }
  mv3(Rwg, g0, gw);
  float phi[3], Ephi[9], dRc[9], R1dRc[9], E[9], er[3];
  mv3(q.JRg, dbg, phi);
  so3_exp(phi, Ephi);
  mul3(q.dR, Ephi, dRc);
  mul3(R1, dRc, R1dRc);
  mul3tn(R1dRc, R2, E);                   // dR_corr^T R1^T R2
  so3_log(E, er);
  const float dT = q.dT;
  float dv[3], dp[3], av[3], ap[3], t3[3], u3[3], u4[3], a3[3];
  for (int k = 0; k < 3; ++k) {
    dv[k] = v2[k] - v1[k];
    dp[k] = p2[k] - p1[k] - v1[k] * dT;
    av[k] = s * dv[k] - gw[k] * dT;
    ap[k] = s * dp[k] - 0.5f * gw[k] * dT * dT;
  }
  mtv3(R1, av, t3);
  mv3(q.JVg, dbg, u3);
  mv3(q.JVa, dba, u4);
  for (int k = 0; k < 3; ++k)
    J[(3 + k) * 16 + 15] = t3[k] - (q.dV[k] + u3[k] + u4[k]);
  mtv3(R1, ap, a3);
  mv3(q.JPg, dbg, u3);
  mv3(q.JPa, dba, u4);
  for (int k = 0; k < 3; ++k) {
    J[k * 16 + 15] = er[k];
    J[(6 + k) * 16 + 15] = a3[k] - (q.dP[k] + u3[k] + u4[k]);
  }
  if (!jac) return;
  for (int d = 0; d < 9; ++d)
    for (int c = 0; c < 15; ++c) J[d * 16 + c] = 0.f;
  float Jri[9], Jr[9], EtJr[9], EtJrJ[9], N[9];
  so3_jr_inv(er, Jri);
  so3_jr(phi, Jr);
  mul3tn(E, Jr, EtJr);                    // E^T Jr
  mul3(EtJr, q.JRg, EtJrJ);
  mul3(Jri, EtJrJ, N);                    // d er / d bg = -N
  float Hg[9], RH[9], G[9];               // G = R1^T Rwg hat(g0)
  hat3(g0, Hg);
  mul3(Rwg, Hg, RH);
  mul3tn(R1, RH, G);
  float sdv[3], sdp[3], R1sdv[3], R1sdp[3];
  for (int k = 0; k < 3; ++k) {
    sdv[k] = s * dv[k];
    sdp[k] = s * dp[k];
  }
  mtv3(R1, sdv, R1sdv);
  mtv3(R1, sdp, R1sdp);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 2; ++c) {
      J[(3 + r) * 16 + c] = G[3 * r + c] * dT;
      J[(6 + r) * 16 + c] = G[3 * r + c] * (0.5f * dT * dT);
    }
    J[(3 + r) * 16 + 2] = R1sdv[r];
    J[(6 + r) * 16 + 2] = R1sdp[r];
    for (int c = 0; c < 3; ++c) {
      const float R1t = R1[3 * c + r];
      J[r * 16 + 3 + c] = -N[3 * r + c];
      J[(3 + r) * 16 + 3 + c] = -q.JVg[3 * r + c];
      J[(3 + r) * 16 + 6 + c] = -q.JVa[3 * r + c];
      J[(3 + r) * 16 + 9 + c] = -s * R1t;
      J[(3 + r) * 16 + 12 + c] = s * R1t;
      J[(6 + r) * 16 + 3 + c] = -q.JPg[3 * r + c];
      J[(6 + r) * 16 + 6 + c] = -q.JPa[3 * r + c];
      J[(6 + r) * 16 + 9 + c] = -s * dT * R1t;
    }
  }
}

// every link's block, g and cost (jac) or its cost alone, at state x;
// then the total cost (links in order, then the priors) into red[0]
__device__ void links(const Params& p, Smem& m, const float* x, bool jac) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* J = m.scr + warp * kScr;
  for (int i = warp; i < m.ne; i += kWarps) {
    if (lane == 0) gs_edge(p, m, x, i, jac, J);
    __syncwarp();
    const float* L = m.L + 81 * i;
    if (lane < 16 && (jac || lane == 15))
      for (int d = 0; d < 9; ++d) {
        float v = 0.f;
        for (int e = d; e < 9; ++e) v += L[e * 9 + d] * J[e * 16 + lane];
        J[d * 16 + lane] = v;
      }
    __syncwarp();
    const float w = p.valid[i] ? 1.f : 0.f;
    float* loc = m.loc + kLoc * i;
    if (lane == 0) {
      float c = 0.f;
      for (int d = 0; d < 9; ++d) c += J[d * 16 + 15] * J[d * 16 + 15];
      loc[135] = w * c;
    }
    if (jac)
      for (int e = lane; e < 135; e += 32) {
        int a, c;
        if (e < 120) {
          a = 0;
          int rem = e;
          while (rem >= 15 - a) {
            rem -= 15 - a;
            ++a;
          }
          c = a + rem;
        } else {
          a = e - 120;
          c = 15;                         // g: -w J^T r
        }
        float v = 0.f;
        for (int d = 0; d < 9; ++d) v += J[d * 16 + a] * J[d * 16 + c];
        loc[e] = c == 15 ? -(w * v) : w * v;
      }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int i = 0; i < m.ne; ++i) c += m.loc[kLoc * i + 135];
    if (!p.refine) {
      const float sg = sqrtf(p.prior_g), sa = sqrtf(p.prior_a);
      float cg = 0.f, ca = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float rg = x[10 + k] * sg, ra = x[13 + k] * sa;
        cg += rg * rg;
        ca += ra * ra;
      }
      c = (c + cg) + ca;
    }
    m.red[0] = c;
  }
  __syncthreads();
}

// a link's packed block entry (a <= c local; c = 15 reads g)
__device__ __forceinline__ float loc_at(const Smem& m, int i, int a, int c) {
  const float* loc = m.loc + kLoc * i;
  if (c == 15) return loc[120 + a];
  if (a > c) {
    const int t = a;
    a = c;
    c = t;
  }
  return loc[a * 15 - a * (a - 1) / 2 + (c - a)];
}

// the contributions of dense index d: (link, local) pairs in link order
__device__ __forceinline__ int contrib(const Smem& m, int d, int* li,
                                      int* ll) {
  if (d < 9) return -1;                     // every link, local d
  const int k = (d - 9) / 3, c = (d - 9) % 3;
  int n = 0;
  if (k > 0) {
    li[n] = k - 1;
    ll[n++] = 12 + c;
  }
  if (k < m.ne) {
    li[n] = k;
    ll[n++] = 9 + c;
  }
  return n;
}

// H (full, undamped) and g at the state of the last `links(.., true)`
__device__ void assemble(const Params& p, Smem& m) {
  const int S = m.S;
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int a = e / S, b = e % S;
    if (a > b) continue;
    float v = 0.f;
    int ia[2], la[2], ib[2], lb[2];
    const int na = contrib(m, a, ia, la), nb = contrib(m, b, ib, lb);
    if (na < 0 && nb < 0) {
      for (int i = 0; i < m.ne; ++i) v += loc_at(m, i, a, b);
    } else if (na < 0 || nb < 0) {
      const int s = na < 0 ? a : b;       // the shared one
      const int* li = na < 0 ? ib : ia;
      const int* ll = na < 0 ? lb : la;
      const int nn = na < 0 ? nb : na;
      for (int t = 0; t < nn; ++t) v += loc_at(m, li[t], s, ll[t]);
    } else {
      for (int t = 0; t < na; ++t)
        for (int u = 0; u < nb; ++u)
          if (ia[t] == ib[u]) v += loc_at(m, ia[t], la[t], lb[u]);
    }
    m.H[a * S + b] = v;
    m.H[b * S + a] = v;
  }
  for (int a = threadIdx.x; a < S; a += blockDim.x) {
    float v = 0.f;
    int li[2], ll[2];
    const int na = contrib(m, a, li, ll);
    if (na < 0) {
      for (int i = 0; i < m.ne; ++i) v += loc_at(m, i, a, 15);
    } else {
      for (int t = 0; t < na; ++t) v += loc_at(m, li[t], ll[t], 15);
    }
    m.g[a] = v;
  }
  __syncthreads();
  if (!p.refine && threadIdx.x < 6) {       // the bias priors (J = s I)
    const int a = 3 + threadIdx.x;
    const float s = sqrtf(threadIdx.x < 3 ? p.prior_g : p.prior_a);
    m.H[a * S + a] = m.H[a * S + a] + s * s;
    m.g[a] = m.g[a] - s * (m.st[10 + threadIdx.x] * s);
  }
  __syncthreads();
}

__device__ __forceinline__ float free_of(const Params& p, int a) {
  return (!p.refine || a < 3) ? 1.f : 0.f;
}

// damped, frozen system; Cholesky in place; dx into m.y; candidate state
__device__ void solve_retract(const Params& p, Smem& m) {
  const int S = m.S;
  const float lam = m.red[1];
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int a = e / S, b = e % S;
    float h = m.H[e];
    if (a == b) h = h + (h * lam + 1e-6f);
    m.H[e] = h * free_of(p, a) * free_of(p, b)
        + (a == b ? 1.f - free_of(p, a) : 0.f);
  }
  for (int a = threadIdx.x; a < S; a += blockDim.x)
    m.y[a] = m.g[a] * free_of(p, a);
  if (threadIdx.x == 0) m.red[3] = 1.f;
  __syncthreads();
  for (int j = 0; j < S; ++j) {               // right-looking Cholesky
    if (threadIdx.x == 0) {
      const float d = m.H[j * S + j];
      if (!(d > 0.f)) m.red[3] = 0.f;
      m.H[j * S + j] = sqrtf(d);
    }
    __syncthreads();
    const float ljj = m.H[j * S + j];
    for (int i = j + 1 + threadIdx.x; i < S; i += blockDim.x)
      m.H[i * S + j] = m.H[i * S + j] / ljj;
    __syncthreads();
    const int rem = S - j - 1;
    for (int e = threadIdx.x; e < rem * rem; e += blockDim.x) {
      const int i = j + 1 + e / rem, k = j + 1 + e % rem;
      if (k <= i) m.H[i * S + k] = m.H[i * S + k] - m.H[i * S + j] * m.H[k * S + j];
    }
    __syncthreads();
  }
  for (int j = 0; j < S; ++j) {               // L y = rhs
    if (threadIdx.x == 0) m.y[j] = m.y[j] / m.H[j * S + j];
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < S; i += blockDim.x)
      m.y[i] = m.y[i] - m.H[i * S + j] * m.y[j];
    __syncthreads();
  }
  for (int j = S - 1; j >= 0; --j) {          // L^T dx = y
    if (threadIdx.x == 0) m.y[j] = m.y[j] / m.H[j * S + j];
    __syncthreads();
    for (int i = threadIdx.x; i < j; i += blockDim.x)
      m.y[i] = m.y[i] - m.H[j * S + i] * m.y[j];
    __syncthreads();
  }
  const bool ok = m.red[3] != 0.f;
  for (int a = threadIdx.x; a < S; a += blockDim.x)
    m.y[a] = (ok ? m.y[a] : __int_as_float(0x7fc00000)) * free_of(p, a);
  __syncthreads();
  if (threadIdx.x == 0) {
    // gdir: R <- normalize(R Exp(dx0, dx1, 0)); scale: s exp(ds)
    const float d3[3] = {m.y[0], m.y[1], 0.f};
    float Ed[9], Rn[9];
    so3_exp(d3, Ed);
    mul3(m.st, Ed, Rn);
    so3_normalize(Rn, m.cand);
    m.cand[9] = m.st[9] * expf(m.y[2]);
  }
  for (int a = 3 + threadIdx.x; a < S; a += blockDim.x)
    m.cand[7 + a] = m.st[7 + a] + m.y[a];   // bg, ba, vel additive
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) gs_lm_kernel(Params p) {
  extern __shared__ float base[];
  Smem m = carve(base, p.n);
  for (int e = threadIdx.x; e < m.ne * 67; e += blockDim.x)
    m.pre[e] = p.pre[e];
  for (int e = threadIdx.x; e < m.n * 12; e += blockDim.x)
    m.poses[e] = p.poses[e];
  for (int e = threadIdx.x; e < m.nst; e += blockDim.x) m.st[e] = p.state[e];
  for (int i = threadIdx.x; i < m.ne; i += blockDim.x)
    cholesky(p.info + 81 * i, m.L + 81 * i, 9);
  __syncthreads();
  links(p, m, m.st, false);
  if (threadIdx.x == 0) {
    m.red[2] = m.red[0];                    // cost_prev
    m.red[1] = 1e-4f;                       // lambda
  }
  __syncthreads();
  for (int it = 0; it < p.iters; ++it) {
    links(p, m, m.st, true);
    assemble(p, m);
    solve_retract(p, m);
    links(p, m, m.cand, false);
    const float nc = m.red[0], prev = m.red[2];
    const bool acc = nc < prev;
    if (acc)
      for (int e = threadIdx.x; e < m.nst; e += blockDim.x)
        m.st[e] = m.cand[e];
    __syncthreads();
    if (threadIdx.x == 0) {
      const float lam = acc ? m.red[1] * 0.5f : m.red[1] * 4.f;
      m.red[1] = fminf(fmaxf(lam, 1e-8f), 1e4f);
      m.red[2] = acc ? nc : prev;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < m.nst; e += blockDim.x) p.out[e] = m.st[e];
}

inline size_t smem_floats(int n) {
  const int S = 9 + 3 * n, ne = n - 1;
  return size_t(S) * S + 2 * S + size_t(ne) * (kLoc + 81 + 67) + 12 * n
      + 2 * (16 + 3 * n) + kWarps * kScr + 8;
}

}  // namespace

PLVIO_API int inertial_gs_lm(const void* state, const void* pre,
                             const void* poses, const void* info,
                             const void* valid, int n, int iters, int refine,
                             float gravity, float prior_g, float prior_a,
                             void* out, void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(state), static_cast<const float*>(pre),
           static_cast<const float*>(poses), static_cast<const float*>(info),
           static_cast<const uint8_t*>(valid), n, iters, refine, gravity,
           prior_g, prior_a, static_cast<float*>(out)};
  const size_t smem = smem_floats(n) * sizeof(float);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      gs_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gs_lm_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
