// Hopper kernels for one scanline pass of the ADA two-pass affine warp.
//
// Replaces the Pallas TPU kernels of style_big_gan_tpu/ops/warp_pallas.py:
//   warp_fwd  <- _fwd_kernel (warp_pallas.py:67-81)
//   warp_adj  <- _bwd_kernel (warp_pallas.py:84-99)
//
// Function (per image n; src [n,A,L], pos [n,V] f32, shift [n,L] f32):
//   p      = clamp(pos[v], 0, A-1),  i0 = floor(p)
//   w0     = max(0, 1 - |p - i0|)
//   w1     = max(0, 1 - |p - (i0+1)|)       (0 when i0+1 > A-1)
//   idx_l  = floor(shift_l) & ((1 << bits) - 1)
//   f_l    = shift_l - floor(shift_l)
//   cur[i,l] = (1-f_l) * src[min(i+idx_l, A-1), l]
//            +    f_l  * src[min(i+1+idx_l, A-1), l]
//   out[v,l] = w0 * cur[i0,l] + w1 * cur[i0+1,l]        (f32, one rounding)
// and its exact adjoint out[A,L] = S^T (T^T g).  w0 and w1 are rounded to
// the working type before use, so they equal the entries of the dense tent
// T[v,i] = max(0, 1 - |p - i|) that the JAX kernel multiplies on the MXU.
//
// Bound on the H100 (3.35 TB/s): every tent row has at most two non-zeros,
// so each output reads at most three source values and does ~10 FLOP: the
// work is bound by bytes.  At the 256 px main path (A=1224, V=512,
// L=2448 / 1536, n=64, bf16) a pass moves 545 / 341 MB when every source
// row is read, 0.163 / 0.102 ms; a real draw touches fewer rows.
//
// Design.  Threads own one lane each and walk a run of consecutive output
// rows, so the loads of a warp are 32 neighbouring lanes and consecutive
// rows reuse what the row before loaded.
//   warp_pass_fwd_kernel: a block owns (image, 64 output rows, 256 bytes of
//     lanes).  It reduces i0 over its rows and idx over its lanes to the
//     source-row window its outputs read (rows need not be monotone in v),
//     stages that window into shared memory with 16-byte cp.async copies,
//     and writes each output from it; a row whose i0 steps by one loads one
//     new value.  A window larger than the 40 KB budget (strong
//     minification, a wide spread of idx) is read through L2 (__ldg) with
//     the same arithmetic.
//   warp_pass_csr_kernel + warp_pass_adj_kernel: the adjoint.  The first
//     builds T^T per image as CSR: for each source row i the entries
//     (v, w) with T[v,i] != 0 in ascending v (count, scan, rank fill; one
//     block per image, no order-dependent atomics), so every sum has a
//     fixed order and the adjoint is bitwise repeatable.  The second owns
//     (image, 96 output rows, 64 lanes) and writes
//       out[j,l] = (1-f) u[j-idx] + f u[j-1-idx]   (j < A-1, negative rows
//                                                    dropped),
//       u[i,l] = sum_CSR(i) w g[v,l]               (f32, entry order).
//     The u rows a tile reads have their entries in one CSR range: a tile
//     with none stores zeros (the rows away from the image); otherwise it
//     stages the g row of each entry with 16-byte cp.async copies and sums
//     each u value from shared memory, loading the next row's entries
//     while it sums the current one.  Row A-1 (the clamped tail) comes
//     straight from g as the CSR suffix sums
//       sum_{i>=s} u[i,l] = sum_{e >= off[s]} w_e g[v_e,l],
//       s0 = max(A-1-idx, 0) with weight 1-f, s1 = max(A-2-idx, 0) with f,
//     split over the lane's threads and reduced in a fixed order.  No u is
//     written to device memory; the only scratch is the CSR, 4(A+1) + 16V
//     bytes per image.  A tile whose g rows exceed the budget (40 KB in
//     bf16) sums u per lane from the CSR through L2, in the same order.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC -o libwarp_pass.so warp_pass.cu
// Plain C entry points; every pointer is a device pointer, the stream is a
// cudaStream_t passed as void*.  Each returns cudaGetLastError() after its
// launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int CSR_THREADS = 1024;
// Forward: 256 bytes of lanes per block (128 bf16, 64 f32) and a 40 KB
// window budget; a block stages ~20-30 KB at the main path's draws.
template <typename T>
__host__ __device__ constexpr int fwd_lanes() { return 256 / sizeof(T); }
constexpr int FWD_ROWS = 64;
constexpr int WIN_BYTES = 40960;
// Adjoint: 96 output rows and 64 lanes per block; the staged g rows take up
// to 40 KB in bf16 (five blocks an SM), 80 KB in f32.
constexpr int ADJ_ROWS = 96;
constexpr int TL = 64;
template <typename T>
__host__ __device__ constexpr int adj_bytes() { return 20480 * sizeof(T); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// A weight as the dense tent holds it in the working type.
template <typename T> __device__ __forceinline__ float round_w(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tent row of position `pos`: its first column and both weights.
template <typename T>
__device__ __forceinline__ void tent_row(float pos, int A, int& i0, float& w0,
                                         float& w1) {
  const float p = fminf(fmaxf(pos, 0.f), (float)(A - 1));
  const float fl = floorf(p);
  i0 = (int)fl;
  w0 = round_w<T>(fmaxf(0.f, 1.f - fabsf(p - fl)));
  w1 = (i0 + 1 <= A - 1)
           ? round_w<T>(fmaxf(0.f, 1.f - fabsf(p - (fl + 1.f))))
           : 0.f;
}

__device__ __forceinline__ void lane_shift(float sh, int mask, int& idx,
                                           float& f) {
  const float fl = floorf(sh);
  idx = ((int)fl) & mask;
  f = sh - fl;
}

// Block-wide min and max of v over the threads with ok set, into
// s_rng[0] and s_rng[1] (which hold INT_MAX and INT_MIN before).
__device__ __forceinline__ void block_min_max(int v, bool ok, int* s_rng) {
  int mn = ok ? v : INT_MAX, mx = ok ? v : INT_MIN;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, d));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  }
  if ((threadIdx.x & 31) == 0 && mn <= mx) {
    atomicMin(&s_rng[0], mn);
    atomicMax(&s_rng[1], mx);
  }
}

// ------------------------------------------------------------------ forward

// Thread mapping: one lane per thread, a run of RPT consecutive output rows
// per thread.  Rows in order mostly step i0 by 0 or 1, so each output loads
// one new source value and keeps the other two from the row before.
template <typename T, bool VECIO>
__global__ void __launch_bounds__(THREADS)
warp_pass_fwd_kernel(const T* __restrict__ src, const float* __restrict__ pos,
                     const float* __restrict__ shift, T* __restrict__ out,
                     int A, int V, int L, int mask) {
  constexpr int VEC = 16 / sizeof(T);       // elements in 16 bytes
  constexpr int TL = fwd_lanes<T>();
  constexpr int NVEC = TL / VEC;              // 16-byte chunks per row
  constexpr int RPT = FWD_ROWS / (THREADS / TL);    // rows per thread
  constexpr int TLP = TL + VEC;               // padded window row (16 B)
  constexpr int MAX_ROWS = WIN_BYTES / (TLP * (int)sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  __shared__ int s_i0[FWD_ROWS];
  __shared__ float s_w0[FWD_ROWS], s_w1[FWD_ROWS];
  __shared__ int s_rng[4];   // min i0, max i0, min idx, max idx

  const int n = blockIdx.z, v0 = blockIdx.x * FWD_ROWS, l0 = blockIdx.y * TL;
  const int t = threadIdx.x;
  if (t < 4) s_rng[t] = (t % 2 == 0) ? INT_MAX : INT_MIN;
  __syncthreads();
  if (t < FWD_ROWS) {
    int i0 = 0;
    float w0, w1;
    if (v0 + t < V) {
      tent_row<T>(pos[(size_t)n * V + v0 + t], A, i0, w0, w1);
      s_i0[t] = i0; s_w0[t] = w0; s_w1[t] = w1;
    }
    block_min_max(i0, v0 + t < V, s_rng);
  }
  const int ll = t % TL, l = l0 + ll;
  const bool lane_ok = l < L;
  int idx = 0;
  float f = 0.f;
  if (lane_ok) lane_shift(shift[(size_t)n * L + l], mask, idx, f);
  if (t < TL) block_min_max(idx, lane_ok, s_rng + 2);
  __syncthreads();
  const int lo = min(s_rng[0] + s_rng[2], A - 1);
  const int hi = min(s_rng[1] + s_rng[3] + 2, A - 1);
  const int rows = hi - lo + 1;
  const T* src_n = src + (size_t)n * A * L;
  T* out_n = out + (size_t)n * V * L;

  // c0..c2 = src[min(b + k, A-1)] for b = i0 + idx of the row before.
  auto compute = [&](auto ld) {
    if (!lane_ok) return;
    int b = -4;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
    const int r0 = (t / TL) * RPT;
    for (int r = r0; r < r0 + RPT; ++r) {
      const int v = v0 + r;
      if (v >= V) break;
      const int i0 = s_i0[r];
      const int nb = i0 + idx;
      if (nb == b + 1) {
        c0 = c1; c1 = c2; c2 = ld(min(nb + 2, A - 1));
      } else if (nb != b) {
        c0 = ld(min(nb, A - 1));
        c1 = ld(min(nb + 1, A - 1));
        c2 = ld(min(nb + 2, A - 1));
      }
      b = nb;
      float acc = s_w0[r] * ((1.f - f) * c0 + f * c1);
      if (i0 + 1 <= A - 1) acc += s_w1[r] * ((1.f - f) * c1 + f * c2);
      out_n[(size_t)v * L + l] = from_f<T>(acc);
    }
  };

  if (rows <= MAX_ROWS) {
    if (VECIO) {
      for (int c = t; c < rows * NVEC; c += THREADS) {
        const int r = c / NVEC, cv = c % NVEC, gl = l0 + cv * VEC;
        if (gl < L)
          cp_async16(win + r * TLP + cv * VEC,
                     src_n + (size_t)(lo + r) * L + gl);
      }
      cp_async_wait_all();
    } else {
      for (int c = t; c < rows * TL; c += THREADS) {
        const int r = c / TL, cl = c % TL;
        if (l0 + cl < L)
          win[r * TLP + cl] = src_n[(size_t)(lo + r) * L + l0 + cl];
      }
    }
    __syncthreads();
    compute([&](int r) { return to_f(win[(r - lo) * TLP + ll]); });
  } else {
    compute([&](int r) { return to_f(__ldg(src_n + (size_t)r * L + l)); });
  }
}

// ------------------------------------------------------------------ adjoint

// T^T of each image as CSR: off [n, A+1], ent_v / ent_w [n, 2V] (the first
// off[A] used).  Entries of a row are in ascending v.
template <typename T>
__global__ void __launch_bounds__(CSR_THREADS)
warp_pass_csr_kernel(const float* __restrict__ pos, int* __restrict__ off,
                     int* __restrict__ ent_v, float* __restrict__ ent_w,
                     int A, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_r0 = reinterpret_cast<int*>(smem);   // row of (v, w0), -1 if w0 = 0
  int* s_r1 = s_r0 + V;                       // row of (v, w1), -1 if w1 = 0
  float* s_w0 = reinterpret_cast<float*>(s_r1 + V);
  float* s_w1 = s_w0 + V;
  int* s_cnt = reinterpret_cast<int*>(s_w1 + V);   // A+1 counts -> offsets
  __shared__ int s_warp[CSR_THREADS / 32];

  const int n = blockIdx.x, t = threadIdx.x;
  const int m = A + 1;
  for (int v = t; v < V; v += CSR_THREADS) {
    int i0;
    float w0, w1;
    tent_row<T>(pos[(size_t)n * V + v], A, i0, w0, w1);
    s_r0[v] = w0 != 0.f ? i0 : -1;
    s_r1[v] = w1 != 0.f ? i0 + 1 : -1;
    s_w0[v] = w0;
    s_w1[v] = w1;
  }
  for (int i = t; i < m; i += CSR_THREADS) s_cnt[i] = 0;
  __syncthreads();
  for (int v = t; v < V; v += CSR_THREADS) {
    if (s_r0[v] >= 0) atomicAdd(&s_cnt[s_r0[v]], 1);
    if (s_r1[v] >= 0) atomicAdd(&s_cnt[s_r1[v]], 1);
  }
  __syncthreads();

  // Exclusive scan of the m counts: a chunk per thread, then the block.
  const int chunk = (m + CSR_THREADS - 1) / CSR_THREADS;
  const int b = min(t * chunk, m), e = min(b + chunk, m);
  int sum = 0;
  for (int i = b; i < e; ++i) sum += s_cnt[i];
  const int lane = t & 31, wid = t >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int x = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    s_warp[lane] = x;
  }
  __syncthreads();
  int run = incl - sum + (wid > 0 ? s_warp[wid - 1] : 0);
  for (int i = b; i < e; ++i) {
    const int c = s_cnt[i];
    s_cnt[i] = run;
    run += c;
  }
  __syncthreads();
  for (int i = t; i < m; i += CSR_THREADS) off[(size_t)n * m + i] = s_cnt[i];

  // Fill: an entry's place in its row is the number of smaller v there.
  int* ev = ent_v + (size_t)n * 2 * V;
  float* ew = ent_w + (size_t)n * 2 * V;
  for (int v = t; v < V; v += CSR_THREADS) {
    const int r0 = s_r0[v], r1 = s_r1[v];
    int k0 = 0, k1 = 0;
    for (int u = 0; u < v; ++u) {
      const int a = s_r0[u], c = s_r1[u];
      k0 += (a == r0) + (c == r0);
      k1 += (a == r1) + (c == r1);
    }
    if (r0 >= 0) {
      ev[s_cnt[r0] + k0] = v;
      ew[s_cnt[r0] + k0] = s_w0[v];
    }
    if (r1 >= 0) {
      ev[s_cnt[r1] + k1] = v;
      ew[s_cnt[r1] + k1] = s_w1[v];
    }
  }
}

template <typename T, bool VECIO>
__global__ void __launch_bounds__(THREADS)
warp_pass_adj_kernel(const T* __restrict__ g, const float* __restrict__ shift,
                     const int* __restrict__ off,
                     const int* __restrict__ ent_v,
                     const float* __restrict__ ent_w, T* __restrict__ out,
                     int A, int V, int L, int mask) {
  constexpr int VEC = 16 / sizeof(T);       // elements in 16 bytes
  constexpr int NVEC = TL / VEC;                 // 16-byte chunks per row
  constexpr int NG = THREADS / TL;               // row groups
  constexpr int RPT = ADJ_ROWS / NG;                   // rows per thread
  constexpr int TLP = TL + VEC;                  // padded g row (16 B)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_rng[2];   // min idx, max idx

  const int n = blockIdx.z, j0 = blockIdx.x * ADJ_ROWS, l0 = blockIdx.y * TL;
  const int t = threadIdx.x;
  if (t < 2) s_rng[t] = t == 0 ? INT_MAX : INT_MIN;
  __syncthreads();
  const int ll = t % TL, l = l0 + ll;
  const bool lane_ok = l < L;
  int idx = 0;
  float f = 0.f;
  if (lane_ok) lane_shift(shift[(size_t)n * L + l], mask, idx, f);
  if (t < TL) block_min_max(idx, lane_ok, s_rng);
  __syncthreads();
  const int* off_n = off + (size_t)n * (A + 1);
  const int* ev = ent_v + (size_t)n * 2 * V;
  const float* ew = ent_w + (size_t)n * 2 * V;
  const T* g_n = g + (size_t)n * V * L;
  T* out_n = out + (size_t)n * A * L;
  const int r0 = (t / TL) * RPT;

  // Rows j < A-1: out[j] = (1-f) u[j-idx] + f u[j-1-idx], with
  // u[i,l] = sum over CSR(i) of w g[v,l] in entry order.  Consecutive rows
  // share a u value, so each output sums one.  `start(i)` is the first
  // entry of u row i (and the end of row i-1), `term(e)` entry e's w g.
  // The loop is software-pipelined: while a row is summed, the next row's
  // first two entries and the start of the row after it are loaded, so no
  // load waits on another load of the same row.
  const int jh = min(j0 + ADJ_ROWS, A - 1) - 1;
  auto gather = [&](auto start, auto term) {
    if (!lane_ok || j0 + r0 > jh) return;
    auto first2 = [&](int b, int e) {          // entries b and b+1 (< e)
      float acc = 0.f;
      if (b < e) acc += term(b);
      if (b + 1 < e) acc += term(b + 1);
      return acc;
    };
    auto rest = [&](float acc, int b, int e) {  // + entries b+2 .. e-1
      for (b += 2; b < e; ++b) acc += term(b);
      return acc;
    };
    const int jend = min(j0 + r0 + RPT - 1, jh);
    int i = j0 + r0 - idx;                      // u row of the first output
    float ub = 0.f;                             // u[i-1]
    if (i >= 1) {
      const int bp = start(i - 1), ep = start(i);
      ub = rest(first2(bp, ep), bp, ep);
    }
    int b = i >= 0 ? start(i) : 0, e = i >= 0 ? start(i + 1) : 0;
    float part = first2(b, e);
    for (int j = j0 + r0; j <= jend; ++j, ++i) {
      const int e_next = (j < jend && i + 1 >= 0) ? start(i + 2) : 0;
      const float part_next = first2(e, e_next);
      const float ua = rest(part, b, e);
      float acc = 0.f;
      if (i >= 0) acc = (1.f - f) * ua;
      if (i >= 1) acc += f * ub;
      out_n[(size_t)j * L + l] = from_f<T>(acc);
      ub = ua;
      b = e;
      e = e_next;
      part = part_next;
    }
  };
  if (jh >= j0) {
    // The entries of the u rows the tile reads, ulo..uhi, are one CSR
    // range [e0, e0 + ne).
    const int ulo = max(j0 - 1 - s_rng[1], 0);
    const int uhi = min(jh - s_rng[0], A - 1);
    const int nrows = uhi - ulo + 1;
    const int e0 = nrows > 0 ? off_n[ulo] : 0;
    const int ne = nrows > 0 ? off_n[uhi + 1] - e0 : 0;
    const size_t need =
        (size_t)ne * (TLP * sizeof(T) + 4) + (size_t)(nrows + 1) * 4;
    if (ne == 0) {
      // No tent weight reaches these rows (most rows away from the image).
      if (lane_ok)
        for (int j = j0 + r0; j < j0 + r0 + RPT && j <= jh; ++j)
          out_n[(size_t)j * L + l] = from_f<T>(0.f);
    } else if (need <= (size_t)adj_bytes<T>()) {
      // Stage each entry's g row (16-byte cp.async copies), its weight and
      // the rows' offsets, then sum from shared memory.
      T* gs = reinterpret_cast<T*>(smem);        // 16-byte aligned rows
      float* ws = reinterpret_cast<float*>(gs + (size_t)ne * TLP);
      int* os = reinterpret_cast<int*>(ws + ne);
      if (VECIO) {
        for (int c = t; c < ne * NVEC; c += THREADS) {
          const int e = c / NVEC, cv = c % NVEC, gl = l0 + cv * VEC;
          if (gl < L)
            cp_async16(gs + e * TLP + cv * VEC,
                       g_n + (size_t)ev[e0 + e] * L + gl);
        }
      } else {
        for (int c = t; c < ne * TL; c += THREADS) {
          const int e = c / TL, cl = c % TL;
          if (l0 + cl < L)
            gs[e * TLP + cl] = g_n[(size_t)ev[e0 + e] * L + l0 + cl];
        }
      }
      for (int c = t; c < ne; c += THREADS) ws[c] = ew[e0 + c];
      for (int c = t; c <= nrows; c += THREADS) os[c] = off_n[ulo + c] - e0;
      if (VECIO) cp_async_wait_all();
      __syncthreads();
      gather([&](int i) { return os[i - ulo]; },
             [&](int e) { return ws[e] * to_f(gs[e * TLP + ll]); });
    } else {
      gather([&](int i) { return off_n[i]; }, [&](int e) {
        return ew[e] * to_f(__ldg(g_n + (size_t)ev[e] * L + l));
      });
    }
  }

  // Row A-1: the CSR suffix sums from s1 (weight f) and s0 (weight 1-f),
  // entries split over the NG threads of each lane, then summed over those
  // partials in a fixed order.
  if (j0 + ADJ_ROWS > A - 1) {
    __syncthreads();                         // the staged rows are done
    float* p0 = reinterpret_cast<float*>(smem);
    float* p1 = p0 + NG * TL;
    float a0 = 0.f, a1 = 0.f;
    if (lane_ok) {
      const int e0 = off_n[max(A - 1 - idx, 0)];
      const int e1 = off_n[max(A - 2 - idx, 0)];
      const int eend = off_n[A];
      for (int e = e1 + t / TL; e < eend; e += NG) {
        const float x = ew[e] * to_f(__ldg(g_n + (size_t)ev[e] * L + l));
        a1 += x;
        if (e >= e0) a0 += x;
      }
    }
    p0[t] = a0;
    p1[t] = a1;
    __syncthreads();
    if (t < TL && lane_ok) {
      float s0 = 0.f, s1 = 0.f;
      for (int s = 0; s < NG; ++s) {
        s0 += p0[s * TL + t];
        s1 += p1[s * TL + t];
      }
      out_n[(size_t)(A - 1) * L + l] = from_f<T>((1.f - f) * s0 + f * s1);
    }
  }
}

template <typename T, bool VECIO>
int launch_fwd(const void* src, const float* pos, const float* shift,
               void* out, int n, int A, int V, int L, int bits,
               cudaStream_t stream) {
  constexpr int TL = fwd_lanes<T>();
  dim3 grid((V + FWD_ROWS - 1) / FWD_ROWS, (L + TL - 1) / TL, n);
  warp_pass_fwd_kernel<T, VECIO><<<grid, THREADS, WIN_BYTES, stream>>>(
      (const T*)src, pos, shift, (T*)out, A, V, L, (1 << bits) - 1);
  return (int)cudaGetLastError();
}

// Scratch of the adjoint, carved from one buffer: off [n, A+1] int,
// ent_v [n, 2V] int, ent_w [n, 2V] float.
size_t adj_scratch_bytes(int n, int A, int V) {
  return (size_t)n * (4 * (size_t)(A + 1) + 16 * (size_t)V);
}

template <typename T, bool VECIO>
int launch_adj(const void* g, const float* pos, const float* shift,
               void* scratch, void* out, int n, int A, int V, int L, int bits,
               cudaStream_t stream) {
  int* off = (int*)scratch;
  int* ent_v = off + (size_t)n * (A + 1);
  float* ent_w = (float*)(ent_v + (size_t)n * 2 * V);
  const int csr_smem = 16 * V + 4 * (A + 1);
  int err = 0;
  if (csr_smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        warp_pass_csr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        csr_smem);
    if (err != 0) return err;
  }
  warp_pass_csr_kernel<T><<<n, CSR_THREADS, csr_smem, stream>>>(
      pos, off, ent_v, ent_w, A, V);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  constexpr int smem = adj_bytes<T>();
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        warp_pass_adj_kernel<T, VECIO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
  }
  dim3 grid((A + ADJ_ROWS - 1) / ADJ_ROWS, (L + TL - 1) / TL, n);
  warp_pass_adj_kernel<T, VECIO><<<grid, THREADS, smem, stream>>>(
      (const T*)g, shift, off, ent_v, ent_w, (T*)out, A, V, L,
      (1 << bits) - 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (src/g and out share it).  vecio != 0:
// L is a multiple of 16 bytes' worth of elements and the src/g pointer is
// 16-byte aligned, so rows are staged with 16-byte copies.
int warp_fwd(const void* src, const void* pos, const void* shift, void* out,
             int n, int A, int V, int L, int bits, int dtype, int vecio,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* sh = (const float*)shift;
  if (dtype == 0)
    return vecio ? launch_fwd<float, true>(src, p, sh, out, n, A, V, L, bits, s)
                 : launch_fwd<float, false>(src, p, sh, out, n, A, V, L, bits,
                                            s);
  return vecio ? launch_fwd<__nv_bfloat16, true>(src, p, sh, out, n, A, V, L,
                                                 bits, s)
               : launch_fwd<__nv_bfloat16, false>(src, p, sh, out, n, A, V,
                                                  L, bits, s);
}

// Bytes of the adjoint's scratch, the CSR of T^T.
size_t warp_adj_scratch_bytes(int n, int A, int V) {
  return adj_scratch_bytes(n, A, V);
}

// scratch: warp_adj_scratch_bytes(n, A, V) bytes that the caller allocates.
int warp_adj(const void* g, const void* pos, const void* shift, void* scratch,
             void* out, int n, int A, int V, int L, int bits, int dtype,
             int vecio, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* sh = (const float*)shift;
  if (dtype == 0)
    return vecio ? launch_adj<float, true>(g, p, sh, scratch, out, n, A, V, L,
                                           bits, s)
                 : launch_adj<float, false>(g, p, sh, scratch, out, n, A, V,
                                            L, bits, s);
  return vecio ? launch_adj<__nv_bfloat16, true>(g, p, sh, scratch, out, n, A,
                                                 V, L, bits, s)
               : launch_adj<__nv_bfloat16, false>(g, p, sh, scratch, out, n,
                                                  A, V, L, bits, s);
}

}  // extern "C"
