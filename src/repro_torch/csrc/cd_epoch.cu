// K1 and K2: cyclic coordinate-descent epochs on the working set.
//
// K1 (cd_gram_kernel) replaces repro/kernels/cd_epoch.py:cd_epoch_gram_pallas
// (body _cd_gram_kernel): `epochs` cyclic passes over a K-coordinate Gram
// subproblem. For each j: g = q_j - c_j, beta_j <- prox(beta_j - g/L_j,
// 1/L_j) (unchanged where L_j = 0), then q += delta * G[:, j].
//
// K1b (cd_gram_block_kernel, cd_gram_block_cluster_kernel) is K1 on
// multitask blocks: beta, q and c are [K, T] (row-major), the penalty is
// BlockL1 or BlockMCP. For each j: g = q_j - c_j (a T-row), beta_j <- block
// prox of beta_j - g/L_j (its norm is a reduction over T), unchanged where
// L_j = 0, then q += G[:, j] (x) delta_j. The TPU has no kernel for it: the
// reference runs its jax epoch (repro/core/cd.py:cd_epoch_gram with beta
// [K, T]) there.
//
// K2 (cd_xb_cluster_kernel) replaces cd_epoch_xb_pallas (body
// _cd_xb_kernel): the same epochs on the residual state Xb [n].
// g_j = x_j . raw(Xb) + off_j with the raw gradient of the datafit kind
// (quadratic, logistic, svc, with optional sample weights), then
// Xb += delta * x_j.
//
// What bounds them on the H100: the chain of dependent coordinate steps,
// not bytes or operations. Coordinate j+1 reads the state that coordinate j
// wrote, so an epoch is K serial steps. The byte bound (G or X_ws read
// once) is far below that latency chain; what one step costs is set by
// what sits on the chain (a barrier, a global load, a reduction) and how
// many SMs share its vector work.
//
// K1's design: a blocked chain with a lookahead update on one CTA. Step j
// needs only q_j, so a block of B = 32 coordinates runs in one warp: lane
// b holds row j0 + b's q, c, L, step and beta; step b is lane b's prox, a
// shuffle of its delta and q_l + G[j0 + l, j0 + b] * delta on every lane,
// with the diagonal tile staged in shared memory: no CTA barrier and no
// global load inside a block (the old kernel paid one global load and two
// CTA barriers a coordinate, ~0.65 us). The other warps apply the previous
// block's moved deltas to every other row meanwhile, the next block's rows
// first, and stage the next block's tiles (cp.async) and c, L, step; the
// chain warp applies that block's deltas to its own rows from a staged
// tile. One handoff each way per block, on named barriers. Each q_i still
// takes q_i + G[i, j] * delta_j one j at a time, in ascending order, delta
// = 0 skipped, so K1 rounds as its plain version under -fmad=false (up to
// the sign of a zero). What is left on the chain: K dependent prox +
// shuffle + multiply-add steps, and a handoff every B; beside it the
// update warps stream G (K^2 values an epoch when every coordinate moves)
// through one SM. q and beta live in shared memory: the plan keeps one CTA
// for small K only, and past it a cluster whose update CTAs hold q's rows
// (up to ~360k float64 coordinates, where G alone would take ~1 PB).
//
// K1b's single-CTA design (the small shapes where kernels/cd_epoch.py's
// plan keeps it: at most 64 tasks; the grids' K1bl lanes at the
// leadfield's K = 64, T = 50): one CTA keeps the whole state on chip for
// all epochs of a launch, as the TPU kernel keeps it in VMEM: q's entries
// in its owner threads' registers, beta, c, L, step and G (or a ring of
// its columns, filled by cp.async four steps ahead) in shared memory. A
// chain warp runs the row steps (lanes over the tasks, the norm by a fixed
// shuffle tree) and applies each delta to the next row itself; the owners
// apply it to every row they hold, the next-but-one row first, and hand
// that row to the chain on named barriers. So no global load and no
// CTA-wide barrier sits on the chain (the kernel it replaced read beta, c,
// L and G from global memory and met two __syncthreads over up to 32 warps
// a coordinate: ~2 us a coordinate at K = 64, T = 50).
//
// Cluster design (K2 always, K1b past the plan's single-CTA shapes): one
// launch is one thread-block cluster of C CTAs on one GPC. CTA r owns the
// ragged slice [r*N/C, (r+1)*N/C) of the state (N = n samples for K2, K rows
// of q for K1b) and keeps it in its own shared memory for all epochs (in
// global memory, still C-way split, past the shared-memory capacity). The
// CTAs agree on each coordinate's step through distributed shared memory:
// K1b behind ONE hardware cluster barrier per coordinate (arrive.release +
// wait.acquire), with parity double-buffered slots: a CTA rewrites slot
// j & 1 only at coordinate j + 2, after barrier j + 1, which every CTA
// reaches only after reading the slots of j; K2 with no barrier at all.
//   K2: each warp reduces its threads' part of x_j[slice] . raw[slice]
//   (raw kept per sample, times n, and recomputed only where Xb moved, so
//   coordinates with delta = 0 cost no exp) and pushes it into every
//   rank's shared memory by st.async, which completes its bytes on that
//   rank's mbarrier; EVERY warp of every CTA waits on its own mbarrier,
//   reads the cluster's C * W warp sums in one fixed order and runs the
//   same coordinate step, so all threads hold the same delta bit for bit
//   (in the barrier version this replaced, traced by clock stamps, the
//   cluster barrier's arrive.release cost ~0.5 us a coordinate, and two
//   __syncthreads, warp 0's second tree and a rank-order chain of C
//   shuffles ~0.8 us more; PERF.md section 6); each thread updates its
//   own samples and adds x_{j+1} . raw for the next coordinate as it goes.
//   Each CTA keeps its own copy of beta (rank 0's is the output), so no
//   CTA reads another's beta. While the sums travel, each thread loads its
//   samples of x_{j+1} into registers (the register path: 4 samples a
//   thread) or, on longer slices, the CTA prefetches x_{j+1} into L2;
//   x_{j+2} is prefetched into L2, so the column read is off the chain.
//   K1b: the owner of row j runs the warp-0 row prox on its local q row and
//   publishes delta_j and a nonzero flag; after the barrier every CTA copies
//   delta_j from the owner and updates its own rows in the flat-walk order,
//   so q has no cross-CTA reduction and rounds exactly as on one CTA. On the
//   register path (8 entries a thread) each thread loads its entries'
//   G[:, j] values before the prox and the barrier; else it reads them in
//   the update.
// Every CTA reaches every barrier (the skips of the update sit inside the
// loop body), and a last cluster barrier keeps each CTA's shared memory
// alive until no other CTA can read it.
//
// K1l and K2l (the lane forms, cd_epoch_gram_lanes_* and
// cd_epoch_xb_lanes_*) are K1 and K2 over a lane dimension, as pallas_call
// under the reference's vmap: the grid's y index is the lane (one CTA or
// one cluster a lane), each lane reads its own tensors (a lane stride) and
// its own row of the codec vector. K2's single-lane entry points are the
// same kernel with one lane and no mask; a lane K2l's mask freezes copies
// its state through and returns at entry, every CTA of its cluster alike,
// so no cluster barrier is left waiting. K1's lane code is a template
// branch (LANES) that the single-lane K1 does not compile: a frozen lane
// runs zero epochs through the same copy-in and copy-out, and the update
// CTAs issue a row's loads of G as predicated loads (gram_apply_row), so
// K1l's instances compile to K1's registers and keep a row's loads in
// flight together. K1l's cluster size is its own plan's
// (kernels/cd_epoch.py: gram_lanes_plan): the one with which the card runs
// the lanes in the fewest waves (one, where one fits), where K1's 16 CTAs
// a lane ran a grid's lanes in waves.
// K1bl (cd_epoch_gram_block_lanes_f64) is K1b over lanes of multitask
// blocks the same way: K1b's two kernels with a LANES template branch that
// K1b does not compile, the lane on grid y (one CTA or one cluster a lane,
// each on K1b's plan of one lane), a lane stride on G and on c, beta, q
// [S, K, T], a parameter row a lane. A frozen lane runs zero epochs: it
// takes the same copy-in / copy-out path as an active one, with no chain
// step and no early return, so every CTA of its cluster reaches the last
// cluster barrier.
//
// The launch layout (cluster size, shared or global slices, dynamic shared
// bytes, threads, register path) is the wrapper's plan
// (kernels/cd_epoch.py: gram_plan, xb_plan, gram_block_plan); the launchers
// take it as given.
//
// Built with -fmad=false: every multiply and add rounds on its own, as the
// plain torch versions do, so the Gram axpy matches them exactly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

#include "cluster.cuh"
#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

// the first index of rank r's slice of [0, total) split C ways (ragged)
__device__ __forceinline__ int split_lo(int total, int C, int r) {
  return (int)((long long)total * r / C);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];\n" ::"l"(p));
}

// ------------------------------------------------------------------ K1
// K1's layout constants (kernels/cd_epoch.py: gram_plan mirrors them): a
// block of kGramB coordinates is one chain warp's lanes; an update thread
// keeps a row's kGramB loads of G in flight, which takes the registers of
// at most kGramMaxThreads threads. The head of dynamic shared memory holds,
// in T values, the tiles [2 parities][diag, sub][B][B], the staged c, L,
// step and beta [4][2 parities][B], the deltas of the last three blocks by
// lane [3][B] and compacted [3][B], and the next block's q rows [2][B];
// then q and beta (one CTA) or the CTA's q rows (a cluster's update CTAs).
constexpr int kGramB = 32;
constexpr int kGramMaxThreads = 512;
constexpr int kGramTile = kGramB * kGramB;
constexpr int kGramHead = 4 * kGramTile + 16 * kGramB;
// named barriers (0 is __syncthreads): kBarDone + parity, the chain warp's
// "block s is done" to the warps that stage; kBarReady + parity, their
// "block s+1's inputs are ready" to the chain warp
constexpr int kBarDone = 1;
constexpr int kBarReady = 3;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// K1's shared state: the staged inputs of a chain step, the published
// deltas of a block and the next block's q rows
template <typename T>
struct GramShared {
  T* tiles;  // [2][2][B][B]: parity, (diag G[rows, rows], sub G[rows, prev cols]), col b, row l
  T* sc;     // [2][B] c of the staged block's rows
  T* sL;     // [2][B] L
  T* sst;    // [2][B] step = 1 / max(L, 1e-30)
  T* sbeta;  // [2][B] beta (cluster)
  T* dlane;  // [3][B] the block's deltas by lane (0 where not moved)
  T* dcomp;  // [3][B] the moved deltas, compacted in coordinate order
  T* qbuf;   // [2][B] the chain block's q rows, from their owner (cluster)
  int* list;       // [3][B] the moved deltas' lanes
  unsigned* mask;  // [3] the moved mask

  __device__ GramShared(T* base, int* s_list, unsigned* s_mask)
      : tiles(base),
        sc(base + 4 * kGramTile),
        sL(sc + 2 * kGramB),
        sst(sL + 2 * kGramB),
        sbeta(sst + 2 * kGramB),
        dlane(sbeta + 2 * kGramB),
        dcomp(dlane + 3 * kGramB),
        qbuf(dcomp + 3 * kGramB),
        list(s_list),
        mask(s_mask) {}
};

// Stage chain step t's inputs into parity t & 1: the diagonal tile of
// block kb, the tile G[block kb, block kp] (kp >= 0: the previous block,
// whose deltas the chain applies first) by cp.async, and c, L, step (and,
// with `beta`, beta) of kb's rows. Thread u of nu takes its share.
template <typename T>
__device__ __forceinline__ void gram_stage(const GramShared<T>& sh, const T* __restrict__ G,
                                           long long s_row, long long s_col,
                                           const T* __restrict__ c, const T* __restrict__ L,
                                           const T* beta, int K, int t, int kb, int kp, int u,
                                           int nu) {
  const int par = t & 1;
  T* tile = sh.tiles + par * 2 * kGramTile;
  const int n = kp >= 0 ? 2 * kGramTile : kGramTile;
  for (int e = u; e < n; e += nu) {
    const int which = e / kGramTile, r = e % kGramTile;
    const int b = r / kGramB, l = r % kGramB;
    const int i = kb * kGramB + l, j = (which ? kp : kb) * kGramB + b;
    if (i < K && j < K) cp_async(tile + e, G + (long long)i * s_row + (long long)j * s_col);
  }
  for (int l = u; l < kGramB; l += nu) {
    const int i = kb * kGramB + l;
    if (i < K) {
      const T Li = L[i];
      sh.sc[par * kGramB + l] = c[i];
      sh.sL[par * kGramB + l] = Li;
      sh.sst[par * kGramB + l] = T(1.0) / rt::clamp_min(Li, T(1e-30));
      if (beta) sh.sbeta[par * kGramB + l] = beta[i];
    }
  }
}

// *p through L2 (ld.global.cg) where `pred`, else 0: one predicated load,
// no branch around it (float64: K1l's only type)
__device__ __forceinline__ double ldcg_if(bool pred, const double* p) {
  double r = 0.0;
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.cg.f64 %0, [%1];\n}\n"
               : "+d"(r)
               : "l"(p), "r"((int)pred));
  return r;
}

// *qi += G[i, jp0 + list[t]] * d[t] for the nm moved coordinates of one
// block, in coordinate order. All nm loads of G are issued before the
// first add (one round trip a row) and bypass L1 (ld.global.cg): a CTA's
// rows x 32 lines in flight would thrash it. Written as 32 loads each
// behind a branch (t < nm), ptxas keeps them in flight together only as
// far as its schedule of the whole kernel allows: K1's cluster kernel
// issues them in runs of about 7, K1l's (the lane prologue compiled in)
// in runs of 2, which left every row a round trip a coordinate and K1l's
// chain waiting for its update CTAs (1.8x K1 at K = 1024, 3x at 2048).
// PREDICATED (K1l's kernels) issues them as 32 predicated loads with no
// branch between them, in flight together on every instance; K1 keeps the
// branches, its instances as they were measured.
template <typename T, bool PREDICATED>
__device__ __forceinline__ void gram_apply_row(T* qi, const T* __restrict__ G, long long s_row,
                                               long long s_col, int i, int jp0, int nm,
                                               const int* list, const T* d) {
  const T* Gi = G + (long long)i * s_row;
  T g[kGramB];
#pragma unroll
  for (int t = 0; t < kGramB; ++t) {
    if constexpr (PREDICATED)
      g[t] = ldcg_if(t < nm, Gi + (long long)(jp0 + list[t]) * s_col);
    else if (t < nm)
      g[t] = __ldcg(Gi + (long long)(jp0 + list[t]) * s_col);
  }
  T v = *qi;
#pragma unroll
  for (int t = 0; t < kGramB; ++t)
    if (t < nm) v = v + g[t] * d[t];
  *qi = v;
}

// One block on the chain warp, lane l holding row j0 + l (q ql, beta bl,
// c, L, step): first the previous block's Bp deltas dp[b] (by lane;
// nullptr: none) with the staged tile `sub` = G[block, previous block], in
// coordinate order (gram_stage writes only columns b < Bp: a ragged last
// block leaves the rest of the tile unwritten, so the loop must not read
// it); then the block's Bk coordinates: lane b's prox, a
// shuffle of its delta, q_l + G[j0 + l, j0 + b] * delta on every lane (the
// staged diagonal tile `diag`). No CTA barrier and no global load. The
// chain adds G * delta for every delta, 0 included, as the plain version
// does: a branch on delta would keep the tile's shared loads from running
// ahead of the chain. Returns lane l's delta (0 where it did not move) and
// updates ql, bl.
template <typename T, int PEN>
__device__ __forceinline__ T gram_chain_block(const T* diag, const T* sub, const T* dp, int Bp,
                                              int Bk, int lane, T& ql, T& bl, T cl, T Ll, T stl,
                                              T p0, T p1) {
  if (dp) {
#pragma unroll 8
    for (int b = 0; b < kGramB; ++b) {
      if (b >= Bp) break;
      ql = ql + sub[b * kGramB + lane] * dp[b];
    }
  }
  T myd = T(0);
#pragma unroll 8
  for (int b = 0; b < kGramB; ++b) {
    if (b >= Bk) break;
    const T g = ql - cl;
    const T nw0 = rt::prox(PEN, bl - g * stl, stl, p0, p1);
    const T nw = (Ll > T(0)) ? nw0 : bl;
    const T d = __shfl_sync(0xffffffffu, nw - bl, b);
    if (lane == b) {
      bl = nw;
      myd = d;
    }
    ql = ql + diag[b * kGramB + lane] * d;
  }
  return myd;
}

// Publish a block's deltas into this CTA's slot: by lane, compacted in
// coordinate order with their lanes, and the moved mask.
template <typename T>
__device__ __forceinline__ void gram_publish(const GramShared<T>& sh, int slot, int lane, T myd) {
  const bool moved = myd != T(0);
  const unsigned mv = __ballot_sync(0xffffffffu, moved);
  sh.dlane[slot * kGramB + lane] = myd;
  if (moved) {
    const int pos = __popc(mv & ((1u << lane) - 1u));
    sh.list[slot * kGramB + pos] = lane;
    sh.dcomp[slot * kGramB + pos] = myd;
  }
  if (lane == 0) sh.mask[slot] = mv;
}

// K1 on one CTA: `epochs` cyclic passes over K coordinates in blocks of
// B = 32, on a chain warp (warp 0) and update warps (the rest). The epochs
// are one sequence of S = epochs * nb chain steps, step s on block s % nb.
//   chain warp, step s: wait for kBarReady (s - 1); load the block's q and
//   beta (lane l: row j0 + l) and its staged c, L, step; run
//   gram_chain_block (the previous block's deltas D_{s-1} first); write q
//   and beta back; publish D_s; arrive at kBarDone (s).
//   update warps, step s (while chain s runs): wait for kBarDone (s - 1);
//   stage chain s + 1's tiles and c, L, step; apply D_{s-1} to block
//   s + 1's rows (warp 1); arrive at kBarReady (s); apply D_{s-1} to every
//   other row outside blocks s - 1 (its own chain applied it), s (chain s
//   applies it first) and s + 1. A last step drains D_{S-1}.
// Every row therefore takes the deltas one at a time in coordinate order,
// as the plain epoch does; the update warps skip Delta = 0 (the plain
// epoch adds 0 * G there; the chain adds it too).
// Three delta slots and two tile parities keep a writer off the slot a
// reader still holds; the named barriers alternate by parity so a phase
// never takes the next phase's arrivals.
template <typename T, int PEN, bool LANES>
__global__ void __launch_bounds__(kGramMaxThreads)
    cd_gram_kernel(const T* __restrict__ G, long long s_row, long long s_col, long long g_lane,
                   const T* __restrict__ c, const T* __restrict__ L, const T* __restrict__ beta0,
                   const T* __restrict__ q0, T* beta_out, T* q_out, int K, int epochs,
                   const double* __restrict__ prm, int prm_lane,
                   const unsigned char* __restrict__ active) {
  if constexpr (LANES) {
    // this CTA's lane (blockIdx.y): its tensors and its parameter row
    const long long ln = blockIdx.y, o = ln * K;
    G += ln * g_lane;
    c += o;
    L += o;
    beta0 += o;
    q0 += o;
    beta_out += o;
    q_out += o;
    prm += ln * prm_lane;
    if (active && !active[ln]) epochs = 0;  // a frozen lane: state passes through
  }
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(PEN, prm);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_list[3 * kGramB];
  __shared__ unsigned s_mask[3];
  T* base = reinterpret_cast<T*>(smem_raw);
  const GramShared<T> sh(base, s_list, s_mask);
  T* q = base + kGramHead;
  T* beta = base + kGramHead + K;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int nb = (K + kGramB - 1) / kGramB;
  const int S = epochs * nb;
  for (int i = tid; i < K; i += bd) {
    q[i] = q0[i];
    beta[i] = beta0[i];
  }
  if (S > 0) gram_stage(sh, G, s_row, s_col, c, L, (const T*)nullptr, K, 0, 0, -1, tid, bd);
  cp_async_wait_all();
  __syncthreads();
  if (tid < kGramB) {
    const int lane = tid;
    for (int s = 0; s < S; ++s) {
      const int kb = s % nb, par = s & 1, j0 = kb * kGramB;
      const int Bk = min(kGramB, K - j0);
      const int Bp = min(kGramB, K - ((s + nb - 1) % nb) * kGramB);  // block s - 1's length
      const bool act = lane < Bk;
      if (s > 0) bar_sync(kBarReady + ((s - 1) & 1), bd);
      const T* tile = sh.tiles + par * 2 * kGramTile;
      T ql = act ? q[j0 + lane] : T(0);
      T bl = act ? beta[j0 + lane] : T(0);
      const T myd = gram_chain_block<T, PEN>(
          tile, tile + kGramTile, s > 0 && nb > 1 ? sh.dlane + ((s - 1) % 3) * kGramB : nullptr,
          Bp, Bk, lane, ql, bl, sh.sc[par * kGramB + lane], sh.sL[par * kGramB + lane],
          sh.sst[par * kGramB + lane], p0, p1);
      if (act) {
        q[j0 + lane] = ql;
        beta[j0 + lane] = bl;
      }
      gram_publish(sh, s % 3, lane, myd);
      __syncwarp();
      bar_arrive(kBarDone + par, bd);
    }
  } else {
    const int u = tid - kGramB, nu = bd - kGramB;
    for (int s = 0; s <= S; ++s) {
      if (s > 0) bar_sync(kBarDone + ((s - 1) & 1), bd);
      const int kp = s > 0 ? (s - 1) % nb : -1;       // D_{s-1}'s block
      const int kc = s < S ? s % nb : -1;             // chain s's block
      const int kn = s + 1 < S ? (s + 1) % nb : -1;   // chain s+1's block
      int nm = 0;
      const int* list = nullptr;
      const T* d = nullptr;
      if (s > 0) {
        const int slot = (s - 1) % 3;
        nm = __popc(sh.mask[slot]);
        list = sh.list + slot * kGramB;
        d = sh.dcomp + slot * kGramB;
      }
      const int jp0 = kp * kGramB;
      if (kn >= 0) {
        gram_stage(sh, G, s_row, s_col, c, L, (const T*)nullptr, K, s + 1, kn,
                   kn != kc ? kc : -1, u, nu);
        // the next chain's rows first
        const int i = kn * kGramB + u;
        if (nm && u < kGramB && kn != kp && kn != kc && i < K)
          gram_apply_row<T, LANES>(q + i, G, s_row, s_col, i, jp0, nm, list, d);
        cp_async_wait_all();
        bar_arrive(kBarReady + (s & 1), bd);
      }
      if (nm) {
        for (int i = u; i < K; i += nu) {
          const int kb = i / kGramB;
          if (kb == kp || kb == kc || kb == kn) continue;
          gram_apply_row<T, LANES>(q + i, G, s_row, s_col, i, jp0, nm, list, d);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += bd) {
    beta_out[i] = beta[i];
    q_out[i] = q[i];
  }
}

// the cluster rank (1..C-1) whose rows hold block k of nb: the update CTAs
// split the blocks as split_lo does
__device__ __forceinline__ int gram_owner(int k, int nb, int C) {
  return 1 + (int)(((long long)(C - 1) * (k + 1) - 1) / nb);
}

// K1 on a thread-block cluster of C CTAs (nb >= 3 blocks): the chain keeps
// its SM to itself, and C - 1 SMs share the stream of G.
//   rank 0: the chain warp runs the one-CTA kernel's chain steps on q rows
//   it receives (blocks 0 and 1 from q0); its other warps stage each next
//   step's tiles and c, L, step, beta (named barriers as there). beta
//   lives in beta_out. After chain s the chain
//   warp writes the block's q rows back to their owner (DSMEM), publishes
//   D_s in its own slot s % 3 (after every update CTA has released that
//   slot: mbarrier empty); after a warp barrier lane r arrives on rank
//   r's mbarrier full (release, cluster scope).
//   rank r >= 1: owns blocks [split_lo(nb, C-1, r-1), split_lo(nb, C-1, r))
//   of q, in its shared memory. Step s: wait full (D_{s-1});
//   copy D_{s-1} from rank 0; if it owns block s + 1, warp 0 applies
//   D_{s-1} to those rows first, sends them to rank 0's qbuf and arrives on
//   rank 0's mbarrier ready (chain s + 1 waits for it from s + 1 = 2 on);
//   then D_{s-1} on its other rows outside blocks
//   s - 1, s and s + 1 (as on one CTA); then one arrival on rank 0's empty.
// The per-row order of additions is the one-CTA kernel's. A cluster
// barrier after the mbarriers' initialisation and one before exit keep
// every remote access inside the CTAs' lifetimes.
template <typename T, int PEN, bool LANES>
__global__ void __launch_bounds__(kGramMaxThreads)
    cd_gram_cluster_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                           long long g_lane, const T* __restrict__ c, const T* __restrict__ L,
                           const T* __restrict__ beta0, const T* __restrict__ q0, T* beta_out,
                           T* q_out, int K, int epochs, const double* __restrict__ prm,
                           int prm_lane, const unsigned char* __restrict__ active) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  if constexpr (LANES) {
    // this cluster's lane (blockIdx.y): its tensors and its parameter row
    const long long ln = blockIdx.y, o = ln * K;
    G += ln * g_lane;
    c += o;
    L += o;
    beta0 += o;
    q0 += o;
    beta_out += o;
    q_out += o;
    prm += ln * prm_lane;
    if (active && !active[ln]) epochs = 0;  // a frozen lane: state passes through
  }
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(PEN, prm);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_list[3 * kGramB];
  __shared__ unsigned s_mask[3];
  __shared__ __align__(8) unsigned long long bar_full[3], bar_empty[3], bar_ready[2];
  T* base = reinterpret_cast<T*>(smem_raw);
  const GramShared<T> sh(base, s_list, s_mask);
  const int tid = threadIdx.x, bd = blockDim.x;
  const int nb = (K + kGramB - 1) / kGramB;
  const int S = epochs * nb;
  if (tid == 0) {
    for (int m = 0; m < 3; ++m) {
      mbar_init(&bar_full[m], 1);
      mbar_init(&bar_empty[m], C - 1);
    }
    for (int m = 0; m < 2; ++m) mbar_init(&bar_ready[m], kGramB);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_release();
  cluster_wait_acquire();
  if (rank == 0) {
    for (int i = tid; i < K; i += bd) beta_out[i] = beta0[i];
    __syncthreads();
    if (S > 0) {
      // blocks 0 and 1 start from q0 (block 1 takes D_0 in chain 1)
      gram_stage(sh, G, s_row, s_col, c, L, (const T*)beta_out, K, 0, 0, -1, tid, bd);
      for (int l = tid; l < 2 * kGramB; l += bd) sh.qbuf[l] = q0[l];
    }
    cp_async_wait_all();
    __syncthreads();
    if (tid < kGramB) {
      const int lane = tid;
      T* qrows = base + kGramHead;  // the owners' q rows, at the same offset
      for (int s = 0; s < S; ++s) {
        const int kb = s % nb, par = s & 1, j0 = kb * kGramB;
        const int Bk = min(kGramB, K - j0);
        const int Bp = min(kGramB, K - ((s + nb - 1) % nb) * kGramB);  // block s - 1's length
        const bool act = lane < Bk;
        if (s > 0) bar_sync(kBarReady + ((s - 1) & 1), bd);
        if (s > 1) mbar_wait(&bar_ready[par], ((s - 2) >> 1) & 1);
        const T* tile = sh.tiles + par * 2 * kGramTile;
        T ql = sh.qbuf[par * kGramB + lane];
        T bl = sh.sbeta[par * kGramB + lane];
        const T myd = gram_chain_block<T, PEN>(
            tile, tile + kGramTile, s > 0 ? sh.dlane + ((s - 1) % 3) * kGramB : nullptr, Bp, Bk,
            lane, ql, bl, sh.sc[par * kGramB + lane], sh.sL[par * kGramB + lane],
            sh.sst[par * kGramB + lane], p0, p1);
        const int slot = s % 3;
        if (s >= 3) mbar_wait(&bar_empty[slot], ((s - 3) / 3) & 1);
        const int o = gram_owner(kb, nb, C);
        if (act) {
          beta_out[j0 + lane] = bl;
          const int r0 = split_lo(nb, C - 1, o - 1) * kGramB;
          *cluster.map_shared_rank(qrows + (j0 + lane - r0), o) = ql;
        }
        gram_publish(sh, slot, lane, myd);
        // lane r releases the warp's writes to rank r (one arrival each;
        // the warp barrier orders every lane's writes before it)
        __syncwarp();
        if (lane >= 1 && lane < C) mbar_arrive_remote(&bar_full[slot], lane);
        if (s + 2 < S) bar_arrive(kBarDone + par, bd);
      }
    } else {
      const int u = tid - kGramB, nu = bd - kGramB;
      for (int s = 0; s + 1 < S; ++s) {
        if (s > 0) bar_sync(kBarDone + ((s - 1) & 1), bd);
        gram_stage(sh, G, s_row, s_col, c, L, (const T*)beta_out, K, s + 1, (s + 1) % nb,
                   s % nb, u, nu);
        cp_async_wait_all();
        bar_arrive(kBarReady + (s & 1), bd);
      }
    }
  } else {
    const int kb_lo = split_lo(nb, C - 1, rank - 1), kb_hi = split_lo(nb, C - 1, rank);
    const int lo = kb_lo * kGramB, hi = min(K, kb_hi * kGramB);
    T* q = base + kGramHead;  // rows lo..hi-1
    for (int i = tid; i < hi - lo; i += bd) q[i] = q0[lo + i];
    __syncthreads();
    const int* r_list = cluster.map_shared_rank(s_list, 0);
    const T* r_dcomp = cluster.map_shared_rank(sh.dcomp, 0);
    const unsigned* r_mask = cluster.map_shared_rank(s_mask, 0);
    for (int s = 1; s <= S; ++s) {
      const int slot = (s - 1) % 3;
      mbar_wait(&bar_full[slot], ((s - 1) / 3) & 1);
      if (tid < kGramB) {
        sh.list[slot * kGramB + tid] = r_list[slot * kGramB + tid];
        sh.dcomp[slot * kGramB + tid] = r_dcomp[slot * kGramB + tid];
        if (tid == 0) sh.mask[slot] = r_mask[slot];
      }
      __syncthreads();
      const int kp = (s - 1) % nb;                    // D_{s-1}'s block
      const int kc = s < S ? s % nb : -1;             // chain s's block
      const int kn = s + 1 < S ? (s + 1) % nb : -1;   // chain s+1's block
      const int nm = __popc(sh.mask[slot]);
      const int* list = sh.list + slot * kGramB;
      const T* d = sh.dcomp + slot * kGramB;
      const int jp0 = kp * kGramB;
      if (kn >= kb_lo && kn < kb_hi && tid < kGramB) {
        // the next chain's rows first, sent to rank 0
        const int i = kn * kGramB + tid;
        if (i < K) {
          if (nm) gram_apply_row<T, LANES>(q + (i - lo), G, s_row, s_col, i, jp0, nm, list, d);
          *cluster.map_shared_rank(sh.qbuf + ((s + 1) & 1) * kGramB + tid, 0) = q[i - lo];
        }
        mbar_arrive_remote(&bar_ready[(s + 1) & 1], 0);
      }
      if (nm) {
        for (int i = lo + tid; i < hi; i += bd) {
          const int kb = i / kGramB;
          if (kb == kp || kb == kc || kb == kn) continue;
          gram_apply_row<T, LANES>(q + (i - lo), G, s_row, s_col, i, jp0, nm, list, d);
        }
      }
      __syncthreads();
      if (tid == 0) mbar_arrive_remote(&bar_empty[slot], 0);
    }
    for (int i = tid; i < hi - lo; i += bd) q_out[lo + i] = q[i];
  }
  // no CTA leaves while another may still reach its shared memory
  cluster_arrive_release();
  cluster_wait_acquire();
}

// K1's chain floor: the one-CTA kernel's handoffs, with a chain step of
// one shuffle and one multiply-add and no update work. `scale` = 0 keeps v
// finite; the compiler cannot know it.
template <typename T>
__global__ void __launch_bounds__(kGramMaxThreads)
    gram_chain_floor_kernel(int K, int epochs, T scale, T* out) {
  const int tid = threadIdx.x, bd = blockDim.x;
  const int nb = (K + kGramB - 1) / kGramB;
  const int S = epochs * nb;
  if (tid < kGramB) {
    T v = T(tid);
    for (int s = 0; s < S; ++s) {
      const int Bk = min(kGramB, K - (s % nb) * kGramB);
      if (s > 0) bar_sync(kBarReady + ((s - 1) & 1), bd);
#pragma unroll 8
      for (int b = 0; b < kGramB; ++b) {
        if (b >= Bk) break;
        const T d = __shfl_sync(0xffffffffu, v, b);
        v = v + scale * d;
      }
      __syncwarp();
      bar_arrive(kBarDone + (s & 1), bd);
    }
    out[tid] = v;
  } else {
    for (int s = 0; s <= S; ++s) {
      if (s > 0) bar_sync(kBarDone + ((s - 1) & 1), bd);
      if (s + 1 < S) bar_arrive(kBarReady + (s & 1), bd);
    }
  }
}

// ------------------------------------------------------------ K1b, one CTA
// The one-CTA block epoch's layout constants (kernels/cd_epoch.py:
// gram_block_plan mirrors them): an owner thread keeps up to kBlockPer
// entries of q in registers on the register path, which runs on at most
// kBlockThreads threads (85 registers a thread: at 1024 threads' 64 the
// float64 instances spilled); the chain warp's lane l
// holds a row's entries t = l + 32 m, m < kBlockChain (so at most 64
// tasks); a ring of kBlockRing columns of G where G is not staged whole,
// round r's column copied kBlockLead rounds ahead and waited for
// kBlockWait rounds later (so it is in shared memory, behind a barrier,
// before round r - 1 ends: the owners load their G values for round r
// before they wait for its hand-off); the deltas of kBlockSlots steps.
// The dynamic shared memory holds, in T
// values: the chain's next rows [2][nt], the deltas [kBlockSlots][nt], L
// and step [K] each, then G (whole [K][K], column-major, or the ring
// [kBlockRing][K]), then (stage_bc) beta and c [K * nt] each, then (PER ==
// 0) q [K * nt].
constexpr int kBlockPer = 8;
constexpr int kBlockThreads = 768;
constexpr int kBlockChain = 2;
constexpr int kBlockRing = 5;
constexpr int kBlockLead = 4;
constexpr int kBlockWait = 2;
constexpr int kBlockSlots = 3;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the first offset of the norm's shuffle tree: the largest power of two
// below nt, at most 16 (none for one task). The lanes at or past nt hold
// +0, so the levels this skips add +0 to sums of squares: the same bits as
// the whole tree.
__device__ __forceinline__ int tree_top(int nt) {
  int top = 16;
  while (top > 0 && top >= nt) top >>= 1;
  return top;
}

// An owner thread's walk over its entries e = u + k * owners of the flat
// [K, nt] (k < cnt), f(k, i, t) on entry (i, t) in ascending k: unrolled
// over PER registers, or a loop over q in shared memory (PER == 0).
template <int PER, typename F>
__device__ __forceinline__ void block_walk(int cnt, int i0, int t0, int di, int dt, int nt, F f) {
  int i = i0, t = t0;
  if constexpr (PER > 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (k < cnt) f(k, i, t);
      i += di;
      t += dt;
      if (t >= nt) {
        t -= nt;
        ++i;
      }
    }
  } else {
    for (int k = 0; k < cnt; ++k) {
      f(k, i, t);
      i += di;
      t += dt;
      if (t >= nt) {
        t -= nt;
        ++i;
      }
    }
  }
}

// K1b on one CTA, the whole state on chip for all `epochs` of a launch:
// a chain warp (warp 0) and owner warps, handing off on named barriers.
// The epochs are one sequence of S = epochs * K steps, step s on row s % K.
//   chain, step s: load beta_j, c_j, L_j, step_j of its row j (shared
//   memory, before the hand-off); wait for kBarReady (s & 1), the owners'
//   "row j took delta_{s-2}"; read row j's q from the next-rows buffer and
//   add G[j, j'] delta_{s-1} itself (its own registers: lane l holds the
//   same tasks t in every row); the row norm (lane partials, shuffle tree),
//   the block prox, beta_j and delta_s into shared memory and its nonzero
//   flag; arrive at kBarDone (s & 1).
//   owners, round r (while chain r + 1 runs): wait for kBarDone (r & 1);
//   (ring) stage the column of round r + kBlockLead by cp.async; copy
//   their entries of row (r + 2) % K, delta_r applied, to the next-rows
//   buffer first, arrive at kBarReady (r & 1), then apply delta_r to all
//   their entries; load their G values of round r + 1 before its
//   hand-off. On the register path an owner's entries, their rows, tasks
//   and G values sit in registers, with no branch between a round's loads
//   and updates.
// So the chain waits on no owner work but the next row's, and reads no
// global memory: a step is the hand-off, two shared loads, the norm's
// shuffles, a sqrt and the prox's divide. Each owner applies every delta
// to every entry it holds, in ascending j (q + G[i, j] delta_t, skipped
// where delta_j is all zero), and the chain's copy of a row takes the same
// operations: q rounds as in the plain version and the norm sums in the
// parent kernel's order (emulate_block_epoch in kernels/cd_epoch.py), so the
// launch equals it bit for bit under -fmad=false. Owner u holds entries
// e = u + k * owners (the plan makes `owners` a multiple of nt where it can:
// then each owner's entries share one task t and it loads one delta a
// round). Slots: the next-rows buffer by parity (rewritten by round r after
// the chain read it at step r), the deltas and flags by s % 3 and the ring
// by r % kBlockRing (rewritten only after every owner finished the round
// that read them, which the chain's wait for kBarReady orders). stage_bc = 0 leaves
// beta and c in global memory and PER = 0 keeps q in shared memory: the
// plans take those only where a forced one-CTA layout cannot hold them.
// LANES: K1bl's lane prologue (a lane a CTA, blockIdx.y; the lane strides
// g_lane on G and K * nt on c, beta and q, the parameter row prm_lane
// apart; a lane with active[lane] == 0 runs zero epochs through the same
// copy-in and copy-out). PEN, the block penalty, is a template argument:
// with a runtime id the compiler evaluated both penalties' prox on the
// chain, three more divides a step.
template <typename T, bool LANES, int PER, int PEN>
__global__ void __launch_bounds__(PER > 0 ? kBlockThreads : 1024)
    cd_gram_block_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                         long long g_lane, const T* __restrict__ c, const T* __restrict__ L,
                         const T* __restrict__ beta0, const T* __restrict__ q0, T* beta,
                         T* q_out, int K, int nt, int epochs,
                         const double* __restrict__ prm, int prm_lane,
                         const unsigned char* __restrict__ active, int owners, int stage_bc,
                         int g_whole) {
  if constexpr (LANES) {
    const long long ln = blockIdx.y, o = ln * K * nt;
    G += ln * g_lane;
    c += o;
    L += ln * K;
    beta0 += o;
    q0 += o;
    beta += o;
    q_out += o;
    prm += ln * prm_lane;
    if (active && !active[ln]) epochs = 0;  // a frozen lane: state passes through
  }
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(PEN, prm);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag[kBlockSlots];
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const int KT = K * nt;
  const int S = K > 0 ? epochs * K : 0;
  T* sqb = reinterpret_cast<T*>(smem_raw);  // [2][nt]
  T* sdl = sqb + 2 * nt;                    // [kBlockSlots][nt]
  T* sL = sdl + kBlockSlots * nt;           // [K]
  T* sst = sL + K;                          // [K]
  T* sg = sst + K;                          // [K][K] or [kBlockRing][K]
  T* rest = sg + (g_whole ? (long long)K * K : (long long)kBlockRing * K);
  T* sb = stage_bc ? rest : beta;
  const T* sc = stage_bc ? rest + KT : c;
  T* sq = stage_bc ? rest + 2 * KT : rest;  // PER == 0
  for (int e = tid; e < KT; e += bd) {
    if (stage_bc) {
      cp_async(sb + e, beta0 + e);
      cp_async(rest + KT + e, c + e);
    } else {
      beta[e] = beta0[e];
    }
    if constexpr (PER == 0) sq[e] = q0[e];
  }
  for (int i = tid; i < K; i += bd) {
    const T Li = L[i];
    sL[i] = Li;
    sst[i] = T(1.0) / rt::clamp_min(Li, T(1e-30));
  }
  // G whole (column col at col * K), or the columns of rounds 0 ..
  // kBlockLead - 1 in ring slots 0 .. kBlockLead - 1
  const int ncol = g_whole ? K : min(kBlockLead, S);
  for (int e = tid; e < ncol * K; e += bd) {
    const int r = e / K, i = e - r * K;
    cp_async(sg + e, G + (long long)i * s_row + (long long)(r % K) * s_col);
  }
  if (K > 0) {
    for (int t = tid; t < nt; t += bd) {
      sqb[t] = q0[t];
      sqb[nt + t] = q0[(1 % K) * nt + t];
    }
  }
  // owner u = tid - 32 holds entries u + k * owners, k < cnt: (i0, t0)
  // the first, (di, dt) the step; on the register path entry k's row and
  // task (0 past cnt) and value in registers
  const int u = tid - 32;
  const bool own = tid >= 32 && u < owners;
  const int cnt = own && u < KT ? (KT - 1 - u) / owners + 1 : 0;
  const int i0 = own ? u / nt : 0, t0 = own ? u - (u / nt) * nt : 0;
  const int di = owners / nt, dt = owners - di * nt;
  T qr[PER > 0 ? PER : 1], gr[PER > 0 ? PER : 1];
  int ix[PER > 0 ? PER : 1];  // entry k's row << 8 | task (0 past cnt)
  if constexpr (PER > 0) {
    block_walk<PER>(PER, i0, t0, di, dt, nt, [&](int k, int i, int t) {
      ix[k] = k < cnt ? i << 8 | t : 0;
      qr[k] = k < cnt ? q0[(long long)i * nt + t] : T(0);
    });
  }
  cp_async_wait_all();
  __syncthreads();

  if (tid < 32) {
    const int top = tree_top(nt);
    T dprev[kBlockChain];
#pragma unroll
    for (int m = 0; m < kBlockChain; ++m) dprev[m] = T(0);
    int nzp = 0, j = 0, jp = 0, slot = 0, gslot = kBlockRing - 1;
    for (int s = 0; s < S; ++s) {
      const T Lj = sL[j], st = sst[j];
      T bm[kBlockChain], cm[kBlockChain];
#pragma unroll
      for (int m = 0; m < kBlockChain; ++m) {
        const int t = lane + 32 * m;
        bm[m] = t < nt ? sb[(long long)j * nt + t] : T(0);
        cm[m] = t < nt ? sc[(long long)j * nt + t] : T(0);
      }
      if (s >= 2) bar_sync(kBarReady + (s & 1), bd);
      const T* qb = sqb + (s & 1) * nt;
      const T g = !nzp ? T(0) : sg[(long long)(g_whole ? jp : gslot) * K + j];
      T xm[kBlockChain];
      T part = T(0);
#pragma unroll
      for (int m = 0; m < kBlockChain; ++m) {
        const int t = lane + 32 * m;
        if (t < nt) {
          T q = qb[t];
          if (nzp) q = q + g * dprev[m];
          const T x = bm[m] - (q - cm[m]) * st;
          xm[m] = x;
          part = part + x * x;
        }
      }
      for (int o = top; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
      const T nrm = sqrt(__shfl_sync(0xffffffffu, part, 0));
      const rt::BlockProx<T> bp = rt::block_prox(PEN, nrm, st, p0, p1);
      T* dl = sdl + slot * nt;
      int nz = 0;
#pragma unroll
      for (int m = 0; m < kBlockChain; ++m) {
        const int t = lane + 32 * m;
        if (t < nt) {
          const T nw = (Lj > T(0)) ? bp.apply(xm[m]) : bm[m];
          const T d = nw - bm[m];
          dl[t] = d;
          sb[(long long)j * nt + t] = nw;
          dprev[m] = d;
          nz |= (d != T(0));
        }
      }
      nzp = __any_sync(0xffffffffu, nz);
      if (lane == 0) s_flag[slot] = nzp;
      bar_arrive(kBarDone + (s & 1), bd);
      jp = j;
      j = j + 1 == K ? 0 : j + 1;
      slot = slot + 1 == kBlockSlots ? 0 : slot + 1;
      gslot = gslot + 1 == kBlockRing ? 0 : gslot + 1;
    }
  } else {
    // round r: its column of G (whole: col; the ring: slot ring), the row
    // p of step r + 2 and the deltas' slot; where every entry of this
    // owner has task t0 (rows i0 + k di), p - i0 = qd di + rm (floored)
    int col = 0, ring = 0, p = K > 0 ? 2 % K : 0, slot = 0;
    int qd = -1, rm = 0;
    if (dt == 0 && di > 0) {
      const int rel = p - i0;
      qd = rel >= 0 ? rel / di : -1;
      rm = rel - qd * di;
    }
    auto column = [&](int c, int rs) -> const T* {
      return sg + (long long)(g_whole ? c : rs) * K;
    };
    if constexpr (PER > 0) {
      if (S > 0) {
        const T* gc = column(0, 0);
#pragma unroll
        for (int k = 0; k < PER; ++k) gr[k] = gc[ix[k] >> 8];
      }
    }
    for (int r = 0; r < S; ++r) {
      bar_sync(kBarDone + (r & 1), bd);
      if (!g_whole) {
        const int rn = r + kBlockLead;
        if (rn < S) {
          const int rs = ring + kBlockLead < kBlockRing ? ring + kBlockLead
                                                        : ring + kBlockLead - kBlockRing;
          T* dst = sg + (long long)rs * K;
          const T* src = G + (long long)(rn % K) * s_col;
          for (int i = tid - 32; i < K; i += bd - 32) cp_async(dst + i, src + (long long)i * s_row);
        }
        cp_async_commit();
        cp_async_wait_group<kBlockWait>();
      }
      const int nz = s_flag[slot];
      const T* dl = sdl + slot * nt;
      const int pr = r + 2 < S ? p : -1;
      T* qn = sqb + (r & 1) * nt;
      if constexpr (PER > 0) {
        // G values in registers already. Row pr's entries go to the chain
        // first (only the owners that hold one branch to it), then every
        // entry takes delta_r with no branch between them: q + G delta is
        // computed alike for the chain's copy and for the register, and
        // the entries past cnt are never written out.
        if (dt == 0) {  // every entry of this owner has task t0
          const T dv = dl[t0];
          if (pr >= 0) {
            if (rm == 0 && qd >= 0 && qd < cnt) {  // row pr is entry qd
              T v = T(0);
#pragma unroll
              for (int k = 0; k < PER; ++k)
                if (k == qd) v = nz ? qr[k] + gr[k] * dv : qr[k];
              qn[t0] = v;
            }
            bar_arrive(kBarReady + (r & 1), bd);
          }
          if (nz) {
#pragma unroll
            for (int k = 0; k < PER; ++k) qr[k] = qr[k] + gr[k] * dv;
          }
        } else {
          if (pr >= 0) {
#pragma unroll
            for (int k = 0; k < PER; ++k) {
              if (k < cnt && ix[k] >> 8 == pr) {
                const int t = ix[k] & 255;
                qn[t] = nz ? qr[k] + gr[k] * dl[t] : qr[k];
              }
            }
            bar_arrive(kBarReady + (r & 1), bd);
          }
          if (nz) {
#pragma unroll
            for (int k = 0; k < PER; ++k) qr[k] = qr[k] + gr[k] * dl[ix[k] & 255];
          }
        }
        // the next round's G values, before its hand-off
        if (r + 1 < S) {
          const T* gc = column(col + 1 == K ? 0 : col + 1, ring + 1 == kBlockRing ? 0 : ring + 1);
#pragma unroll
          for (int k = 0; k < PER; ++k) gr[k] = gc[ix[k] >> 8];
        }
      } else {
        const T* gc = column(col, ring);
        const T dfix = cnt > 0 ? dl[t0] : T(0);  // every entry's delta where dt == 0
        if (pr >= 0) {
          block_walk<0>(cnt, i0, t0, di, dt, nt, [&](int, int i, int t) {
            if (i == pr) {
              T& q = sq[(long long)i * nt + t];
              if (nz) q = q + gc[i] * (dt == 0 ? dfix : dl[t]);
              qn[t] = q;
            }
          });
          bar_arrive(kBarReady + (r & 1), bd);
        }
        if (nz) {
          block_walk<0>(cnt, i0, t0, di, dt, nt, [&](int, int i, int t) {
            if (i != pr) {
              T& q = sq[(long long)i * nt + t];
              q = q + gc[i] * (dt == 0 ? dfix : dl[t]);
            }
          });
        }
      }
      col = col + 1 == K ? 0 : col + 1;
      ring = ring + 1 == kBlockRing ? 0 : ring + 1;
      slot = slot + 1 == kBlockSlots ? 0 : slot + 1;
      if (p + 1 == K) {  // row 0 next: p - i0 = -i0, and i0 < di
        p = 0;
        qd = i0 == 0 ? 0 : -1;
        rm = i0 == 0 ? 0 : di - i0;
      } else {
        ++p;
        if (++rm == di) {
          rm = 0;
          ++qd;
        }
      }
    }
  }
  __syncthreads();
  if (stage_bc)
    for (int e = tid; e < KT; e += bd) beta[e] = sb[e];
  if constexpr (PER > 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (k < cnt) q_out[(long long)(ix[k] >> 8) * nt + (ix[k] & 255)] = qr[k];
  } else {
    for (int e = tid; e < KT; e += bd) q_out[e] = sq[e];
  }
}

// K1b's one-CTA chain floor: the kernel's hand-off (the owner warps only
// pass the named barriers) around K steps of a T-wide norm by the same
// shuffle tree, one sqrt and one divide, with no loads. `scale` = 0 keeps
// v finite; the compiler cannot know it.
template <typename T>
__global__ void __launch_bounds__(1024)
    block_chain_floor_kernel(int K, int nt, int epochs, T scale, T* out) {
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31;
  const int S = epochs * K;
  if (tid < 32) {
    const int top = tree_top(nt);
    T v[kBlockChain];
#pragma unroll
    for (int m = 0; m < kBlockChain; ++m) v[m] = T(lane + 32 * m);
    for (int s = 0; s < S; ++s) {
      if (s >= 2) bar_sync(kBarReady + (s & 1), bd);
      T part = T(0);
#pragma unroll
      for (int m = 0; m < kBlockChain; ++m)
        if (lane + 32 * m < nt) part = part + v[m] * v[m];
      for (int o = top; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
      const T nrm = sqrt(__shfl_sync(0xffffffffu, part, 0));
      const T f = (nrm * scale) / rt::clamp_min(nrm, T(1e-30));
#pragma unroll
      for (int m = 0; m < kBlockChain; ++m) v[m] = v[m] + f * v[m];
      bar_arrive(kBarDone + (s & 1), bd);
    }
    out[tid] = v[0];
  } else {
    for (int r = 0; r < S; ++r) {
      bar_sync(kBarDone + (r & 1), bd);
      if (r + 2 < S) bar_arrive(kBarReady + (r & 1), bd);
    }
  }
}

enum DatafitKind { KIND_QUADRATIC = 0, KIND_LOGISTIC = 1, KIND_SVC = 2 };

// the datafit's raw gradient at one sample times n (quadratic, logistic;
// svc's is not scaled), as repro_torch.core.datafits: the kernel scales
// each coordinate's dot product by 1 / n once instead of every sample by
// n, and the logistic's weight and label share its one division
template <typename T>
__device__ __forceinline__ T raw_grad(int kind, T xb, T y, const T* w, int i) {
  if (kind == KIND_QUADRATIC) {
    const T d = xb - y;
    return w ? d * w[i] : d;
  }
  if (kind == KIND_LOGISTIC) return (w ? (-y) * w[i] : -y) / (T(1.0) + exp(y * xb));
  return xb;  // svc
}

// values per thread that the register paths of the cluster kernels hold
// (K2's samples, K1b's q entries; the plan's `per`), and the largest CTA
// they run with (so that 85 registers a thread fit)
constexpr int kXbPer = 2;
constexpr int kGramPer = 8;
constexpr int kPerThreads = 768;

// K2 on a cluster. With PER > 0 every thread owns samples tid + k * bd
// (k < PER) of its CTA's slice and keeps their x_j values in registers: it
// loads x_{j+1}'s while the partial sums of j travel and adds x_{j+1} .
// raw into the next coordinate's sum as it updates raw. With PER = 0
// (slices longer than PER * bd) the same steps read x from global memory.
// Dynamic shared memory holds the slots of the cluster's warp sums
// (2 C W values), then the slices (Xb, raw, y, w: ceil(n / C) values each)
// on the shared branch and nothing more on the global one.
// A coordinate has no barrier, neither a CTA's nor the cluster's: each
// warp sums its threads' products by a shuffle tree and its lanes r < C
// push the sum into slot [rank][warp] of rank r's shared memory by
// st.async, which completes its bytes on rank r's mbarrier of that
// coordinate's parity (its thread 0 expects C W sums a phase); every warp
// of every CTA waits on its own mbarrier, reads the C W sums in one fixed
// order (lane l those of index l, l + 32, ...; a butterfly over the lanes,
// every lane ending with the same bits), scales it by 1 / n and runs the
// coordinate step (its step and penalty constants prepared from L_j while
// the previous axpy ran: rt::PreparedStep), so all threads hold the same
// delta bit for bit. A
// slot of parity g & 1 (g the coordinate's index in the launch) is pushed
// again at g + 2 only by a CTA past g + 1, whose sums need every warp of
// every CTA past its reads of g. Thread 0 writes the CTA's beta; the next
// coordinate's beta, offset and L are loaded and its step prepared before
// the axpy (beta_{j+1} was written a phase or more ago, and thread 0's
// arrive on the mbarrier releases it to the CTA), so no division of it
// waits on the next coordinate's chain.
template <typename T, int PER>
__global__ void __launch_bounds__(PER > 0 ? kPerThreads : 1024)
    cd_xb_cluster_kernel(const T* __restrict__ Xt, const T* __restrict__ y_in,
                         const T* __restrict__ w_in, const T* __restrict__ L,
                         const T* __restrict__ off, const T* __restrict__ beta0,
                         const T* __restrict__ Xb0, T* beta_out, T* Xb_out, T* scratch,
                         int K, int n, int epochs, int kind, int pen,
                         const double* __restrict__ prm, int use_smem, int w_lane,
                         long long scratch_lane, int prm_lane,
                         const unsigned char* __restrict__ active) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  {
    // this cluster's lane (blockIdx.y): its tensors (y is shared; w is
    // shared or the lane's) and its parameter row
    const long long ln = blockIdx.y;
    Xt += ln * K * n;
    if (w_in) w_in += ln * w_lane;
    L += ln * K;
    off += ln * K;
    beta0 += ln * K;
    beta_out += ln * K;
    Xb0 += ln * n;
    Xb_out += ln * n;
    scratch += ln * scratch_lane;
    prm += ln * prm_lane;
    if (active && !active[ln]) {  // a frozen lane: every CTA of it leaves
      for (int i = rank * blockDim.x + threadIdx.x; i < K; i += C * blockDim.x)
        beta_out[i] = beta0[i];
      for (int i = rank * blockDim.x + threadIdx.x; i < n; i += C * blockDim.x)
        Xb_out[i] = Xb0[i];
      return;
    }
  }
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(pen, prm);
  const int lo = split_lo(n, C, rank), m = split_lo(n, C, rank + 1) - lo;
  const int tid = threadIdx.x, bd = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = (bd + 31) >> 5, parts = C * nw;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the head of dynamic shared memory: the cluster's warp sums of a
  // coordinate, [parity][rank][warp] (one offset in every CTA, so a push
  // lands where its rank reads it); the mbarriers the pushes complete on
  T* slot = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) unsigned long long bar[2];
  // scratch: the beta copies of ranks 1..C-1 ([C-1, K]), then (global
  // branch) the raw gradient [n]
  T* beta = rank == 0 ? beta_out : scratch + (long long)(rank - 1) * K;
  T *xb, *raw;
  const T *y, *w = nullptr;
  if (use_smem) {
    T* a = slot + 2 * parts;
    xb = a;
    raw = a + m;
    T* ys = a + 2 * m;
    for (int i = tid; i < m; i += bd) ys[i] = y_in[lo + i];
    y = ys;
    if (w_in) {
      T* ws = a + 3 * m;
      for (int i = tid; i < m; i += bd) ws[i] = w_in[lo + i];
      w = ws;
    }
  } else {
    xb = Xb_out + lo;
    raw = scratch + (long long)(C - 1) * K + lo;
    y = y_in + lo;
    if (w_in) w = w_in + lo;
  }
  // a thread's samples are its own: staged, updated and read by it alone
  for (int i = tid; i < m; i += bd) {
    const T v = Xb0[lo + i];
    xb[i] = v;
    raw[i] = raw_grad(kind, v, y[i], w, i);
  }
  for (int i = tid; i < K; i += bd) beta[i] = beta0[i];
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  constexpr int kLine = 128 / sizeof(T);
  T xc[PER > 0 ? PER : 1], xn[PER > 0 ? PER : 1] = {};
  T acc = T(0);  // this thread's part of x_j . raw, for the next coordinate
  if constexpr (PER > 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * bd;
      xc[k] = i < m ? Xt[lo + i] : T(0);
      if (i < m) acc = acc + xc[k] * raw[i];
    }
  } else {
    for (int i = tid; i < m; i += bd) acc = acc + Xt[lo + i] * raw[i];
  }
  // every CTA's mbarriers exist before any rank pushes into them
  cluster_arrive_release();
  cluster_wait_acquire();
  const T inv_n = T(1.0) / T(n);
  const unsigned bytes = (unsigned)(parts * sizeof(T));
  T bj = beta[0], offj = off[0];
  rt::PreparedStep<T> st;  // the coordinate's step and penalty constants
  st.prepare(pen, L[0], p0, p1);
  const long long last = (long long)epochs * K;
  for (long long g = 0; g < last; ++g) {
    const int j = (int)(g % K), par = (int)(g & 1);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    const T v = __shfl_sync(0xffffffffu, acc, 0);
    if (tid == 0) mbar_arrive_expect_tx(&bar[par], bytes);
    if (lane < C)
      st_async_remote(&slot[par * parts + rank * nw + warp], v, &bar[par], (unsigned)lane);
    // while the sums travel: x_{j+1}'s values into registers (or L2),
    // x_{j+2}'s slice into L2
    const int j1 = j + 1 == K ? 0 : j + 1;
    if (g + 1 < last) {
      const T* x1 = Xt + (long long)j1 * n + lo;
      if constexpr (PER > 0) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int i = tid + k * bd;
          xn[k] = i < m ? x1[i] : T(0);
        }
      } else {
        for (int i = tid * kLine; i < m; i += bd * kLine) prefetch_l2(x1 + i);
      }
    }
    if (PER > 0 && g + 2 < last) {
      const T* x2 = Xt + (long long)((j1 + 1) % K) * n + lo;
      for (int i = tid * kLine; i < m; i += bd * kLine) prefetch_l2(x2 + i);
    }
    mbar_wait(&bar[par], (unsigned)((g >> 1) & 1));
    // the cluster's warp sums, rank-major: lane l adds those of index l,
    // l + 32, ... in order, then a butterfly over the lanes
    T s = T(0);
    for (int q = lane; q < parts; q += 32) s = s + slot[par * parts + q];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const T gj = (kind == KIND_SVC ? s : s * inv_n) + offj;
    const T nb = st.apply(bj, gj);
    const T d = nb - bj;
    if (tid == 0) beta[j] = nb;
    // the next coordinate's beta (written a phase or more ago), offset,
    // step and penalty constants, off the chain while the axpy runs
    bj = K == 1 ? nb : beta[j1];
    offj = off[j1];
    st.prepare(pen, L[j1], p0, p1);
    acc = T(0);
    if constexpr (PER > 0) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid + k * bd;
        if (i < m) {
          if (d != T(0)) {
            const T u = xb[i] + xc[k] * d;
            xb[i] = u;
            raw[i] = raw_grad(kind, u, y[i], w, i);
          }
          acc = acc + xn[k] * raw[i];
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) xc[k] = xn[k];
    } else {
      const T* x = Xt + (long long)j * n + lo;
      const T* x1 = Xt + (long long)j1 * n + lo;
      for (int i = tid; i < m; i += bd) {
        if (d != T(0)) {
          const T u = xb[i] + x[i] * d;
          xb[i] = u;
          raw[i] = raw_grad(kind, u, y[i], w, i);
        }
        acc = acc + x1[i] * raw[i];
      }
    }
  }
  if (use_smem) {
    for (int i = tid; i < m; i += bd) Xb_out[lo + i] = xb[i];
  }
  // no CTA leaves while a push into it may be in flight
  cluster_arrive_release();
  cluster_wait_acquire();
}

// K1b on a cluster. With PER > 0 every thread owns at most PER entries of
// its CTA's flat [rows, nt] walk and loads their G[:, j] values into
// registers before the owner's prox and the cluster barrier of j, so the
// column read overlaps them. With PER = 0 the update reads G after the
// barrier. Dynamic shared memory holds slot[2][nt + 1] (delta_j and the
// nonzero flag, by parity), the local copy s_delta[nt + 1] and, on the
// shared branch, the CTA's ceil(K / C) rows of q.
// LANES: K1bl's lane prologue, as the one-CTA kernel's (a lane a cluster,
// blockIdx.y; every CTA of a frozen lane runs zero epochs)
template <typename T, int PER, bool LANES>
__global__ void __launch_bounds__(PER > 0 ? kPerThreads : 1024)
    cd_gram_block_cluster_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                                 long long g_lane, const T* __restrict__ c,
                                 const T* __restrict__ L, const T* __restrict__ beta0,
                                 const T* __restrict__ q0, T* beta, T* q_out, int K, int nt,
                                 int epochs, int pen, const double* __restrict__ prm,
                                 int use_smem, int prm_lane,
                                 const unsigned char* __restrict__ active) {
  if constexpr (LANES) {
    const long long ln = blockIdx.y, o = ln * K * nt;
    G += ln * g_lane;
    c += o;
    L += ln * K;
    beta0 += o;
    q0 += o;
    beta += o;
    q_out += o;
    prm += ln * prm_lane;
    if (active && !active[ln]) epochs = 0;  // a frozen lane: state passes through
  }
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(pen, prm);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lo = split_lo(K, C, rank), rows = split_lo(K, C, rank + 1) - lo;
  const int tid = threadIdx.x, bd = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slot = reinterpret_cast<T*>(smem_raw);  // [2][nt + 1]
  T* s_delta = slot + 2 * (nt + 1);          // [nt + 1]
  T* q = use_smem ? s_delta + (nt + 1) : q_out + (long long)lo * nt;
  const int MT = rows * nt;
  const long long base = (long long)lo * nt;
  for (int k = tid; k < MT; k += bd) {
    q[k] = q0[base + k];
    beta[base + k] = beta0[base + k];
  }
  // this thread's flat walk over the local [rows, nt]: start (i, t), step
  // (di, dt)
  const int i_start = tid / nt, t_start = tid % nt;
  const int di = bd / nt, dt = bd % nt;
  const int lane = tid & 31;
  T g[PER > 0 ? PER : 1];
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      const T* col = G + (long long)j * s_col + (long long)lo * s_row;
      if constexpr (PER > 0) {
        int i = i_start, t = t_start;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          g[k] = tid + k * bd < MT ? col[(long long)i * s_row] : T(0);
          i += di;
          t += dt;
          if (t >= nt) {
            t -= nt;
            ++i;
          }
        }
      }
      // the rank whose slice holds row j
      const int owner = (int)(((long long)C * (j + 1) - 1) / K);
      const int par = j & 1;
      if (rank == owner && tid < 32) {
        T* out = slot + par * (nt + 1);
        const T Lj = L[j];
        const T step = T(1.0) / rt::clamp_min(Lj, T(1e-30));
        T* bj = beta + (long long)j * nt;
        const T* qj = q + (long long)(j - lo) * nt;
        const T* cj = c + (long long)j * nt;
        T part = T(0);
        for (int t = lane; t < nt; t += 32) {
          const T x = bj[t] - (qj[t] - cj[t]) * step;
          part = part + x * x;
        }
        for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
        const T nrm = sqrt(__shfl_sync(0xffffffffu, part, 0));
        const rt::BlockProx<T> bp = rt::block_prox(pen, nrm, step, p0, p1);
        int nz = 0;
        for (int t = lane; t < nt; t += 32) {
          const T b = bj[t];
          const T nw = (Lj > T(0)) ? bp.apply(b - (qj[t] - cj[t]) * step) : b;
          const T d = nw - b;
          out[t] = d;
          bj[t] = nw;
          nz |= (d != T(0));
        }
        nz = __any_sync(0xffffffffu, nz);
        if (lane == 0) out[nt] = nz ? T(1) : T(0);
      }
      cluster_arrive_release();
      cluster_wait_acquire();
      const T* src = cluster.map_shared_rank(slot + par * (nt + 1), owner);
      for (int t = tid; t <= nt; t += bd) s_delta[t] = src[t];
      __syncthreads();
      if (s_delta[nt] != T(0)) {
        int i = i_start, t = t_start;
        if constexpr (PER > 0) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int f = tid + k * bd;
            if (f < MT) q[f] = q[f] + g[k] * s_delta[t];
            i += di;
            t += dt;
            if (t >= nt) {
              t -= nt;
              ++i;
            }
          }
        } else {
          for (int k = tid; k < MT; k += bd) {
            q[k] = q[k] + col[(long long)i * s_row] * s_delta[t];
            i += di;
            t += dt;
            if (t >= nt) {
              t -= nt;
              ++i;
            }
          }
        }
      }
      // the next row's owner reads its q row after every thread's update
      // (s_delta is rewritten only after the next cluster barrier)
      const int jn = j + 1 < K ? j + 1 : 0;
      if (rank == (int)(((long long)C * (jn + 1) - 1) / K)) __syncthreads();
    }
  }
  if (use_smem) {
    for (int k = tid; k < MT; k += bd) q_out[base + k] = q[k];
  }
  // no CTA leaves while another may still read its delta slots
  cluster_arrive_release();
  cluster_wait_acquire();
}

// every word of this CTA's dynamic shared memory set to all ones
// (volatile: the stores are never read back here, and must not be dropped)
__global__ void fill_shared_kernel(int words) {
  extern __shared__ unsigned fill_words[];
  volatile unsigned* w = fill_words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0xffffffffu;
}

// the chain floor: `iters` cluster barriers and nothing else
__global__ void cluster_barrier_loop_kernel(int iters) {
  for (int k = 0; k < iters; ++k) {
    cluster_arrive_release();
    cluster_wait_acquire();
  }
}

// cluster_capacity for K2 (which == 1) and K1b (2) in T, on the register
// path (per != 0) or not
template <typename T>
int cluster_capacity_t(int which, int per, int C, int threads, int dyn, int* active) {
  switch (which) {
    case 1:
      return per ? cluster_capacity_of(cd_xb_cluster_kernel<T, kXbPer>, C, threads, dyn, active)
                 : cluster_capacity_of(cd_xb_cluster_kernel<T, 0>, C, threads, dyn, active);
    case 2:
      return per ? cluster_capacity_of(cd_gram_block_cluster_kernel<T, kGramPer, false>, C,
                                       threads, dyn, active)
                 : cluster_capacity_of(cd_gram_block_cluster_kernel<T, 0, false>, C, threads,
                                       dyn, active);
  }
  return (int)cudaErrorInvalidValue;
}

// K1's kernel (one CTA, or with `cluster` the cluster kernel) for penalty
// `pen`, K1l's with LANES; nullptr for an unknown penalty
template <typename T, bool LANES>
auto gram_kernel_of(int pen, bool cluster) -> decltype(&cd_gram_kernel<T, rt::PEN_L1, LANES>) {
#define K1_CASE(ID) \
  case ID:          \
    return cluster ? cd_gram_cluster_kernel<T, ID, LANES> : cd_gram_kernel<T, ID, LANES>;
  switch (pen) {
    K1_CASE(rt::PEN_L1)
    K1_CASE(rt::PEN_L1L2)
    K1_CASE(rt::PEN_MCP)
    K1_CASE(rt::PEN_SCAD)
    K1_CASE(rt::PEN_L05)
    K1_CASE(rt::PEN_L23)
    K1_CASE(rt::PEN_BOX)
  }
#undef K1_CASE
  return nullptr;
}

// cluster_capacity for K1's cluster kernel (K1l's with LANES) of penalty `pen`
template <typename T, bool LANES>
int gram_capacity(int pen, int C, int threads, int dyn, int* active) {
  auto kernel = gram_kernel_of<T, LANES>(pen, true);
  if (!kernel) return (int)cudaErrorInvalidValue;
  return cluster_capacity_of(kernel, C, threads, dyn, active);
}

// K1 with the wrapper's plan (kernels/cd_epoch.py: gram_plan): one CTA
// (cluster == 1) or a cluster of `cluster` CTAs (K > 2 blocks), `dyn`
// bytes of dynamic shared memory a CTA, `threads` a CTA (the chain warp and
// at least one more warp). Refuses a plan whose `dyn` cannot hold the head
// and the state (one CTA: q and beta; a cluster: an update CTA's q rows).
// LANES: K1l's kernels (a lane a CTA or cluster, the mask).
template <typename T, bool LANES>
int launch_gram(const T* G, long long sr, long long sc, long long gl, const T* c, const T* L,
                const T* beta0, const T* q0, T* beta, T* q, int K, int epochs, int pen,
                const double* prm, int pl, const unsigned char* active, int lanes, int cluster,
                int dyn, int threads, void* stream) {
  if (threads < 2 * kGramB || threads % 32 || threads > kGramMaxThreads || cluster < 1 ||
      cluster > 16 || (cluster > 1 && K <= 2 * kGramB) || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nb = (K + kGramB - 1) / kGramB;
  const long long state =
      cluster == 1 ? 2LL * K : (nb + cluster - 2) / (cluster - 1) * kGramB;  // values
  if ((long long)dyn < (kGramHead + state) * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  auto kernel = gram_kernel_of<T, LANES>(pen, cluster > 1);
  if (!kernel) return (int)cudaErrorInvalidValue;
  if (cluster > 1)
    return launch_cluster(kernel, cluster, threads, (size_t)dyn, stream, lanes, G, sr, sc, gl, c,
                          L, beta0, q0, beta, q, K, epochs, prm, pl, active);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(1, lanes), threads, dyn, (cudaStream_t)stream>>>(
      G, sr, sc, gl, c, L, beta0, q0, beta, q, K, epochs, prm, pl, active);
  return (int)cudaGetLastError();
}

// K1b with the wrapper's plan (kernels/cd_epoch.py: gram_block_plan): one
// CTA (cluster == 1) or a cluster of `cluster` CTAs, `dyn` bytes of dynamic
// shared memory a CTA. One CTA: beta and c staged in shared memory
// (use_smem), q's entries in `owners` threads' registers (per ==
// kBlockPer) or in shared memory (0), G staged whole (g_whole) or through
// the column ring; it refuses a plan whose `dyn` cannot hold that, more
// than 32 kBlockChain tasks, or owners that cannot hold q. A cluster: q's
// rows in shared memory (use_smem) or global memory and the register path
// when per == kGramPer. LANES: K1bl's kernels (a lane a CTA or cluster,
// the lane strides, the mask).
template <typename T, bool LANES>
int launch_gram_block(const T* G, long long sr, long long sc, long long gl, const T* c,
                      const T* L, const T* beta0, const T* q0, T* beta, T* q, int K, int nt,
                      int epochs, int pen, const double* prm, int pl,
                      const unsigned char* active, int lanes, int cluster, int use_smem, int dyn,
                      int threads, int per, int owners, int g_whole, void* stream) {
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  if (cluster == 1) {
    const long long KT = (long long)K * nt;
    const long long need = (2LL + kBlockSlots) * nt + 2LL * K +
                           (g_whole ? (long long)K * K : (long long)kBlockRing * K) +
                           (use_smem ? 2 * KT : 0) + (per ? 0 : KT);
    if (threads < 64 || threads > 1024 || threads % 32 || nt < 1 ||
        nt > 32 * kBlockChain || owners < 1 || owners > threads - 32 ||
        (per != 0 && per != kBlockPer) || (per && threads > kBlockThreads) ||
        (per && KT > (long long)per * owners) ||
        (long long)dyn < need * (long long)sizeof(T))
      return (int)cudaErrorInvalidValue;
    const bool l1 = pen == rt::PEN_BLOCK_L1;
    if (!l1 && pen != rt::PEN_BLOCK_MCP) return (int)cudaErrorInvalidValue;
    auto kernel = per ? (l1 ? cd_gram_block_kernel<T, LANES, kBlockPer, rt::PEN_BLOCK_L1>
                            : cd_gram_block_kernel<T, LANES, kBlockPer, rt::PEN_BLOCK_MCP>)
                      : (l1 ? cd_gram_block_kernel<T, LANES, 0, rt::PEN_BLOCK_L1>
                            : cd_gram_block_kernel<T, LANES, 0, rt::PEN_BLOCK_MCP>);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(1, lanes), threads, dyn, (cudaStream_t)stream>>>(
        G, sr, sc, gl, c, L, beta0, q0, beta, q, K, nt, epochs, prm, pl, active, owners,
        use_smem, g_whole);
    return (int)cudaGetLastError();
  }
  if (per != 0 && per != kGramPer) return (int)cudaErrorInvalidValue;
  auto kernel = per ? cd_gram_block_cluster_kernel<T, kGramPer, LANES>
                    : cd_gram_block_cluster_kernel<T, 0, LANES>;
  return launch_cluster(kernel, cluster, threads, (size_t)dyn, stream, lanes, G, sr, sc, gl, c, L,
                        beta0, q0, beta, q, K, nt, epochs, pen, prm, use_smem, pl, active);
}

// K2 with the wrapper's plan (kernels/cd_epoch.py: xb_plan): a cluster of
// `cluster` CTAs with the slices in shared memory (use_smem) or global
// memory, `dyn` bytes of dynamic shared memory and the register path when
// per == kXbPer. `scratch` holds (cluster - 1) * K values, plus n on the
// global branch.
template <typename T>
int launch_xb(const T* Xt, const T* y, const T* w, int w_lane, const T* L, const T* off,
              const T* beta0, const T* Xb0, T* beta, T* Xb, T* scratch, long long scratch_lane,
              int K, int n, int epochs, int kind, int pen, const double* prm, int prm_lane,
              const unsigned char* active, int lanes, int cluster, int use_smem, int dyn,
              int threads, int per, void* stream) {
  if (per != 0 && per != kXbPer) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = per ? cd_xb_cluster_kernel<T, kXbPer> : cd_xb_cluster_kernel<T, 0>;
  return launch_cluster(kernel, cluster, threads, (size_t)dyn, stream, lanes, Xt, y, w, L, off,
                        beta0, Xb0, beta, Xb, scratch, K, n, epochs, kind, pen, prm, use_smem,
                        w_lane, scratch_lane, prm_lane, active);
}

}  // namespace

extern "C" {

int cd_epoch_gram_f64(const double* G, long long sr, long long sc, const double* c,
                      const double* L, const double* beta0, const double* q0, double* beta,
                      double* q, int K, int epochs, int pen, const double* prm, int cluster,
                      int dyn, int threads, void* stream) {
  return launch_gram<double, false>(G, sr, sc, 0, c, L, beta0, q0, beta, q, K, epochs, pen, prm,
                                    0, nullptr, 1, cluster, dyn, threads, stream);
}

int cd_epoch_gram_f32(const float* G, long long sr, long long sc, const float* c,
                      const float* L, const float* beta0, const float* q0, float* beta,
                      float* q, int K, int epochs, int pen, const double* prm, int cluster,
                      int dyn, int threads, void* stream) {
  return launch_gram<float, false>(G, sr, sc, 0, c, L, beta0, q0, beta, q, K, epochs, pen, prm,
                                   0, nullptr, 1, cluster, dyn, threads, stream);
}

// K1l: K1 on `lanes` lanes (G's lanes g_lane apart, c, L, beta, q K apart,
// the parameter rows prm_lane apart), lanes with active[lane] == 0 frozen;
// float64 only (the lane step's dense head, K3l, is float64 only too, and
// each instantiation of K1's kernels costs build time)
int cd_epoch_gram_lanes_f64(const double* G, long long sr, long long sc, long long g_lane,
                            const double* c, const double* L, const double* beta0,
                            const double* q0, double* beta, double* q, int K, int epochs,
                            int pen, const double* prm, int prm_lane,
                            const unsigned char* active, int lanes, int cluster, int dyn,
                            int threads, void* stream) {
  return launch_gram<double, true>(G, sr, sc, g_lane, c, L, beta0, q0, beta, q, K, epochs, pen,
                                   prm, prm_lane, active, lanes, cluster, dyn, threads, stream);
}



int cd_epoch_gram_block_f64(const double* G, long long sr, long long sc, const double* c,
                            const double* L, const double* beta0, const double* q0,
                            double* beta, double* q, int K, int nt, int epochs, int pen,
                            const double* prm, int cluster, int use_smem, int dyn,
                            int threads, int per, int owners, int g_whole, void* stream) {
  return launch_gram_block<double, false>(G, sr, sc, 0, c, L, beta0, q0, beta, q, K, nt, epochs,
                                          pen, prm, 0, nullptr, 1, cluster, use_smem, dyn,
                                          threads, per, owners, g_whole, stream);
}

int cd_epoch_gram_block_f32(const float* G, long long sr, long long sc, const float* c,
                            const float* L, const float* beta0, const float* q0, float* beta,
                            float* q, int K, int nt, int epochs, int pen, const double* prm,
                            int cluster, int use_smem, int dyn, int threads, int per,
                            int owners, int g_whole, void* stream) {
  return launch_gram_block<float, false>(G, sr, sc, 0, c, L, beta0, q0, beta, q, K, nt, epochs,
                                         pen, prm, 0, nullptr, 1, cluster, use_smem, dyn,
                                         threads, per, owners, g_whole, stream);
}

// K1bl: K1b on `lanes` lanes (G's lanes g_lane apart, c, beta, q K * nt
// apart, L K apart, the parameter rows prm_lane apart), lanes with
// active[lane] == 0 frozen; float64 only, as K1l
int cd_epoch_gram_block_lanes_f64(const double* G, long long sr, long long sc, long long g_lane,
                                  const double* c, const double* L, const double* beta0,
                                  const double* q0, double* beta, double* q, int K, int nt,
                                  int epochs, int pen, const double* prm, int prm_lane,
                                  const unsigned char* active, int lanes, int cluster,
                                  int use_smem, int dyn, int threads, int per, int owners,
                                  int g_whole, void* stream) {
  return launch_gram_block<double, true>(G, sr, sc, g_lane, c, L, beta0, q0, beta, q, K, nt,
                                         epochs, pen, prm, prm_lane, active, lanes, cluster,
                                         use_smem, dyn, threads, per, owners, g_whole, stream);
}

int cd_epoch_xb_f64(const double* Xt, const double* y, const double* w, const double* L,
                    const double* off, const double* beta0, const double* Xb0, double* beta,
                    double* Xb, double* scratch, int K, int n, int epochs, int kind, int pen,
                    const double* prm, int cluster, int use_smem, int dyn, int threads,
                    int per, void* stream) {
  return launch_xb<double>(Xt, y, w, 0, L, off, beta0, Xb0, beta, Xb, scratch, 0, K, n, epochs,
                           kind, pen, prm, 0, nullptr, 1, cluster, use_smem, dyn, threads, per,
                           stream);
}

int cd_epoch_xb_f32(const float* Xt, const float* y, const float* w, const float* L,
                    const float* off, const float* beta0, const float* Xb0, float* beta,
                    float* Xb, float* scratch, int K, int n, int epochs, int kind, int pen,
                    const double* prm, int cluster, int use_smem, int dyn, int threads,
                    int per, void* stream) {
  return launch_xb<float>(Xt, y, w, 0, L, off, beta0, Xb0, beta, Xb, scratch, 0, K, n, epochs,
                          kind, pen, prm, 0, nullptr, 1, cluster, use_smem, dyn, threads, per,
                          stream);
}

// K2l: K2 on `lanes` lanes (Xt's lanes K * n apart, y shared, w shared
// (w_lane 0) or n apart, L, off, beta K apart, Xb n apart, the scratch
// scratch_lane apart, the parameter rows prm_lane apart), lanes with
// active[lane] == 0 frozen
int cd_epoch_xb_lanes_f64(const double* Xt, const double* y, const double* w, int w_lane,
                          const double* L, const double* off, const double* beta0,
                          const double* Xb0, double* beta, double* Xb, double* scratch,
                          long long scratch_lane, int K, int n, int epochs, int kind, int pen,
                          const double* prm, int prm_lane, const unsigned char* active,
                          int lanes, int cluster, int use_smem, int dyn, int threads, int per,
                          void* stream) {
  return launch_xb<double>(Xt, y, w, w_lane, L, off, beta0, Xb0, beta, Xb, scratch,
                           scratch_lane, K, n, epochs, kind, pen, prm, prm_lane, active, lanes,
                           cluster, use_smem, dyn, threads, per, stream);
}

int cd_epoch_xb_lanes_f32(const float* Xt, const float* y, const float* w, int w_lane,
                          const float* L, const float* off, const float* beta0,
                          const float* Xb0, float* beta, float* Xb, float* scratch,
                          long long scratch_lane, int K, int n, int epochs, int kind, int pen,
                          const double* prm, int prm_lane, const unsigned char* active,
                          int lanes, int cluster, int use_smem, int dyn, int threads, int per,
                          void* stream) {
  return launch_xb<float>(Xt, y, w, w_lane, L, off, beta0, Xb0, beta, Xb, scratch, scratch_lane,
                          K, n, epochs, kind, pen, prm, prm_lane, active, lanes, cluster,
                          use_smem, dyn, threads, per, stream);
}

// The plans' placement query (kernels/cd_epoch.py: card_capacity): how many
// clusters of C CTAs of `threads` threads and `dyn` bytes of dynamic shared
// memory the card places at once, for the cluster kernel that launches:
// K1's (which == 0) or K1l's (3, float64 only) instance for penalty `pen`,
// K2's (1) or K1b's (2) on the register path (per != 0) or not; float64
// (f64) or float32
int cluster_capacity(int which, int f64, int per, int pen, int cluster, int threads, int dyn,
                     int* active) {
  switch (which) {
    case 0:
      return f64 ? gram_capacity<double, false>(pen, cluster, threads, dyn, active)
                 : gram_capacity<float, false>(pen, cluster, threads, dyn, active);
    case 3:
      return f64 ? gram_capacity<double, true>(pen, cluster, threads, dyn, active)
                 : (int)cudaErrorInvalidValue;
  }
  return f64 ? cluster_capacity_t<double>(which, per, cluster, threads, dyn, active)
             : cluster_capacity_t<float>(which, per, cluster, threads, dyn, active);
}

// The registers a thread and local (spill) bytes a thread of K1's (lanes ==
// 0) or K1l's float64 kernel for penalty `pen`, on one CTA (cluster == 0)
// or the cluster kernel, as cudaFuncGetAttributes reports them
int gram_kernel_attrs(int lanes, int cluster, int pen, int* regs, int* local) {
  auto kernel = lanes ? gram_kernel_of<double, true>(pen, cluster)
                      : gram_kernel_of<double, false>(pen, cluster);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}

// `iters` cluster barriers on one cluster of C CTAs of `threads` threads:
// the chain floor of the cluster kernels
int cluster_barrier_loop(int cluster, int threads, int iters, void* stream) {
  return launch_cluster(cluster_barrier_loop_kernel, cluster, threads, 0, stream, 1, iters);
}

// K1's chain floor in float64 on one CTA of `threads` threads: `epochs`
// passes of K chain steps (a shuffle and a multiply-add each) with K1's
// handoff every kGramB steps; `out` takes kGramB doubles
int gram_chain_floor(int K, int epochs, int threads, double* out, void* stream) {
  if (threads < 2 * kGramB || threads % 32 || threads > kGramMaxThreads)
    return (int)cudaErrorInvalidValue;
  gram_chain_floor_kernel<double><<<1, threads, 0, (cudaStream_t)stream>>>(K, epochs, 0.0, out);
  return (int)cudaGetLastError();
}

// K1b's one-CTA chain floor in float64 on one CTA of `threads` threads:
// `epochs` passes of K chain steps (a norm over nt tasks by the kernel's
// shuffle tree, a sqrt and a divide) with the kernel's hand-off every step;
// `out` takes 32 doubles
int gram_block_chain_floor(int K, int nt, int epochs, int threads, double* out, void* stream) {
  if (threads < 64 || threads > 1024 || threads % 32 || nt < 1 || nt > 32 * kBlockChain)
    return (int)cudaErrorInvalidValue;
  block_chain_floor_kernel<double><<<1, threads, 0, (cudaStream_t)stream>>>(K, nt, epochs, 0.0,
                                                                           out);
  return (int)cudaGetLastError();
}

// Fill the shared memory of every SM with 0xFF bytes (NaN in float32 and
// float64): two waves of one CTA an SM, each taking all the dynamic shared
// memory a CTA may have. A kernel launched next on the stream that reads
// shared memory it never wrote then reads NaN there and shows it.
int fill_shared_memory(void* stream) {
  int dev = 0, sms = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fill_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  fill_shared_kernel<<<2 * sms, 1024, bytes, (cudaStream_t)stream>>>(bytes / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
