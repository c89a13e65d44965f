// Greedy non-maximum suppression on the device, with no host synchronisation
// (CUDA C++, sm_90a).
//
// Replaces: afigan_tpu_torch/ops/nms.py's blocked plain loop on CUDA tensors,
// the counterpart of afigan_tpu/ops/nms.py::nms_keep_mask. That is XLA code
// in the JAX package, not a Pallas kernel: on the TPU a while loop over
// 128-box blocks with a self-suppression fixpoint inside each. In PyTorch
// the same loop makes the host wait on the card once per block and once per
// fixpoint sweep (tens of milliseconds a batch).
//
// The fixpoint has one solution, greedy NMS in score order, and this file
// computes it in one launch on the caller's stream: one thread block cluster
// per image (S blocks on S SMs: one per two tiles, up to 16, plan_of), which
// walks the sorted boxes in 64-box tiles; an image holds at most MAX_N boxes
// (16 blocks of the tiles that a block's shared memory holds). Tile t
// belongs to block t % S, which holds in its shared memory, for each of its
// tiles, the boxes in sorted order (and their areas), the validity bits, the
// removal bits and the tile's column words (for box j, the earlier boxes of
// its tile whose IoU with j exceeds the threshold). Nothing of size N^2 is
// ever stored.
//   1. Each block loads its tiles and computes their column words; the
//      cluster agrees on the last valid position (nothing after it is kept).
//   2. The walk. The owner of tile c resolves it from its own shared memory:
//      the candidates (valid, not removed) and the fixpoint K = cand & ~{j :
//      K & col[j] != 0}, a few ballots of one warp (its unique solution is
//      the greedy order within the tile). It stores the tile's kept bits and
//      raises the tile's flag (a release store at cluster scope); the others
//      wait for the flag with relaxed loads through distributed shared
//      memory and one acquire. In phase 1 each block has also computed, for
//      each of its boxes, the boxes of the tile just before (read from the
//      block before it) that would suppress it. A block's first warp walks:
//      for its tile t it waits for tile t - 1's flag, removes the boxes that
//      its kept bits hit in those words (an AND and a ballot: no IoU on the
//      walk's chain), and resolves t. Its other fifteen warps work: they take
//      the tiles in order (one warp copies the next tile's kept boxes while
//      the rest apply the current ones) and remove, from every later tile of
//      the block but the one that directly follows, the boxes that the kept
//      boxes suppress (only boxes not yet removed are tested, a lane against
//      four kept boxes at a time); the walker waits for them to be past
//      tile t - 2. With a stop, the workers keep a history of the kept boxes
//      and bring up to date only the tiles within 2S of the walk (a tile
//      entering that window takes the whole history), so tiles past the stop
//      cost nothing. Once `stop_after` boxes are kept, the owner keeps only
//      that many of the tile (the greedy prefix) and flags the stop; every
//      block ends there.
//   3. Each block writes the keep bytes of its tiles (0 where the walk did
//      not reach), and the cluster syncs once more before its shared memory
//      goes away.
// The IoU is computed in float32 in the order and rounding of
// ops/boxes.py::pairwise_iou (max/min, clamp at 0, w*h, (a1 + a2) - inter,
// inter / max(union, 1e-12), 0 where union <= 0), with __f*_rn so that no
// FMA contraction moves a box that sits at the threshold; max, min and the
// clamps propagate NaN as torch.maximum / torch.clamp do. Where the
// intersection is not positive the IoU is 0 in every case, so the division
// is skipped there.
//
// What bounds it on the H100: the walk is a chain of dependent steps, one per
// tile up to the stop: a flag and the kept bits read across SMs, an AND, and
// the fixpoint's ballots. No step of that chain touches global memory. Beside
// the chain, the workers' IoUs of the kept boxes against every later box
// that is not yet removed, spread over the cluster's SMs, which the walker
// waits for; where the boxes overlap little (a quick reject: no overlap, IoU
// 0) that is about 10 instructions a pair. The bytes (boxes, order and
// validity read, keep written) are a few microseconds of the card's memory
// rate.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;  // a walker warp and fifteen workers
constexpr int MAX_CLUSTER = 16;
// the shared memory a block may take on the H100 (227 KB), less a margin
// for the kernel's static shared variables
constexpr int SMEM_LIMIT = 232448 - 256;
// dynamic shared memory: per tile 64 boxes (16 B), column words and words
// over the previous tile (8 B each) and areas (4 B), kept bits, validity
// bits, removal bits (8 B each) and a flag (4 B); per block the workers' two
// copied lists of kept boxes (64 x 20 B each)
constexpr int TILE_BYTES = 64 * (16 + 8 + 8 + 4) + 8 + 8 + 8 + 4;
constexpr int LIST_BYTES = 2 * 64 * (16 + 4);
constexpr int HIST_BYTES = 16 + 4;  // a kept box of the workers' history
// the most tiles a block holds, and so the most boxes an image may have
constexpr int MAX_TILES_PER_BLOCK = (SMEM_LIMIT - LIST_BYTES) / TILE_BYTES;
constexpr int MAX_N = MAX_CLUSTER * MAX_TILES_PER_BLOCK * 64;
// the tiles a block is dealt where the cluster need not be the largest: more
// blocks share the IoUs that the walk waits for, and a step of the walk is a
// hop between SMs whatever the cluster
constexpr int TILES_PER_BLOCK = 2;
// a wait on another block's flag that outlasts this many polls is a fault
constexpr long long MAX_POLLS = 1ll << 24;

__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// whether boxes a and b overlap. Where they do not, their IoU is 0: fminf /
// fmaxf drop a NaN that tmin / tmax propagate, but a NaN coordinate gives
// IoU 0 as well, and a zero's sign does not move a difference across 0.
__device__ __forceinline__ bool overlaps(float4 a, float4 b) {
  return fminf(a.z, b.z) - fmaxf(a.x, b.x) > 0.f && fminf(a.w, b.w) - fmaxf(a.y, b.y) > 0.f;
}

// IoU(a, b) > thr for boxes that overlap, a the earlier box in score order;
// a1, a2 their areas
__device__ __forceinline__ bool exceeds(float4 a, float a1, float4 b, float a2, float thr) {
  const float w = clamp0(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)));
  const float h = clamp0(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  float iou = 0.f;
  if (inter > 0.f) {
    const float uni = __fsub_rn(__fadd_rn(a1, a2), inter);
    iou = uni > 0.f ? __fdiv_rn(inter, tmax(uni, 1e-12f)) : 0.f;
  }
  return iou > thr;
}

// IoU(a, b) > thr
__device__ __forceinline__ bool suppresses(float4 a, float a1, float4 b, float a2, float thr) {
  return overlaps(a, b) ? exceeds(a, a1, b, a2, thr) : 0.f > thr;
}

__device__ __forceinline__ unsigned ld_relaxed_cluster(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire_cluster(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cluster(unsigned* p, unsigned v) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

struct Tiles {
  float4* box;     // [T * 64] the block's boxes, tile by tile, in sorted order
  float4* kbox;    // [2][64] kept boxes being applied, the workers' two buffers
  float4* hbox;    // [H] every kept box so far, in order (the workers', with a stop)
  u64* col;        // [T * 64] column words
  u64* prev;       // [T * 64] for box j, the boxes of the previous tile that suppress it
  u64* kbits;      // [T] kept bits of a resolved tile (0 until then)
  u64* vbits;      // [T] validity bits
  float* area;     // [T * 64]
  float* karea;    // [2][64]
  float* harea;    // [H]
  unsigned* removed;  // [2 T] removal bits, two 32-bit halves a tile
  unsigned* flag;     // [T] 0, 1 resolved, 2 resolved and the walk stops there
};

__device__ __forceinline__ Tiles carve(unsigned char* smem, int T, int H) {
  Tiles s;
  s.box = reinterpret_cast<float4*>(smem);
  s.kbox = s.box + T * 64;
  s.hbox = s.kbox + 128;
  s.col = reinterpret_cast<u64*>(s.hbox + H);
  s.prev = s.col + T * 64;
  s.kbits = s.prev + T * 64;
  s.vbits = s.kbits + T;
  s.area = reinterpret_cast<float*>(s.vbits + T);
  s.karea = s.area + T * 64;
  s.harea = s.karea + 128;
  s.removed = reinterpret_cast<unsigned*>(s.harea + H);
  s.flag = s.removed + 2 * T;
  return s;
}

// Warp 0: resolve local tile u given the boxes kept before it; store its kept
// bits and raise its flag. Returns nothing: the flag carries the stop.
__device__ __forceinline__ void resolve(const Tiles& s, int u, int kept_before, int stop_after,
                                        int lane) {
  const u64 rem = ((u64)s.removed[2 * u + 1] << 32) | (u64)s.removed[2 * u];
  const u64 cand = s.vbits[u] & ~rem;
  const u64 c0 = s.col[u * 64 + lane], c1 = s.col[u * 64 + lane + 32];
  u64 k = cand;
  for (;;) {  // at most 64 rounds: round r settles every box of chain depth r
    const u64 sup = ((u64)__ballot_sync(FULL, (k & c1) != 0ull) << 32) |
                    (u64)__ballot_sync(FULL, (k & c0) != 0ull);
    const u64 next = cand & ~sup;
    if (next == k) break;
    k = next;
  }
  unsigned f = 1;
  if (stop_after > 0 && kept_before + __popcll(k) >= stop_after) {
    const int m = stop_after - kept_before;  // >= 1: the walk stops once it is 0
    while (__popcll(k) > m) k &= ~(1ull << (63 - __clzll((long long)k)));
    f = 2;
  }
  if (lane == 0) {
    s.kbits[u] = k;
    st_release_cluster(&s.flag[u], f);
  }
}

// The kept boxes kbox[0, nk) against local tiles [u0, u1): every box that is
// valid and not yet removed and that one of them suppresses is removed. The
// warps of a group (warp w of nw) take (tile half, slice of the list) items,
// as many slices as make the items a multiple of nw; a lane tests its box
// against four kept boxes at a time.
__device__ __forceinline__ void apply(const Tiles& s, const float4* kbox, const float* karea,
                                      int nk, int u0, int u1, float thr, int w, int nw,
                                      int lane) {
  const int halves = 2 * (u1 - u0);
  if (nk == 0 || halves <= 0) return;
  int a = halves, b = nw;  // gcd
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int slices = max(1, min(nk, nw / a));
  const bool all = 0.f > thr;  // then every kept box suppresses every later box
  for (int it = w; it < halves * slices; it += nw) {
    const int hh = it / slices, sl = it % slices;
    const int u = u0 + (hh >> 1), h = hh & 1;
    const unsigned avail = reinterpret_cast<const unsigned*>(s.vbits)[2 * u + h] &
                           ~*reinterpret_cast<volatile unsigned*>(&s.removed[2 * u + h]);
    if (avail == 0u) continue;  // the whole warp
    bool hit = false;
    if ((avail >> lane) & 1u) {
      if (all) {
        hit = sl < nk;
      } else {
        const int e = u * 64 + h * 32 + lane;
        const float4 q = s.box[e];
        const float qa = s.area[e];
        const int st = slices;
        int k = sl;
        for (; k + 3 * st < nk && !hit; k += 4 * st) {
          const float4 b0 = kbox[k], b1 = kbox[k + st], b2 = kbox[k + 2 * st],
                       b3 = kbox[k + 3 * st];
          const bool o0 = overlaps(b0, q), o1 = overlaps(b1, q), o2 = overlaps(b2, q),
                     o3 = overlaps(b3, q);
          if (o0 || o1 || o2 || o3)
            hit = (o0 && exceeds(b0, karea[k], q, qa, thr)) ||
                  (o1 && exceeds(b1, karea[k + st], q, qa, thr)) ||
                  (o2 && exceeds(b2, karea[k + 2 * st], q, qa, thr)) ||
                  (o3 && exceeds(b3, karea[k + 3 * st], q, qa, thr));
        }
        for (; k < nk && !hit; k += st) hit = suppresses(kbox[k], karea[k], q, qa, thr);
      }
    }
    const unsigned bal = __ballot_sync(FULL, hit);
    if (lane == 0 && bal) atomicOr(&s.removed[2 * u + h], bal);
  }
}

// Wait for tile c's flag (its owner's shared memory, through the cluster's
// window where the owner is another block): relaxed loads, `nap` ns apart,
// then one acquire. Returns the flag.
__device__ __forceinline__ unsigned wait_flag(const Tiles& s, const cg::cluster_group& cluster,
                                              int c, int S, int rank, unsigned nap) {
  const int owner = c % S, uc = c / S;
  const unsigned* rf = owner == rank ? s.flag + uc : cluster.map_shared_rank(s.flag + uc, owner);
  long long polls = 0;
  while (ld_relaxed_cluster(rf) == 0u) {
    if (++polls > MAX_POLLS) __trap();
    if (nap) __nanosleep(nap);
  }
  return ld_acquire_cluster(rf);
}

// tile c's kept bits, once its flag is up
__device__ __forceinline__ u64 kept_bits(const Tiles& s, const cg::cluster_group& cluster, int c,
                                         int S, int rank) {
  const int owner = c % S, uc = c / S;
  return owner == rank ? s.kbits[uc] : *cluster.map_shared_rank(s.kbits + uc, owner);
}

// One warp: wait for tile c's flag, then copy its kept boxes into kbox /
// karea. Returns (kept boxes, the flag).
__device__ __forceinline__ int2 fetch(const Tiles& s, const cg::cluster_group& cluster, int c,
                                      int S, int rank, float4* kbox, float* karea, int lane,
                                      unsigned nap) {
  const unsigned f = wait_flag(s, cluster, c, S, rank, nap);
  const int owner = c % S, uc = c / S;
  const bool here = owner == rank;
  const float4* sb = here ? s.box + uc * 64 : cluster.map_shared_rank(s.box + uc * 64, owner);
  const float* sa = here ? s.area + uc * 64 : cluster.map_shared_rank(s.area + uc * 64, owner);
  // the kept bits and every box of the tile in one round of loads
  const u64 kb = here ? s.kbits[uc] : *cluster.map_shared_rank(s.kbits + uc, owner);
  const float4 b0 = sb[lane], b1 = sb[lane + 32];
  const float a0 = sa[lane], a1 = sa[lane + 32];
  if ((kb >> lane) & 1ull) {
    const int at = __popcll(kb & ((1ull << lane) - 1ull));
    kbox[at] = b0;
    karea[at] = a0;
  }
  if ((kb >> (lane + 32)) & 1ull) {
    const int at = __popcll(kb & ((1ull << (lane + 32)) - 1ull));
    kbox[at] = b1;
    karea[at] = a1;
  }
  return make_int2(__popcll(kb), (int)f);
}

// the first local tile whose global index exceeds x
__device__ __forceinline__ int first_after(int x, int rank, int S) {
  return x < rank ? 0 : (x - rank) / S + 1;
}

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// grid (S, B) in clusters of (S, 1, 1), THREADS threads, dynamic shared memory
// T * TILE_BYTES + LIST_BYTES + H * HIST_BYTES; S * T * 64 >= N; H 0 or at
// least stop_after
__global__ void __launch_bounds__(THREADS, 1)
    nms_cluster_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                       const int64_t* __restrict__ order, float thr, int N, int stop_after,
                       int T, int H, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last, s_tiles, s_knk[2], s_kstop[2];
  __shared__ volatile int s_done;     // tiles the workers have applied, in order
  __shared__ volatile int s_stopped;  // the workers met the stop
  __shared__ int s_cum[4];            // kept boxes up to the workers' last tiles
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const Tiles s = carve(smem, T, H);
  const int64_t* ord = order + (size_t)b * N;
  const uint8_t* val = valid + (size_t)b * N;
  const float* bx = boxes + (size_t)b * N * 4;
  uint8_t* kp = keep + (size_t)b * N;

  // 1. the block's tiles: local tile u is tile u * S + rank of the image
  if (tid == 0) {
    s_last = 0;
    s_done = 0;
    s_stopped = 0;
  }
  for (int i = tid; i < 2 * T; i += blockDim.x) s.removed[i] = 0u;
  for (int i = tid; i < T; i += blockDim.x) {
    s.flag[i] = 0u;
    s.kbits[i] = 0ull;
  }
  __syncthreads();
  int last = 0;
  for (int e = tid; e < T * 64; e += blockDim.x) {  // T * 64: whole warps
    const int j = ((e >> 6) * S + rank) * 64 + (e & 63);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    bool ok = false;
    if (j < N) {
      const int64_t o = ord[j];
      const float* p = bx + 4 * o;
      v = make_float4(p[0], p[1], p[2], p[3]);
      ok = val[o] != 0;
      if (ok) last = j + 1;
    }
    s.box[e] = v;
    s.area[e] = area_of(v);
    const unsigned bal = __ballot_sync(FULL, ok);
    if (lane == 0) reinterpret_cast<unsigned*>(s.vbits)[e >> 5] = bal;
  }
  if (last) atomicMax(&s_last, last);
  __syncthreads();
  for (int e = tid; e < T * 64; e += blockDim.x) {
    const int l = e & 63;
    const float4* tb = s.box + (e - l);
    const float* ta = s.area + (e - l);
    const float4 q = s.box[e];
    const float qa = s.area[e];
    u64 bits = 0ull;
    for (int i = 0; i < l; ++i)
      if (suppresses(tb[i], ta[i], q, qa, thr)) bits |= 1ull << i;
    s.col[e] = bits;
  }
  cluster.sync();  // every block's tiles and last valid position are in place
  if (warp == 0) {
    int n_last = lane < S ? *cluster.map_shared_rank(&s_last, lane) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n_last = max(n_last, __shfl_xor_sync(FULL, n_last, o));
    if (lane == 0) s_tiles = (n_last + 63) / 64;
  }
  // for each box of the block's tiles, the boxes of the tile before it (the
  // block before in the cluster holds it) that would suppress it: the walk's
  // step needs only those and the previous tile's kept bits
  for (int e = tid; e < T * 64; e += blockDim.x) {
    const int t = (e >> 6) * S + rank;
    u64 bits = 0ull;
    if (t >= 1 && t * 64 < N) {
      const int pu = (t - 1) / S, pr = (t - 1) % S;
      const float4* pb = cluster.map_shared_rank(s.box + pu * 64, pr);
      const float* pa = cluster.map_shared_rank(s.area + pu * 64, pr);
      const float4 q = s.box[e];
      const float qa = s.area[e];
#pragma unroll 8
      for (int i = 0; i < 64; ++i)
        if (suppresses(pb[i], pa[i], q, qa, thr)) bits |= 1ull << i;
    }
    s.prev[e] = bits;
  }
  __syncthreads();
  const int tiles = s_tiles;
  const int mine = tiles > rank ? (tiles - rank + S - 1) / S : 0;  // local tiles walked

  // 2. the walk
  if (warp == 0) {
    // The walker resolves the block's tiles in order. The workers bring tile
    // t up to date with the kept boxes of every tile before t - 1; the step
    // of the walk is then the flag of tile t - 1, its kept bits against the
    // previous-tile words of t, and the fixpoint of t: no IoU on the chain.
    for (int u = 0; u < mine; ++u) {
      const int t = u * S + rank;
      long long polls = 0;
      while (s_done < t - 1 && !s_stopped)
        if (++polls > MAX_POLLS) __trap();
      __threadfence_block();
      if (s_stopped) break;
      int kept = 0;
      if (t >= 1) {
        const unsigned f = wait_flag(s, cluster, t - 1, S, rank, 0);
        if (f == 2u) break;
        const u64 kb = kept_bits(s, cluster, t - 1, S, rank);
        const u64 p0 = s.prev[u * 64 + lane], p1 = s.prev[u * 64 + lane + 32];
        const unsigned r0 = __ballot_sync(FULL, (p0 & kb) != 0ull);
        const unsigned r1 = __ballot_sync(FULL, (p1 & kb) != 0ull);
        if (lane == 0) {
          s.removed[2 * u] |= r0;
          s.removed[2 * u + 1] |= r1;
        }
        __syncwarp();
        kept = (t >= 2 ? s_cum[(t - 2) & 3] : 0) + __popcll(kb);
      }
      resolve(s, u, kept, stop_after, lane);
    }
  } else {
    // The workers take the tiles in order and apply each one's kept boxes to
    // the block's later tiles but the one that directly follows it (the
    // walker takes that one). Their first warp fetches the next tile's list
    // while the others apply the current one. With a stop (H > 0) the lists
    // go on into a history of every kept box, and only the tiles within 2S
    // of the walk are brought up to date: a tile that enters that window
    // takes the whole history, and the tiles past the stop are never
    // touched. Without one, every later tile takes each list (two buffers).
    const int w = warp - 1, nw = nwarps - 1;
    const bool lazy = H > 0;
    const int ahead = 2 * S;
    auto first = [&](int c) {  // the block's first tile after c that the workers serve
      const int u = first_after(c, rank, S);
      return u * S + rank == c + 1 ? u + 1 : u;
    };
    auto wanted = [&](int c) { return c < tiles && first(c) < mine; };
    auto list = [&](int c, int at) { return lazy ? at : 64 * (c & 1); };
    int K = 0;  // kept boxes of the tiles before c
    if (w == 0 && wanted(0)) {
      const int2 r = fetch(s, cluster, 0, S, rank, (lazy ? s.hbox : s.kbox) + list(0, 0),
                           (lazy ? s.harea : s.karea) + list(0, 0), lane, 64);
      if (lane == 0) {
        s_knk[0] = r.x;
        s_kstop[0] = r.y == 2;
      }
    }
    group_sync(1, nw * 32);
    for (int c = 0; wanted(c); ++c) {
      const int cur = c & 1, nxt = cur ^ 1;
      if (s_kstop[cur]) {
        if (w == 0 && lane == 0) s_stopped = 1;
        break;
      }
      const int nk = s_knk[cur];
      const int u0 = first(c);
      if (w == 0) {
        if (wanted(c + 1)) {
          const int at = list(c + 1, K + nk);
          const int2 r = fetch(s, cluster, c + 1, S, rank, (lazy ? s.hbox : s.kbox) + at,
                               (lazy ? s.harea : s.karea) + at, lane, 64);
          if (lane == 0) {
            s_knk[nxt] = r.x;
            s_kstop[nxt] = r.y == 2;
          }
        }
      } else if (!lazy) {
        const int at = list(c, 0);
        apply(s, s.kbox + at, s.karea + at, nk, u0, mine, thr, w - 1, nw - 1, lane);
      } else {
        const int u1 = min(mine, first_after(c + ahead, rank, S));
        const int was = c > 0 ? min(mine, first_after(c - 1 + ahead, rank, S)) : 0;
        for (int u = u0; u < u1; ++u) {
          const int from = u < was ? K : 0;  // a tile new to the window: the whole history
          apply(s, s.hbox + from, s.harea + from, K + nk - from, u, u + 1, thr, w - 1, nw - 1,
                lane);
        }
      }
      group_sync(1, nw * 32);
      K += nk;
      if (w == 0 && lane == 0) {
        s_cum[c & 3] = K;
        __threadfence_block();
        s_done = c + 1;
      }
    }
    if (w == 0 && lane == 0) {  // nothing left for the walker to wait on
      __threadfence_block();
      s_done = 1 << 30;
    }
  }
  __syncthreads();

  // 3. the keep bytes of the block's tiles
  for (int e = tid; e < T * 64; e += blockDim.x) {
    const int j = ((e >> 6) * S + rank) * 64 + (e & 63);
    if (j < N) kp[j] = (uint8_t)((s.kbits[e >> 6] >> (e & 63)) & 1ull);
  }
  cluster.sync();  // no block leaves while another may still read its tiles
}

// The cluster that walks an image of n boxes (1 <= n <= MAX_N): one block
// per TILES_PER_BLOCK tiles, up to MAX_CLUSTER, each with an equal share of
// the ceil(n / 64) tiles; with stop_after > 0, room for that many kept boxes
// of history where the shared memory has it (else none: every later tile
// takes each list).
struct Plan {
  int cluster, tiles_per_block, history;
  long long smem;  // dynamic shared memory a block, bytes
};

Plan plan_of(int n, int stop_after) {
  const int tiles = (n + 63) / 64;
  const int size = min(MAX_CLUSTER, max((tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK,
                                        (tiles + MAX_TILES_PER_BLOCK - 1) / MAX_TILES_PER_BLOCK));
  Plan p;
  p.cluster = size;
  p.tiles_per_block = (tiles + size - 1) / size;
  p.smem = (long long)p.tiles_per_block * TILE_BYTES + LIST_BYTES;
  p.history =
      stop_after > 0 && p.smem + (long long)stop_after * HIST_BYTES <= SMEM_LIMIT ? stop_after : 0;
  p.smem += (long long)p.history * HIST_BYTES;
  return p;
}

}  // namespace

// The most boxes an image may have: MAX_CLUSTER blocks of the tiles a
// block's shared memory holds.
extern "C" int nms_max_n() { return MAX_N; }

// The launch's plan for an image of n boxes: out[0..2] = blocks in the
// cluster, 64-box tiles a block, kept boxes of history. Returns
// cudaErrorInvalidValue for n < 1 or n > MAX_N.
extern "C" int nms_plan(int n, int stop_after, int* out) {
  if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n, stop_after);
  out[0] = p.cluster;
  out[1] = p.tiles_per_block;
  out[2] = p.history;
  return 0;
}

// boxes (B, N, 4) float32 in the caller's order; valid (B, N) bool; order
// (B, N) int64, the stable score-descending permutation of each image; keep
// (B, N) bool in sorted order. One cluster of plan_of(N, stop_after) per
// image; N at most MAX_N. Returns the launch's cudaError_t.
extern "C" int nms_forward(const float* boxes, const uint8_t* valid, const int64_t* order,
                           float iou_threshold, int B, int N, int stop_after, uint8_t* keep,
                           void* stream) {
  if (B <= 0 || N <= 0 || B > 65535 || N > MAX_N) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(N, stop_after);
  const int cluster = p.cluster;
  const long long smem = p.smem;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(nms_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(nms_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, boxes, valid, order, iou_threshold, N,
                         stop_after, p.tiles_per_block, p.history, keep);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
