// reloc_forest: backtracking decision-tree regression (BTDTR) relocalizer.
//
// Native-C++ parity component for the reference's only first-party native
// module (`slam_system/rf_map/`, SURVEY.md §2 layer 6, §3): a random forest
// mapping feature descriptors directly to landmark rays (theta, phi),
// trained online from keyframes, queried with leaf backtracking when
// tracking is lost. Exposed to Python through a C API + ctypes
// (`ptzjax/reloc_forest.py`), mirroring how the reference loads its .so.
//
// Design (re-derived, not ported — the reference mount was empty):
//  - axis-aligned splits on descriptor dimensions; candidate (dim, thresh)
//    pairs chosen at random per node, scored by the reduction in summed
//    per-side ray variance (regression criterion);
//  - leaves store the mean ray and the mean descriptor of their samples;
//  - query descends each tree, then BACKTRACKS through the nearest
//    alternative subtrees (priority queue ordered by split-plane margin),
//    examining up to `backtrack_leaves` leaves; the candidate whose leaf
//    mean descriptor is closest in L2 wins across all trees;
//  - online training: samples accumulate per add_keyframe; trees rebuild
//    lazily once the sample count outgrows the last build by 25% (amortized
//    O(N log N) — rebuilds are milliseconds at SLAM map scales);
//  - ASYNC training (rf_set_async): rebuilds run on a
//    background std::thread against a SNAPSHOT of the sample arrays and
//    swap in under a mutex, so the SLAM host loop never stalls at keyframe
//    time; queries keep serving the previous trees while a build is in
//    flight. One trainer at a time (joined before the next launch), and
//    only the trainer touches the RNG, so the tree sequence is the same
//    deterministic one the synchronous path produces for the same rebuild
//    schedule.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Node {
  int dim = -1;          // split dimension; -1 => leaf
  float thresh = 0.f;
  int left = -1, right = -1;
  // leaf payload
  float ray[2] = {0.f, 0.f};
  int count = 0;
  int desc_off = -1;     // offset into the tree set's leaf-descriptor pool
};

struct Tree {
  std::vector<Node> nodes;
};

struct Config {
  int num_trees = 8;
  int max_depth = 16;
  int min_leaf = 4;
  int candidate_dims = 16;
  int candidate_thresh = 8;
  int backtrack_leaves = 8;
  uint32_t seed = 17;
};

// Everything a build WRITES, swapped in atomically when done.
struct TreeSet {
  std::vector<Tree> trees;
  std::vector<float> leaf_desc;   // pooled per-leaf mean descriptors
  size_t built_samples = 0;
};

// Everything a build READS (a snapshot for async builds; aliases the live
// arrays for synchronous ones).
struct BuildInput {
  Config cfg;
  int dim = 0;
  std::vector<float> desc;        // (n, dim)
  std::vector<float> rays;        // (n, 2)
  size_t n_samples() const { return rays.size() / 2; }
};

struct Forest {
  Config cfg;
  int dim = 0;                    // descriptor dimensionality (set on first add)
  std::vector<float> desc;        // (n, dim) training descriptors
  std::vector<float> rays;        // (n, 2) training rays
  TreeSet ts;                     // served trees (guarded by mu when async)
  std::mt19937 rng;               // owned by whoever is building (one at a time)
  std::mutex mu;                  // guards ts swap vs. queries
  std::thread trainer;
  std::atomic<bool> training{false};
  bool async_mode = false;

  size_t n_samples() const { return rays.size() / 2; }
  void join_trainer() {
    if (trainer.joinable()) trainer.join();
  }
  ~Forest() { join_trainer(); }
};

float ray_variance(const BuildInput& in, const std::vector<int>& idx) {
  if (idx.empty()) return 0.f;
  double m0 = 0, m1 = 0;
  for (int i : idx) { m0 += in.rays[2 * i]; m1 += in.rays[2 * i + 1]; }
  m0 /= idx.size(); m1 /= idx.size();
  double v = 0;
  for (int i : idx) {
    double a = in.rays[2 * i] - m0, b = in.rays[2 * i + 1] - m1;
    v += a * a + b * b;
  }
  return static_cast<float>(v);
}

int build_node(const BuildInput& in, TreeSet& ts, std::mt19937& rng, Tree& t,
               std::vector<int>& idx, int depth) {
  int id = static_cast<int>(t.nodes.size());
  t.nodes.emplace_back();

  auto make_leaf = [&](Node& n) {
    double m0 = 0, m1 = 0;
    std::vector<double> dmean(in.dim, 0.0);
    for (int i : idx) {
      m0 += in.rays[2 * i];
      m1 += in.rays[2 * i + 1];
      const float* d = &in.desc[static_cast<size_t>(i) * in.dim];
      for (int k = 0; k < in.dim; ++k) dmean[k] += d[k];
    }
    size_t c = idx.size();
    n.dim = -1;
    n.count = static_cast<int>(c);
    n.ray[0] = static_cast<float>(m0 / c);
    n.ray[1] = static_cast<float>(m1 / c);
    n.desc_off = static_cast<int>(ts.leaf_desc.size());
    for (int k = 0; k < in.dim; ++k)
      ts.leaf_desc.push_back(static_cast<float>(dmean[k] / c));
  };

  if (static_cast<int>(idx.size()) <= in.cfg.min_leaf ||
      depth >= in.cfg.max_depth) {
    make_leaf(t.nodes[id]);
    return id;
  }

  float parent_var = ray_variance(in, idx);
  float best_gain = 1e-12f;
  int best_dim = -1;
  float best_thresh = 0.f;
  std::vector<int> lbuf, rbuf, best_l, best_r;
  std::uniform_int_distribution<int> dim_pick(0, in.dim - 1);
  std::uniform_int_distribution<int> samp_pick(0, static_cast<int>(idx.size()) - 1);

  for (int cd = 0; cd < in.cfg.candidate_dims; ++cd) {
    int d = dim_pick(rng);
    for (int ct = 0; ct < in.cfg.candidate_thresh; ++ct) {
      float th = in.desc[static_cast<size_t>(idx[samp_pick(rng)]) * in.dim + d];
      lbuf.clear(); rbuf.clear();
      for (int i : idx) {
        (in.desc[static_cast<size_t>(i) * in.dim + d] < th ? lbuf : rbuf)
            .push_back(i);
      }
      if (lbuf.empty() || rbuf.empty()) continue;
      float gain = parent_var - ray_variance(in, lbuf) - ray_variance(in, rbuf);
      if (gain > best_gain) {
        best_gain = gain; best_dim = d; best_thresh = th;
        best_l = lbuf; best_r = rbuf;
      }
    }
  }

  if (best_dim < 0) {
    make_leaf(t.nodes[id]);
    return id;
  }
  // recurse (idx freed first to bound memory)
  std::vector<int>().swap(idx);
  int l = build_node(in, ts, rng, t, best_l, depth + 1);
  int r = build_node(in, ts, rng, t, best_r, depth + 1);
  t.nodes[id].dim = best_dim;
  t.nodes[id].thresh = best_thresh;
  t.nodes[id].left = l;
  t.nodes[id].right = r;
  return id;
}

TreeSet build_trees(const BuildInput& in, std::mt19937& rng) {
  TreeSet ts;
  size_t n = in.n_samples();
  ts.trees.assign(in.cfg.num_trees, Tree{});
  std::uniform_int_distribution<int> pick(0, static_cast<int>(n) - 1);
  for (auto& t : ts.trees) {
    // bootstrap sample per tree (bagging)
    std::vector<int> idx(n);
    for (size_t i = 0; i < n; ++i) idx[i] = pick(rng);
    std::sort(idx.begin(), idx.end());
    idx.erase(std::unique(idx.begin(), idx.end()), idx.end());
    build_node(in, ts, rng, t, idx, 0);
  }
  ts.built_samples = n;
  return ts;
}

// Synchronous rebuild from the live sample arrays (also the save/load path).
void rebuild(Forest& f) {
  f.join_trainer();
  BuildInput in{f.cfg, f.dim, f.desc, f.rays};
  TreeSet ts = build_trees(in, f.rng);
  std::lock_guard<std::mutex> lk(f.mu);
  f.ts = std::move(ts);
}

bool rebuild_due(const Forest& f) {
  size_t n = f.n_samples();
  if (n == 0) return false;
  size_t b = f.ts.built_samples;
  return f.ts.trees.empty() || n > b + b / 4 || n < b;
}

void maybe_rebuild(Forest& f) {
  if (!rebuild_due(f)) return;
  if (!f.async_mode) {
    rebuild(f);
    return;
  }
  if (f.training.load()) return;  // a build is in flight; next add retries
  f.join_trainer();               // reap the finished thread object
  f.training.store(true);
  // snapshot the samples: the host keeps appending while we build
  auto in = std::make_shared<BuildInput>(BuildInput{f.cfg, f.dim, f.desc, f.rays});
  Forest* fp = &f;
  f.trainer = std::thread([fp, in]() {
    TreeSet ts = build_trees(*in, fp->rng);  // rng: trainer-exclusive
    {
      std::lock_guard<std::mutex> lk(fp->mu);
      fp->ts = std::move(ts);
    }
    fp->training.store(false);
  });
}

struct LeafHit {
  float desc_dist2;
  const Node* leaf;
};

// descend with backtracking: explore alternative branches in order of
// split-plane margin until the leaf budget is exhausted.
void query_tree(const Config& cfg, int dim, const TreeSet& ts, const Tree& t,
                const float* q, std::vector<LeafHit>& hits) {
  using Alt = std::pair<float, int>;  // (margin, node id)
  std::priority_queue<Alt, std::vector<Alt>, std::greater<Alt>> alts;
  int budget = cfg.backtrack_leaves;
  int node = 0;
  while (budget > 0) {
    const Node* n = &t.nodes[node];
    while (n->dim >= 0) {
      float margin = q[n->dim] - n->thresh;
      int take = margin < 0 ? n->left : n->right;
      int other = margin < 0 ? n->right : n->left;
      alts.emplace(std::fabs(margin), other);
      n = &t.nodes[take];
    }
    // leaf reached
    const float* ld = &ts.leaf_desc[n->desc_off];
    float d2 = 0;
    for (int k = 0; k < dim; ++k) {
      float diff = q[k] - ld[k];
      d2 += diff * diff;
    }
    hits.push_back({d2, n});
    if (--budget <= 0 || alts.empty()) break;
    node = alts.top().second;
    alts.pop();
  }
}

}  // namespace

extern "C" {

void* rf_create(int num_trees, int max_depth, int min_leaf,
                int candidate_dims, int candidate_thresh,
                int backtrack_leaves, uint32_t seed) {
  auto* f = new Forest();
  f->cfg = Config{num_trees, max_depth, min_leaf, candidate_dims,
                  candidate_thresh, backtrack_leaves, seed};
  f->rng.seed(seed);
  return f;
}

void rf_destroy(void* h) { delete static_cast<Forest*>(h); }

// Enable/disable background training (off by default — synchronous
// rebuilds preserve the exact historical behavior).
void rf_set_async(void* h, int enable) {
  static_cast<Forest*>(h)->async_mode = enable != 0;
}

// 1 while a background build is in flight.
int rf_training(void* h) {
  return static_cast<Forest*>(h)->training.load() ? 1 : 0;
}

// Block until any background build completes (tests, save, shutdown).
void rf_wait(void* h) { static_cast<Forest*>(h)->join_trainer(); }

// Append keyframe samples: desc (n, dim) row-major fp32, rays (n, 2).
// Returns 0 on success, -1 on dim mismatch. In async mode this returns in
// ~the memcpy time; any due rebuild happens on the trainer thread.
int rf_add_keyframe(void* h, const float* desc, const float* rays, int n,
                    int dim) {
  auto* f = static_cast<Forest*>(h);
  if (f->dim == 0) f->dim = dim;
  if (dim != f->dim || n <= 0) return -1;
  f->desc.insert(f->desc.end(), desc, desc + static_cast<size_t>(n) * dim);
  f->rays.insert(f->rays.end(), rays, rays + static_cast<size_t>(n) * 2);
  maybe_rebuild(*f);
  return 0;
}

int rf_num_samples(void* h) {
  return static_cast<int>(static_cast<Forest*>(h)->n_samples());
}

// Predict rays for n query descriptors. out_rays (n, 2); out_conf (n,)
// in [0, 1]: 1 - normalized descriptor distance of the winning leaf
// (callers threshold it). Returns number predicted, or -1 on error.
// Serves the last completed tree set; never blocks on an in-flight build.
int rf_relocalize(void* h, const float* desc, int n, int dim,
                  float* out_rays, float* out_conf) {
  auto* f = static_cast<Forest*>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  if (f->ts.trees.empty() || dim != f->dim) return -1;
  std::vector<LeafHit> hits;
  for (int i = 0; i < n; ++i) {
    const float* q = desc + static_cast<size_t>(i) * dim;
    hits.clear();
    for (const auto& t : f->ts.trees)
      query_tree(f->cfg, f->dim, f->ts, t, q, hits);
    const LeafHit* best = nullptr;
    for (const auto& hsel : hits) {
      if (!best || hsel.desc_dist2 < best->desc_dist2) best = &hsel;
    }
    if (!best) return -1;
    out_rays[2 * i] = best->leaf->ray[0];
    out_rays[2 * i + 1] = best->leaf->ray[1];
    // unit-norm descriptors: d2 in [0, 4]; d2 of 0.5 ~ cosine 0.75
    float c = 1.f - best->desc_dist2 / 2.f;
    out_conf[i] = c < 0.f ? 0.f : c;
  }
  return n;
}

// Binary serialization (config + samples; trees rebuild on load so the
// format stays independent of in-memory layout). Saving re-seeds and
// rebuilds the live forest first: incremental training advances the RNG,
// so without this the loaded copy (fresh seed) would grow slightly
// different trees than the one that was saved.
int rf_save(void* h, const char* path) {
  auto* f = static_cast<Forest*>(h);
  f->join_trainer();
  f->rng.seed(f->cfg.seed);
  rebuild(*f);
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  uint32_t magic = 0x52464d31;  // "RFM1"
  uint64_t n = f->n_samples();
  std::fwrite(&magic, 4, 1, fp);
  std::fwrite(&f->cfg, sizeof(Config), 1, fp);
  std::fwrite(&f->dim, 4, 1, fp);
  std::fwrite(&n, 8, 1, fp);
  std::fwrite(f->desc.data(), 4, f->desc.size(), fp);
  std::fwrite(f->rays.data(), 4, f->rays.size(), fp);
  std::fclose(fp);
  return 0;
}

void* rf_load(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  uint32_t magic = 0;
  if (std::fread(&magic, 4, 1, fp) != 1 || magic != 0x52464d31) {
    std::fclose(fp);
    return nullptr;
  }
  auto* f = new Forest();
  uint64_t n = 0;
  bool ok = std::fread(&f->cfg, sizeof(Config), 1, fp) == 1 &&
            std::fread(&f->dim, 4, 1, fp) == 1 &&
            std::fread(&n, 8, 1, fp) == 1;
  if (ok) {
    f->desc.resize(n * f->dim);
    f->rays.resize(n * 2);
    ok = std::fread(f->desc.data(), 4, f->desc.size(), fp) == f->desc.size() &&
         std::fread(f->rays.data(), 4, f->rays.size(), fp) == f->rays.size();
  }
  std::fclose(fp);
  if (!ok) { delete f; return nullptr; }
  f->rng.seed(f->cfg.seed);
  rebuild(*f);
  return f;
}

}  // extern "C"
