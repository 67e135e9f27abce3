// Host-side connected-component labelling and region statistics: a
// two-pass union-find CCL with fused per-label area and bbox extraction,
// the host counterpart of the card's CCL kernels. A copy of
// plumekit/native/ccl.cpp. Single translation unit, C ABI, loaded with
// ctypes.
//
// Build: plumekit_torch/native/build.py (g++ -O3 -march=native -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t i) {
    while (parent[i] != i) {
      parent[i] = parent[parent[i]];
      i = parent[i];
    }
    return i;
  }
  void unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
  }
};

}  // namespace

extern "C" {

// Label a HxW uint8 mask (nonzero = foreground). Writes int32 labels
// (0 = background, 1..n components in first-encounter order) into `out`.
// connectivity: 1 (cross) or 2 (8-neighbour). Returns the component count.
int32_t plumekit_ccl_label(const uint8_t* mask, int32_t h, int32_t w,
                           int32_t connectivity, int32_t* out) {
  const size_t n = static_cast<size_t>(h) * w;
  // provisional labels: run-based. First pass: assign each foreground pixel
  // the label of its west/north(-west/-east) neighbour or a fresh id.
  std::vector<int32_t> prov(n, -1);
  UnionFind uf(n / 2 + 2);  // 4-conn worst case (checkerboard) is ceil(n/2)
  int32_t next = 0;
  for (int32_t r = 0; r < h; ++r) {
    const uint8_t* row = mask + static_cast<size_t>(r) * w;
    int32_t* prow = prov.data() + static_cast<size_t>(r) * w;
    // computed only when a previous row exists: forming the r-1 pointer at
    // r==0 would be out-of-range pointer arithmetic (UB even undereferenced)
    const int32_t* prev = (r > 0) ? prow - w : nullptr;
    for (int32_t c = 0; c < w; ++c) {
      if (!row[c]) continue;
      int32_t lbl = -1;
      if (c > 0 && prow[c - 1] >= 0) lbl = prow[c - 1];
      if (r > 0) {
        if (prev[c] >= 0) {
          if (lbl >= 0) uf.unite(lbl, prev[c]); else lbl = prev[c];
        }
        if (connectivity == 2) {
          if (c > 0 && prev[c - 1] >= 0) {
            if (lbl >= 0) uf.unite(lbl, prev[c - 1]); else lbl = prev[c - 1];
          }
          if (c + 1 < w && prev[c + 1] >= 0) {
            if (lbl >= 0) uf.unite(lbl, prev[c + 1]); else lbl = prev[c + 1];
          }
        }
      }
      if (lbl < 0) {
        lbl = next++;
        if (static_cast<size_t>(next) >= uf.parent.size())
          uf.parent.push_back(next);  // grow self-rooted (value == index)
      }
      prow[c] = lbl;
    }
  }
  // second pass: compact roots to 1..n in first-encounter order
  std::vector<int32_t> remap(static_cast<size_t>(next), 0);
  int32_t count = 0;
  for (size_t i = 0; i < n; ++i) {
    int32_t p = prov[i];
    if (p < 0) { out[i] = 0; continue; }
    int32_t root = uf.find(p);
    if (remap[root] == 0) remap[root] = ++count;
    out[i] = remap[root];
  }
  return count;
}

// Per-label stats over an int32 label image with labels 1..n_labels.
// areas: n_labels int64; bboxes: n_labels x 4 int32 (min_r, min_c, max_r,
// max_c; half-open); centroids: n_labels x 2 double (row, col).
void plumekit_region_stats(const int32_t* labels, int32_t h, int32_t w,
                           int32_t n_labels, int64_t* areas, int32_t* bboxes,
                           double* centroids) {
  for (int32_t i = 0; i < n_labels; ++i) {
    areas[i] = 0;
    bboxes[i * 4 + 0] = h; bboxes[i * 4 + 1] = w;
    bboxes[i * 4 + 2] = 0; bboxes[i * 4 + 3] = 0;
    centroids[i * 2] = 0.0; centroids[i * 2 + 1] = 0.0;
  }
  for (int32_t r = 0; r < h; ++r) {
    const int32_t* row = labels + static_cast<size_t>(r) * w;
    for (int32_t c = 0; c < w; ++c) {
      int32_t l = row[c];
      if (l <= 0 || l > n_labels) continue;
      int32_t i = l - 1;
      areas[i] += 1;
      if (r < bboxes[i * 4 + 0]) bboxes[i * 4 + 0] = r;
      if (c < bboxes[i * 4 + 1]) bboxes[i * 4 + 1] = c;
      if (r + 1 > bboxes[i * 4 + 2]) bboxes[i * 4 + 2] = r + 1;
      if (c + 1 > bboxes[i * 4 + 3]) bboxes[i * 4 + 3] = c + 1;
      centroids[i * 2] += r;
      centroids[i * 2 + 1] += c;
    }
  }
  for (int32_t i = 0; i < n_labels; ++i) {
    if (areas[i]) {
      centroids[i * 2] /= static_cast<double>(areas[i]);
      centroids[i * 2 + 1] /= static_cast<double>(areas[i]);
    }
  }
}

// Component sizes addressed by label value (size n_labels+1, slot 0 counts
// background) — mirrors plumekit_torch.ops.ccl.component_sizes.
void plumekit_component_sizes(const int32_t* labels, int64_t n,
                              int32_t n_labels, int64_t* sizes) {
  std::memset(sizes, 0, sizeof(int64_t) * (static_cast<size_t>(n_labels) + 1));
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = labels[i];
    if (l >= 0 && l <= n_labels) sizes[l] += 1;
  }
}

}  // extern "C"
