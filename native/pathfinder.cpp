// Native greedy contraction-order search.
//
// C++ implementation of the exhaustive greedy pair scan (the reference's
// Pathfinder::findGreedyPath, rocquantum/src/hipTensorNet/Pathfinder.cpp:
// 174-269): at every step, scan all tensor pairs, compute the FLOP cost of
// contracting that pair (accounting for hyperedge labels still used by other
// tensors), and contract the cheapest pair. O(k^3) scans over the shrinking
// tensor list are pure host combinatorics — the natural native-code component
// of the JAX rebuild (device work is XLA's job).
//
// Cost rule (must stay bit-identical to the Python fallback in
// rocquantum_tpu/tensornet/pathfinder.py): flops = 8 * out_size * k where
// k = product of contracted dims; tie-break on (flops, out_size, i, j).
//
// Exposed with a minimal C ABI for ctypes: the caller passes label ids and
// dims; only the chosen (i, j) pair sequence is returned — the Python side
// replays it to recover output labels and statistics.

#include <cstddef>
#include <cstdint>
#include <map>
#include <set>
#include <vector>

using std::size_t;

namespace {

struct Entry {
  std::vector<int> labels;
  std::vector<int64_t> dims;
};

}  // namespace

extern "C" int rocq_greedy_path(int n_tensors, const int* ranks,
                                const int* labels_flat,
                                const int64_t* dims_flat, int* out_pairs) {
  if (n_tensors <= 0) return -1;
  std::vector<Entry> current;
  current.reserve(n_tensors);
  {
    int off = 0;
    for (int t = 0; t < n_tensors; ++t) {
      Entry e;
      e.labels.assign(labels_flat + off, labels_flat + off + ranks[t]);
      e.dims.assign(dims_flat + off, dims_flat + off + ranks[t]);
      off += ranks[t];
      current.push_back(std::move(e));
    }
  }

  int step_idx = 0;
  while (current.size() > 1) {
    double best_flops = -1.0;
    int64_t best_out = 0;
    int best_i = -1, best_j = -1;

    const int k = static_cast<int>(current.size());
    for (int i = 0; i < k; ++i) {
      for (int j = i + 1; j < k; ++j) {
        // external label counts (labels used by tensors other than i, j)
        std::map<int, int> external;
        for (int t = 0; t < k; ++t) {
          if (t == i || t == j) continue;
          for (int l : current[t].labels) external[l]++;
        }
        std::map<int, int64_t> dims;
        for (size_t a = 0; a < current[i].labels.size(); ++a)
          dims[current[i].labels[a]] = current[i].dims[a];
        for (size_t a = 0; a < current[j].labels.size(); ++a)
          dims[current[j].labels[a]] = current[j].dims[a];

        std::set<int> labels_b(current[j].labels.begin(),
                               current[j].labels.end());
        std::set<int> labels_a(current[i].labels.begin(),
                               current[i].labels.end());
        int64_t contracted_k = 1;
        std::set<int> contracted;
        for (int l : current[i].labels) {
          if (labels_b.count(l) && external.find(l) == external.end()) {
            contracted.insert(l);
            contracted_k *= dims[l];
          }
        }
        int64_t out_size = 1;
        for (int l : current[i].labels)
          if (!contracted.count(l)) out_size *= dims[l];
        for (int l : current[j].labels)
          if (!labels_a.count(l) && !contracted.count(l)) out_size *= dims[l];

        const double flops = 8.0 * static_cast<double>(out_size) *
                             static_cast<double>(contracted_k);
        if (best_i < 0 || flops < best_flops ||
            (flops == best_flops && out_size < best_out)) {
          best_flops = flops;
          best_out = out_size;
          best_i = i;
          best_j = j;
        }
      }
    }

    out_pairs[2 * step_idx] = best_i;
    out_pairs[2 * step_idx + 1] = best_j;
    ++step_idx;

    // build merged entry (same order rule as the Python fallback)
    std::map<int, int> external;
    for (int t = 0; t < k; ++t) {
      if (t == best_i || t == best_j) continue;
      for (int l : current[t].labels) external[l]++;
    }
    std::map<int, int64_t> dims;
    for (size_t a = 0; a < current[best_i].labels.size(); ++a)
      dims[current[best_i].labels[a]] = current[best_i].dims[a];
    for (size_t a = 0; a < current[best_j].labels.size(); ++a)
      dims[current[best_j].labels[a]] = current[best_j].dims[a];
    std::set<int> labels_a(current[best_i].labels.begin(),
                           current[best_i].labels.end());
    std::set<int> labels_b(current[best_j].labels.begin(),
                           current[best_j].labels.end());
    std::set<int> contracted;
    for (int l : current[best_i].labels)
      if (labels_b.count(l) && external.find(l) == external.end())
        contracted.insert(l);
    Entry merged;
    for (int l : current[best_i].labels)
      if (!contracted.count(l)) {
        merged.labels.push_back(l);
        merged.dims.push_back(dims[l]);
      }
    for (int l : current[best_j].labels)
      if (!labels_a.count(l) && !contracted.count(l)) {
        merged.labels.push_back(l);
        merged.dims.push_back(dims[l]);
      }

    std::vector<Entry> next;
    next.reserve(current.size() - 1);
    for (int t = 0; t < k; ++t)
      if (t != best_i && t != best_j) next.push_back(std::move(current[t]));
    next.push_back(std::move(merged));
    current = std::move(next);
  }
  return step_idx;
}
