// savtpu_torch native host code: k-way graph partitioning and
// localization. A copy of savtpu/native/sav_native.cpp, built for the port
// on its own:
//
//   sav_partition_refine : Fiduccia-Mattheyses boundary refinement of a
//                          caller's k-way partition (the graph method's
//                          refiner, parallel/partition.py);
//   sav_partition_graph  : balanced k-way partition of a CSR graph: BFS
//                          greedy growing from spread seeds, balance
//                          sweeps, then the same refinement passes;
//   sav_first_touch      : first-appearance dedup of a node-id stream (the
//                          O(N^2) list scan of the reference's
//                          rankwise_dist, Tools/Distributed_tools.py:14-24,
//                          in O(N)).
//
// Stands in for the reference's setup-time native dependency (ParMETIS
// via mgmetis). Runs once on the host at setup; the element->part map it
// returns becomes the static index tensors of the stepper.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 sav_native.cpp -o libsavnative.so
// (savtpu_torch/native/__init__.py does it at first use)

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

int64_t sav_first_touch(const int64_t* flat, int64_t count,
                        int64_t n_global, int64_t* out) {
  std::vector<uint8_t> seen(static_cast<size_t>(n_global), 0);
  int64_t m = 0;
  for (int64_t i = 0; i < count; ++i) {
    int64_t v = flat[i];
    if (v < 0 || v >= n_global) return -1;
    if (!seen[static_cast<size_t>(v)]) {
      seen[static_cast<size_t>(v)] = 1;
      out[m++] = v;
    }
  }
  return m;
}

namespace {

// one refinement sweep: move boundary vertices to the neighbor part with
// maximal edge-cut gain, respecting a +-tol balance envelope.
int64_t refine_pass(const int64_t* xadj, const int64_t* adjncy, int64_t n,
                    int64_t nparts, std::vector<int64_t>& part,
                    std::vector<int64_t>& sizes, int64_t max_size) {
  int64_t moved = 0;
  std::vector<int64_t> cnt(static_cast<size_t>(nparts), 0);
  for (int64_t v = 0; v < n; ++v) {
    int64_t pv = part[static_cast<size_t>(v)];
    if (sizes[static_cast<size_t>(pv)] <= 1) continue;
    // count neighbor parts
    bool boundary = false;
    for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e) {
      int64_t pu = part[static_cast<size_t>(adjncy[e])];
      cnt[static_cast<size_t>(pu)]++;
      if (pu != pv) boundary = true;
    }
    if (boundary) {
      int64_t best = pv;
      int64_t best_gain = 0;
      for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e) {
        int64_t pu = part[static_cast<size_t>(adjncy[e])];
        if (pu == pv) continue;
        int64_t gain = cnt[static_cast<size_t>(pu)] -
                       cnt[static_cast<size_t>(pv)];
        if (gain > best_gain && sizes[static_cast<size_t>(pu)] < max_size) {
          best_gain = gain;
          best = pu;
        }
      }
      if (best != pv) {
        part[static_cast<size_t>(v)] = best;
        sizes[static_cast<size_t>(pv)]--;
        sizes[static_cast<size_t>(best)]++;
        ++moved;
      }
    }
    // reset counters touched
    for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e)
      cnt[static_cast<size_t>(part[static_cast<size_t>(adjncy[e])])] = 0;
    cnt[static_cast<size_t>(pv)] = 0;
    cnt[static_cast<size_t>(part[static_cast<size_t>(v)])] = 0;
  }
  return moved;
}

}  // namespace

// Refine a caller-supplied partition in place: balance sweeps + FM gain
// moves. Lets Python seed with a geometric partition (RCB) so the graph
// method is never worse than its seed — the METIS recipe of a good
// initial partition + Fiduccia-Mattheyses boundary refinement.
int sav_partition_refine(const int64_t* xadj, const int64_t* adjncy,
                         int64_t n, int64_t nparts, int64_t refine_passes,
                         int64_t* epart_inout) {
  if (n <= 0 || nparts <= 0) return 1;
  std::vector<int64_t> part(epart_inout, epart_inout + n);
  std::vector<int64_t> sizes(static_cast<size_t>(nparts), 0);
  for (int64_t v = 0; v < n; ++v) {
    int64_t p = part[static_cast<size_t>(v)];
    if (p < 0 || p >= nparts) return 2;
    sizes[static_cast<size_t>(p)]++;
  }
  int64_t max_size = (n + nparts - 1) / nparts + 1;
  for (int64_t pass = 0; pass < refine_passes; ++pass) {
    if (refine_pass(xadj, adjncy, n, nparts, part, sizes, max_size) == 0)
      break;
  }
  std::memcpy(epart_inout, part.data(), sizeof(int64_t) * part.size());
  return 0;
}

int sav_partition_graph(const int64_t* xadj, const int64_t* adjncy,
                        int64_t n, int64_t nparts, int64_t refine_passes,
                        int64_t* epart_out) {
  if (n <= 0 || nparts <= 0) return 1;
  std::vector<int64_t> part(static_cast<size_t>(n), -1);
  std::vector<int64_t> sizes(static_cast<size_t>(nparts), 0);

  // BFS greedy growing: grow each part to its target from the first
  // unassigned vertex (vertex order acts as the spread heuristic; callers
  // pass geometrically sorted ids when available).
  int64_t next_seed = 0;
  for (int64_t p = 0; p < nparts; ++p) {
    int64_t target = n / nparts + (p < n % nparts ? 1 : 0);
    while (next_seed < n && part[static_cast<size_t>(next_seed)] != -1)
      ++next_seed;
    if (next_seed >= n) break;
    std::queue<int64_t> q;
    q.push(next_seed);
    while (!q.empty() && sizes[static_cast<size_t>(p)] < target) {
      int64_t v = q.front();
      q.pop();
      if (part[static_cast<size_t>(v)] != -1) continue;
      part[static_cast<size_t>(v)] = p;
      sizes[static_cast<size_t>(p)]++;
      for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e) {
        int64_t u = adjncy[e];
        if (part[static_cast<size_t>(u)] == -1) q.push(u);
      }
    }
  }
  // leftovers (disconnected or exhausted queues): attach to an assigned
  // neighbor if possible, else the smallest part.
  for (int64_t v = 0; v < n; ++v) {
    if (part[static_cast<size_t>(v)] != -1) continue;
    int64_t chosen = -1;
    for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e) {
      int64_t pu = part[static_cast<size_t>(adjncy[e])];
      if (pu != -1) {
        chosen = pu;
        break;
      }
    }
    if (chosen == -1) {
      chosen = 0;
      for (int64_t p = 1; p < nparts; ++p)
        if (sizes[static_cast<size_t>(p)] <
            sizes[static_cast<size_t>(chosen)])
          chosen = p;
    }
    part[static_cast<size_t>(v)] = chosen;
    sizes[static_cast<size_t>(chosen)]++;
  }

  int64_t max_size = (n + nparts - 1) / nparts + 1;

  // balance sweeps: shed boundary vertices of oversized parts to adjacent
  // under-capacity parts (greedy growing + leftover attachment can leave
  // imbalance that pure gain-moves never repair)
  for (int64_t sweep = 0; sweep < 4 * nparts; ++sweep) {
    bool oversized = false;
    for (int64_t p = 0; p < nparts; ++p)
      if (sizes[static_cast<size_t>(p)] > max_size) oversized = true;
    if (!oversized) break;
    int64_t moved = 0;
    for (int64_t v = 0; v < n; ++v) {
      int64_t pv = part[static_cast<size_t>(v)];
      if (sizes[static_cast<size_t>(pv)] <= max_size) continue;
      for (int64_t e = xadj[v]; e < xadj[v + 1]; ++e) {
        int64_t pu = part[static_cast<size_t>(adjncy[e])];
        if (pu != pv && sizes[static_cast<size_t>(pu)] < max_size) {
          part[static_cast<size_t>(v)] = pu;
          sizes[static_cast<size_t>(pv)]--;
          sizes[static_cast<size_t>(pu)]++;
          ++moved;
          break;
        }
      }
    }
    if (moved == 0) break;
  }

  for (int64_t pass = 0; pass < refine_passes; ++pass) {
    if (refine_pass(xadj, adjncy, n, nparts, part, sizes, max_size) == 0)
      break;
  }
  std::memcpy(epart_out, part.data(), sizeof(int64_t) * part.size());
  return 0;
}

}  // extern "C"
