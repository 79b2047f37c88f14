// navsim: native core for the render-off navigation simulator.
//
// Counterpart of the reference's single native dependency,
// the external MatterSim C++ library (SURVEY §2.2). In every training /
// eval path the reference runs MatterSim with rendering disabled
// (finetune_src/r2r/env.py:44), reducing it to a graph walker +
// discretized-camera state machine. This library provides:
//
//  1. graph precomputation: all-pairs shortest paths (blocked
//     Floyd–Warshall) + successor matrix + neighbor geometry with
//     closest-view discretization — the startup cost the reference
//     pays in networkx dict-of-dict Dijkstra (env.py:131-147);
//  2. batched episode state (new_episode / move / state queries);
//  3. an equirectangular->perspective panorama sampler covering the
//     reference's only rendering use (36-view extraction for
//     preprocessing, preprocess/precompute_img_features_vit.py:84-93).
//
// Exposed as a C ABI for ctypes. Built with g++ at first use by
// vln_hamt_torch/native/navsim.py:build_library into vln_hamt_torch/build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kPi = 3.14159265358979323846;
constexpr double kDeg30 = kPi / 6.0;

struct Graph {
  int n = 0;
  int max_degree = 0;
  std::vector<double> pos;       // (n, 3)
  std::vector<uint8_t> adj;      // (n, n)
  std::vector<float> dist;       // (n, n)
  std::vector<int32_t> next_hop; // (n, n)
  // padded neighbor tables, width = max_degree
  std::vector<int32_t> nbr_index;
  std::vector<float> nbr_heading;
  std::vector<float> nbr_elevation;
  std::vector<int32_t> nbr_point_id;
};

int closest_view(double heading, double elevation) {
  long h = std::lround(heading / kDeg30) % 12;
  if (h < 0) h += 12;
  long e = std::lround(elevation / kDeg30);
  if (e < -1) e = -1;
  if (e > 1) e = 1;
  return static_cast<int>((e + 1) * 12 + h);
}

void build_graph(Graph &g) {
  const int n = g.n;
  std::vector<double> d(static_cast<size_t>(n) * n, kInf);
  g.next_hop.assign(static_cast<size_t>(n) * n, -1);

  for (int i = 0; i < n; ++i) {
    d[static_cast<size_t>(i) * n + i] = 0.0;
    g.next_hop[static_cast<size_t>(i) * n + i] = i;
  }
  int max_deg = 0;
  for (int i = 0; i < n; ++i) {
    int deg = 0;
    for (int j = 0; j < n; ++j) {
      if (!g.adj[static_cast<size_t>(i) * n + j]) continue;
      double dx = g.pos[3 * i] - g.pos[3 * j];
      double dy = g.pos[3 * i + 1] - g.pos[3 * j + 1];
      double dz = g.pos[3 * i + 2] - g.pos[3 * j + 2];
      d[static_cast<size_t>(i) * n + j] = std::sqrt(dx * dx + dy * dy + dz * dz);
      g.next_hop[static_cast<size_t>(i) * n + j] = j;
      ++deg;
    }
    if (deg > max_deg) max_deg = deg;
  }
  // Floyd–Warshall; row-major inner loop keeps it cache-friendly.
  for (int k = 0; k < n; ++k) {
    const double *dk = &d[static_cast<size_t>(k) * n];
    for (int i = 0; i < n; ++i) {
      double dik = d[static_cast<size_t>(i) * n + k];
      if (dik == kInf) continue;
      double *di = &d[static_cast<size_t>(i) * n];
      int32_t hop_ik = g.next_hop[static_cast<size_t>(i) * n + k];
      for (int j = 0; j < n; ++j) {
        double via = dik + dk[j];
        if (via < di[j]) {
          di[j] = via;
          g.next_hop[static_cast<size_t>(i) * n + j] = hop_ik;
        }
      }
    }
  }
  g.dist.resize(d.size());
  for (size_t i = 0; i < d.size(); ++i) g.dist[i] = static_cast<float>(d[i]);

  g.max_degree = max_deg;
  g.nbr_index.assign(static_cast<size_t>(n) * max_deg, -1);
  g.nbr_heading.assign(static_cast<size_t>(n) * max_deg, 0.f);
  g.nbr_elevation.assign(static_cast<size_t>(n) * max_deg, 0.f);
  g.nbr_point_id.assign(static_cast<size_t>(n) * max_deg, -1);
  for (int i = 0; i < n; ++i) {
    int slot = 0;
    for (int j = 0; j < n; ++j) {
      if (!g.adj[static_cast<size_t>(i) * n + j]) continue;
      double dx = g.pos[3 * j] - g.pos[3 * i];
      double dy = g.pos[3 * j + 1] - g.pos[3 * i + 1];
      double dz = g.pos[3 * j + 2] - g.pos[3 * i + 2];
      double heading = std::atan2(dx, dy);
      double elevation = std::atan2(dz, std::sqrt(dx * dx + dy * dy));
      size_t at = static_cast<size_t>(i) * max_deg + slot;
      g.nbr_index[at] = j;
      g.nbr_heading[at] = static_cast<float>(heading);
      g.nbr_elevation[at] = static_cast<float>(elevation);
      g.nbr_point_id[at] = closest_view(heading, elevation);
      ++slot;
    }
  }
}

struct SimBatch {
  std::vector<const Graph *> graphs;
  std::vector<int32_t> node;
  std::vector<int32_t> view;
};

}  // namespace

extern "C" {

// ------------------------------------------------------------ graphs
void *navsim_graph_create(int n, const double *positions,
                          const uint8_t *adjacency) {
  auto *g = new Graph();
  g->n = n;
  g->pos.assign(positions, positions + static_cast<size_t>(n) * 3);
  g->adj.assign(adjacency, adjacency + static_cast<size_t>(n) * n);
  build_graph(*g);
  return g;
}

void navsim_graph_destroy(void *h) { delete static_cast<Graph *>(h); }

int navsim_graph_max_degree(void *h) {
  return static_cast<Graph *>(h)->max_degree;
}

void navsim_graph_dist(void *h, float *out) {
  auto *g = static_cast<Graph *>(h);
  std::memcpy(out, g->dist.data(), g->dist.size() * sizeof(float));
}

void navsim_graph_next_hop(void *h, int32_t *out) {
  auto *g = static_cast<Graph *>(h);
  std::memcpy(out, g->next_hop.data(), g->next_hop.size() * sizeof(int32_t));
}

void navsim_graph_neighbors(void *h, int32_t *index, float *heading,
                            float *elevation, int32_t *point_id) {
  auto *g = static_cast<Graph *>(h);
  size_t sz = g->nbr_index.size();
  std::memcpy(index, g->nbr_index.data(), sz * sizeof(int32_t));
  std::memcpy(heading, g->nbr_heading.data(), sz * sizeof(float));
  std::memcpy(elevation, g->nbr_elevation.data(), sz * sizeof(float));
  std::memcpy(point_id, g->nbr_point_id.data(), sz * sizeof(int32_t));
}

// ----------------------------------------------------------- batches
void *navsim_batch_create(int batch_size) {
  auto *b = new SimBatch();
  b->graphs.assign(batch_size, nullptr);
  b->node.assign(batch_size, 0);
  b->view.assign(batch_size, 0);
  return b;
}

void navsim_batch_destroy(void *h) { delete static_cast<SimBatch *>(h); }

void navsim_new_episode(void *h, int slot, void *graph, int node,
                        double heading, double elevation) {
  auto *b = static_cast<SimBatch *>(h);
  b->graphs[slot] = static_cast<Graph *>(graph);
  b->node[slot] = node;
  b->view[slot] = closest_view(heading, elevation);
}

// Direct transition to an adjacent node + representative view; the pose
// equals MatterSim's after the reference's emulated rotate+forward
// sequence (agent_cmt.py:213-246). Returns 0 on success, -1 if the
// target is not adjacent.
int navsim_move(void *h, int slot, int target_node, int target_view) {
  auto *b = static_cast<SimBatch *>(h);
  const Graph *g = b->graphs[slot];
  if (!g->adj[static_cast<size_t>(b->node[slot]) * g->n + target_node])
    return -1;
  b->node[slot] = target_node;
  b->view[slot] = target_view;
  return 0;
}

void navsim_state(void *h, int slot, int32_t *node, int32_t *view) {
  auto *b = static_cast<SimBatch *>(h);
  *node = b->node[slot];
  *view = b->view[slot];
}

// ------------------------------------------------ panorama sampling
// Sample one perspective view (w x h, vertical FOV vfov radians) at
// (heading, elevation) from an equirectangular image (eq_w x eq_h,
// 3 channels, uint8). Bilinear filtering. Covers the reference's only
// rendering need: 36-view extraction for feature precomputation.
void navsim_sample_view(const uint8_t *equirect, int eq_w, int eq_h,
                        double heading, double elevation, double vfov,
                        int w, int h, uint8_t *out) {
  const double focal = 0.5 * h / std::tan(0.5 * vfov);
  const double ch = std::cos(heading), sh = std::sin(heading);
  const double ce = std::cos(elevation), se = std::sin(elevation);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      // camera ray (x right, y down, z forward)
      double rx = (x + 0.5 - 0.5 * w) / focal;
      double ry = (y + 0.5 - 0.5 * h) / focal;
      double rz = 1.0;
      // pitch (elevation, positive = up) then yaw (heading, clockwise
      // from +Y = north)
      double wy = -ry * ce + rz * se;          // world up component
      double fz = rz * ce + ry * se;           // forward after pitch
      double wx = rx * ch + fz * sh;           // east
      double wfy = fz * ch - rx * sh;          // north
      double lon = std::atan2(wx, wfy);        // [-pi, pi], 0 = north
      double hyp = std::sqrt(wx * wx + wfy * wfy);
      double lat = std::atan2(wy, hyp);        // [-pi/2, pi/2]
      double u = (lon / (2 * kPi) + 0.5) * eq_w - 0.5;
      double v = (0.5 - lat / kPi) * eq_h - 0.5;
      // bilinear with horizontal wrap, vertical clamp
      int u0 = static_cast<int>(std::floor(u));
      int v0 = static_cast<int>(std::floor(v));
      double fu = u - u0, fv = v - v0;
      for (int c = 0; c < 3; ++c) {
        double acc = 0.0;
        for (int dv = 0; dv < 2; ++dv) {
          int vv = v0 + dv;
          if (vv < 0) vv = 0;
          if (vv >= eq_h) vv = eq_h - 1;
          for (int du = 0; du < 2; ++du) {
            int uu = (u0 + du) % eq_w;
            if (uu < 0) uu += eq_w;
            double wgt = (du ? fu : 1 - fu) * (dv ? fv : 1 - fv);
            acc += wgt *
                   equirect[(static_cast<size_t>(vv) * eq_w + uu) * 3 + c];
          }
        }
        out[(static_cast<size_t>(y) * w + x) * 3 + c] =
            static_cast<uint8_t>(acc + 0.5);
      }
    }
  }
}

// All 36 discretized views in one call (12 headings x 3 elevations,
// viewIndex = elevation_level * 12 + heading_index).
void navsim_sample_panorama(const uint8_t *equirect, int eq_w, int eq_h,
                            double vfov, int w, int h, uint8_t *out) {
  for (int ix = 0; ix < 36; ++ix) {
    double heading = (ix % 12) * kDeg30;
    double elevation = (ix / 12 - 1) * kDeg30;
    navsim_sample_view(equirect, eq_w, eq_h, heading, elevation, vfov, w, h,
                       out + static_cast<size_t>(ix) * w * h * 3);
  }
}

}  // extern "C"
