// Batched navigation graph / pose engine (C ABI).
//
// Native replacement for the reference's MatterSim C++ simulator used by the
// speaker path (ss_baselines/savi/dialog/speaker/src/lib/MatterSim.cpp:
// newEpisode/makeAction/getState viewpoint-graph state machine, rendering
// disabled — speaker/tasks/R2R/env.py:247-254) and for the host side of the
// SoundSpaces graph logic (soundspaces/simulator.py:476-592): batched
// episodes over cardinal-grid navigation graphs with BFS all-pairs
// distances, oracle paths and oracle actions.
//
// Exposed as a flat C ABI consumed from Python via ctypes
// (avlen_tpu_torch/native/graph_engine.py). No GL, no globals, thread-safe per
// handle. Build: see avlen_tpu_torch/native/build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>

namespace {

constexpr int32_t kUnreachable = 1 << 15;

struct Scene {
  int32_t num_nodes = 0;
  std::vector<float> positions;      // (N, 3)
  std::vector<int32_t> neighbors;    // (N, 4) by direction (deg/90), -1 none
  std::vector<int32_t> hops;         // (N, N)
  std::vector<int32_t> oracle_next;  // (N, N), -1 at goal/unreachable
};

// Arbitrary viewpoint graph (MatterSim connectivity-graph equivalent,
// speaker/src/lib/MatterSim.cpp newEpisode/makeAction/getState over
// connectivity/*_connectivity.json neighbor lists): nodes at free 3-D
// positions, CSR neighbor lists, continuous heading. This is the shape a
// real R2R connectivity graph loads into (non-grid, arbitrary degree).
struct VpScene {
  int32_t num_nodes = 0;
  std::vector<float> positions;      // (N, 3)
  std::vector<int32_t> off, adj;     // CSR adjacency, neighbors ascending
  std::vector<int32_t> hops;         // (N, N)
  std::vector<int32_t> oracle_next;  // (N, N), -1 at goal/unreachable
};

struct Engine {
  std::vector<Scene> scenes;
  // batched episode state
  std::vector<int32_t> scene_id, node, rot;
  // viewpoint-graph scenes + batched episode state (node + float heading)
  std::vector<VpScene> vp_scenes;
  std::vector<int32_t> vp_scene_id, vp_node;
  std::vector<float> vp_heading;  // degrees, atan2(dz, dx) convention
};

int direction_of(const float* p1, const float* p2) {
  // reference convention (simulator.py:503-507): angle of (dz, dx) in deg
  double deg = std::atan2(p2[2] - p1[2], p2[0] - p1[0]) * 180.0 / M_PI;
  int d = static_cast<int>(std::lround(deg)) % 360;
  return d < 0 ? d + 360 : d;
}

void build_scene(Scene& s) {
  const int n = s.num_nodes;
  s.hops.assign(static_cast<size_t>(n) * n, kUnreachable);
  s.oracle_next.assign(static_cast<size_t>(n) * n, -1);

  // BFS from every source over the cardinal adjacency
  std::vector<int32_t> dist(n);
  for (int src = 0; src < n; ++src) {
    std::fill(dist.begin(), dist.end(), kUnreachable);
    dist[src] = 0;
    std::queue<int> q;
    q.push(src);
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (int d = 0; d < 4; ++d) {
        int v = s.neighbors[u * 4 + d];
        if (v >= 0 && dist[v] == kUnreachable) {
          dist[v] = dist[u] + 1;
          q.push(v);
        }
      }
    }
    for (int v = 0; v < n; ++v) s.hops[static_cast<size_t>(src) * n + v] = dist[v];
  }
  // greedy next hop toward each goal (first cardinal direction wins ties,
  // matching the python tables in avlen_tpu_torch/sim/graph.py)
  for (int u = 0; u < n; ++u) {
    for (int g = 0; g < n; ++g) {
      int32_t h = s.hops[static_cast<size_t>(u) * n + g];
      if (u == g || h >= kUnreachable) continue;
      int best = -1;
      int32_t best_h = kUnreachable;
      for (int d = 0; d < 4; ++d) {
        int v = s.neighbors[u * 4 + d];
        if (v < 0) continue;
        int32_t hv = s.hops[static_cast<size_t>(v) * n + g];
        if (hv < best_h) {
          best_h = hv;
          best = v;
        }
      }
      s.oracle_next[static_cast<size_t>(u) * n + g] = best;
    }
  }
}

void build_vp_scene(VpScene& s) {
  const int n = s.num_nodes;
  s.hops.assign(static_cast<size_t>(n) * n, kUnreachable);
  s.oracle_next.assign(static_cast<size_t>(n) * n, -1);
  std::vector<int32_t> dist(n);
  for (int src = 0; src < n; ++src) {
    std::fill(dist.begin(), dist.end(), kUnreachable);
    dist[src] = 0;
    std::queue<int> q;
    q.push(src);
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (int k = s.off[u]; k < s.off[u + 1]; ++k) {
        int v = s.adj[k];
        if (dist[v] == kUnreachable) {
          dist[v] = dist[u] + 1;
          q.push(v);
        }
      }
    }
    for (int v = 0; v < n; ++v) s.hops[static_cast<size_t>(src) * n + v] = dist[v];
  }
  // greedy next hop: neighbor minimizing hops-to-goal, lowest index on ties
  for (int u = 0; u < n; ++u) {
    for (int g = 0; g < n; ++g) {
      int32_t h = s.hops[static_cast<size_t>(u) * n + g];
      if (u == g || h >= kUnreachable) continue;
      int best = -1;
      int32_t best_h = kUnreachable;
      for (int k = s.off[u]; k < s.off[u + 1]; ++k) {
        int v = s.adj[k];
        int32_t hv = s.hops[static_cast<size_t>(v) * n + g];
        if (hv < best_h) {
          best_h = hv;
          best = v;
        }
      }
      s.oracle_next[static_cast<size_t>(u) * n + g] = best;
    }
  }
}

float heading_deg(const float* p1, const float* p2) {
  return static_cast<float>(std::atan2(p2[2] - p1[2], p2[0] - p1[0]) * 180.0 / M_PI);
}

float wrap_deg(float d) {
  d = std::fmod(d, 360.0f);
  if (d < 0) d += 360.0f;
  return d;
}

}  // namespace

extern "C" {

void* ge_create() { return new Engine(); }

void ge_destroy(void* h) { delete static_cast<Engine*>(h); }

// Add a scene from arrays: positions (n*3 floats), edges (m*2 ints,
// undirected, cardinal). Returns the scene index or -1 on non-cardinal edge.
int32_t ge_add_scene(void* h, int32_t n, const float* positions, int32_t m,
                     const int32_t* edges) {
  Engine* e = static_cast<Engine*>(h);
  Scene s;
  s.num_nodes = n;
  s.positions.assign(positions, positions + static_cast<size_t>(n) * 3);
  s.neighbors.assign(static_cast<size_t>(n) * 4, -1);
  for (int i = 0; i < m; ++i) {
    int a = edges[i * 2], b = edges[i * 2 + 1];
    for (int k = 0; k < 2; ++k) {
      int u = k == 0 ? a : b, v = k == 0 ? b : a;
      int d = direction_of(&s.positions[u * 3], &s.positions[v * 3]);
      if (d % 90 != 0) return -1;
      int di = d / 90;
      if (s.neighbors[u * 4 + di] == -1) s.neighbors[u * 4 + di] = v;
    }
  }
  build_scene(s);
  e->scenes.push_back(std::move(s));
  return static_cast<int32_t>(e->scenes.size()) - 1;
}

int32_t ge_num_scenes(void* h) {
  return static_cast<int32_t>(static_cast<Engine*>(h)->scenes.size());
}

// Batched episode start (MatterSim newEpisode, MatterSim.hpp:134-160).
void ge_new_episode(void* h, int32_t batch, const int32_t* scene_ids,
                    const int32_t* nodes, const int32_t* rots) {
  Engine* e = static_cast<Engine*>(h);
  e->scene_id.assign(scene_ids, scene_ids + batch);
  e->node.assign(nodes, nodes + batch);
  e->rot.assign(rots, rots + batch);
}

// Batched action step (MatterSim makeAction + SoundSpacesSim.step semantics:
// 0 STOP, 1 FORWARD via oriented neighbor, 2 LEFT +90, 3 RIGHT -90).
// out_collided gets 1 when FORWARD was blocked.
void ge_make_action(void* h, int32_t batch, const int32_t* actions,
                    uint8_t* out_collided) {
  Engine* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    out_collided[i] = 0;
    const Scene& s = e->scenes[e->scene_id[i]];
    int a = actions[i];
    if (a == 1) {
      int orient = ((3 - e->rot[i]) % 4 + 4) % 4;  // (270 - rot*90)/90
      int v = s.neighbors[e->node[i] * 4 + orient];
      if (v >= 0) {
        e->node[i] = v;
      } else {
        out_collided[i] = 1;
      }
    } else if (a == 2) {
      e->rot[i] = (e->rot[i] + 1) % 4;
    } else if (a == 3) {
      e->rot[i] = (e->rot[i] + 3) % 4;
    }
  }
}

// Batched state readback (MatterSim getState).
void ge_get_state(void* h, int32_t batch, int32_t* out_nodes,
                  int32_t* out_rots, float* out_positions) {
  Engine* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    out_nodes[i] = e->node[i];
    out_rots[i] = e->rot[i];
    const Scene& s = e->scenes[e->scene_id[i]];
    std::memcpy(out_positions + i * 3, &s.positions[e->node[i] * 3],
                3 * sizeof(float));
  }
}

int32_t ge_hops(void* h, int32_t scene, int32_t a, int32_t b) {
  const Scene& s = static_cast<Engine*>(h)->scenes[scene];
  return s.hops[static_cast<size_t>(a) * s.num_nodes + b];
}

// Shortest path a→b into out (max_len); returns the path length, -1 if b is
// unreachable, or -(len+1) if max_len was exhausted before reaching b.
int32_t ge_shortest_path(void* h, int32_t scene, int32_t a, int32_t b,
                         int32_t* out, int32_t max_len) {
  const Scene& s = static_cast<Engine*>(h)->scenes[scene];
  int len = 0;
  int cur = a;
  while (len < max_len) {
    out[len++] = cur;
    if (cur == b) return len;
    cur = s.oracle_next[static_cast<size_t>(cur) * s.num_nodes + b];
    if (cur < 0) return -1;
  }
  // max_len exhausted before reaching b: signal truncation with -(len+1) so
  // callers can distinguish it from an unreachable goal (-1) and from a
  // complete path (positive length).
  return -(len + 1);
}

// Oracle action sequence from (node, rot) toward goal, incl. turns + STOP
// (simulator.py:758-787). Returns count written.
int32_t ge_oracle_actions(void* h, int32_t scene, int32_t node, int32_t rot,
                          int32_t goal, int32_t* out, int32_t max_len) {
  const Scene& s = static_cast<Engine*>(h)->scenes[scene];
  int orient = (270 - rot * 90) % 360;
  if (orient < 0) orient += 360;
  int count = 0;
  int cur = node;
  while (cur != goal && count + 4 < max_len) {
    int nxt = s.oracle_next[static_cast<size_t>(cur) * s.num_nodes + goal];
    if (nxt < 0) break;
    int d = direction_of(&s.positions[cur * 3], &s.positions[nxt * 3]);
    int delta = ((d - orient) % 360 + 360) % 360;
    if (delta == 270) {
      out[count++] = 2;  // LEFT
    } else if (delta == 90) {
      out[count++] = 3;  // RIGHT
    } else if (delta == 180) {
      out[count++] = 3;
      out[count++] = 3;
    }
    orient = d;
    out[count++] = 1;  // FORWARD
    cur = nxt;
  }
  if (count < max_len) out[count++] = 0;  // STOP
  return count;
}

// ---- arbitrary viewpoint graphs (MatterSim connectivity-graph parity) ----

// Add a viewpoint-graph scene: positions (n*3), undirected edges (m*2), any
// geometry/degree. Returns the vp-scene index (separate id space from grid
// scenes). Duplicate edges and self-loops are ignored.
int32_t ge_add_scene_vp(void* h, int32_t n, const float* positions, int32_t m,
                        const int32_t* edges) {
  Engine* e = static_cast<Engine*>(h);
  VpScene s;
  s.num_nodes = n;
  s.positions.assign(positions, positions + static_cast<size_t>(n) * 3);
  std::vector<std::vector<int32_t>> nbrs(n);
  for (int i = 0; i < m; ++i) {
    int a = edges[i * 2], b = edges[i * 2 + 1];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    nbrs[a].push_back(b);
    nbrs[b].push_back(a);
  }
  s.off.assign(n + 1, 0);
  for (int u = 0; u < n; ++u) {
    std::sort(nbrs[u].begin(), nbrs[u].end());
    nbrs[u].erase(std::unique(nbrs[u].begin(), nbrs[u].end()), nbrs[u].end());
    s.off[u + 1] = s.off[u] + static_cast<int32_t>(nbrs[u].size());
  }
  s.adj.reserve(s.off[n]);
  for (int u = 0; u < n; ++u) s.adj.insert(s.adj.end(), nbrs[u].begin(), nbrs[u].end());
  build_vp_scene(s);
  e->vp_scenes.push_back(std::move(s));
  return static_cast<int32_t>(e->vp_scenes.size()) - 1;
}

// Batched episode start (MatterSim newEpisode with continuous heading).
void ge_vp_new_episode(void* h, int32_t batch, const int32_t* scene_ids,
                       const int32_t* nodes, const float* headings) {
  Engine* e = static_cast<Engine*>(h);
  e->vp_scene_id.assign(scene_ids, scene_ids + batch);
  e->vp_node.assign(nodes, nodes + batch);
  e->vp_heading.assign(headings, headings + batch);
}

// Navigable locations for batch slot i (MatterSim getState().
// navigableLocations): entry 0 is the current viewpoint, then neighbors
// sorted by |relative heading| to the agent's view direction (ties by node
// index). out_rel_headings in (-180, 180]. Returns count written.
int32_t ge_vp_navigable(void* h, int32_t i, int32_t* out_nodes,
                        float* out_rel_headings, int32_t max_len) {
  Engine* e = static_cast<Engine*>(h);
  const VpScene& s = e->vp_scenes[e->vp_scene_id[i]];
  int u = e->vp_node[i];
  float hd = e->vp_heading[i];
  struct Cand { int32_t v; float rel; };
  std::vector<Cand> cands;
  for (int k = s.off[u]; k < s.off[u + 1]; ++k) {
    int v = s.adj[k];
    float rel = wrap_deg(heading_deg(&s.positions[u * 3], &s.positions[v * 3]) - hd);
    if (rel > 180.0f) rel -= 360.0f;
    cands.push_back({v, rel});
  }
  std::sort(cands.begin(), cands.end(), [](const Cand& a, const Cand& b) {
    float fa = std::fabs(a.rel), fb = std::fabs(b.rel);
    return fa != fb ? fa < fb : a.v < b.v;
  });
  int count = 0;
  if (count < max_len) {
    out_nodes[count] = u;
    out_rel_headings[count] = 0.0f;
    ++count;
  }
  for (const Cand& c : cands) {
    if (count >= max_len) break;
    out_nodes[count] = c.v;
    out_rel_headings[count] = c.rel;
    ++count;
  }
  return count;
}

// Batched action (MatterSim makeAction(index, heading_delta, ...)): first
// turn by heading_delta degrees, then move to navigable index loc_idx under
// the NEW heading (0 = stay). Moving to index j>0 snaps the heading to face
// the traversed edge, as the R2R env does after teleporting. Invalid indices
// set out_invalid and stay put.
void ge_vp_make_action(void* h, int32_t batch, const int32_t* loc_idx,
                       const float* heading_delta, uint8_t* out_invalid) {
  Engine* e = static_cast<Engine*>(h);
  std::vector<int32_t> nodes(64);
  std::vector<float> rels(64);
  for (int i = 0; i < batch; ++i) {
    out_invalid[i] = 0;
    e->vp_heading[i] = wrap_deg(e->vp_heading[i] + heading_delta[i]);
    int idx = loc_idx[i];
    if (idx == 0) continue;
    const VpScene& s = e->vp_scenes[e->vp_scene_id[i]];
    int deg = s.off[e->vp_node[i] + 1] - s.off[e->vp_node[i]];
    if (static_cast<int>(nodes.size()) < deg + 1) {
      nodes.resize(deg + 1);
      rels.resize(deg + 1);
    }
    int count = ge_vp_navigable(h, i, nodes.data(), rels.data(),
                                static_cast<int32_t>(nodes.size()));
    if (idx < 0 || idx >= count) {
      out_invalid[i] = 1;
      continue;
    }
    const VpScene& sc = e->vp_scenes[e->vp_scene_id[i]];
    int u = e->vp_node[i], v = nodes[idx];
    e->vp_heading[i] = wrap_deg(heading_deg(&sc.positions[u * 3], &sc.positions[v * 3]));
    e->vp_node[i] = v;
  }
}

// Batched state readback.
void ge_vp_get_state(void* h, int32_t batch, int32_t* out_nodes,
                     float* out_headings, float* out_positions) {
  Engine* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    out_nodes[i] = e->vp_node[i];
    out_headings[i] = e->vp_heading[i];
    const VpScene& s = e->vp_scenes[e->vp_scene_id[i]];
    std::memcpy(out_positions + i * 3, &s.positions[e->vp_node[i] * 3],
                3 * sizeof(float));
  }
}

int32_t ge_vp_hops(void* h, int32_t scene, int32_t a, int32_t b) {
  const VpScene& s = static_cast<Engine*>(h)->vp_scenes[scene];
  return s.hops[static_cast<size_t>(a) * s.num_nodes + b];
}

int32_t ge_vp_shortest_path(void* h, int32_t scene, int32_t a, int32_t b,
                            int32_t* out, int32_t max_len) {
  const VpScene& s = static_cast<Engine*>(h)->vp_scenes[scene];
  int len = 0;
  int cur = a;
  while (len < max_len) {
    out[len++] = cur;
    if (cur == b) return len;
    cur = s.oracle_next[static_cast<size_t>(cur) * s.num_nodes + b];
    if (cur < 0) return -1;
  }
  // max_len exhausted before reaching b: signal truncation with -(len+1) so
  // callers can distinguish it from an unreachable goal (-1) and from a
  // complete path (positive length).
  return -(len + 1);
}

}  // extern "C"
