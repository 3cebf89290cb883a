// Native runtime components for fem_glass_tempering_tpu.
//
// The reference delegates its mesh/topology machinery to the dolfinx C++
// core (SURVEY.md §2b). The TPU build keeps compute in XLA, but the
// setup-time runtime pieces that dolfinx does natively are implemented
// natively here too:
//   * facet-connectivity construction (boundary/interior facet extraction
//     with '+'-side normalization) — the hot O(n_cells * n_facets) step of
//     mesh setup, here by bucketing on each facet's smallest vertex,
//   * a gmsh 4.1 ASCII parser (nodes + highest-dimension cells),
//   * a greedy contiguous-BFS cell partitioner over the facet adjacency.
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py); every
// entry point has a numpy fallback that produces bit-identical output.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct FacetResult {
  int32_t* boundary;    // (n_boundary, 2): cell, local_facet
  int64_t n_boundary;
  int32_t* interior;    // (n_interior, 4): cell_p, lf_p, cell_m, lf_m
  int64_t n_interior;
  int32_t status;       // 0 ok, 1 = facet with >2 incident cells
};

// Facets by bucketing: every (cell, local facet) pair gets the sorted
// vertex list of its facet, and a counting sort on the smallest vertex
// puts the pairs that share a facet into one bucket of a few pairs. Pair
// ids p = cell * n_local_facets + lf ascend inside a bucket, so the first
// member of a match is the '+' side, and one pass over p in order writes
// both lists already sorted by (cell, local facet). O(n) with no hashing.
FacetResult* build_facets(const int32_t* cells, int64_t n_cells,
                          int32_t nv_cell, const int32_t* facet_def,
                          int32_t n_local_facets, int32_t nv_facet) {
  auto* res = new FacetResult();
  res->status = 0;
  const int64_t n_pairs = n_cells * n_local_facets;
  std::vector<int32_t> keys(static_cast<size_t>(n_pairs) * nv_facet);
  int32_t n_verts = 0;
  for (int64_t c = 0; c < n_cells; ++c) {
    const int32_t* cv = cells + c * nv_cell;
    for (int32_t lf = 0; lf < n_local_facets; ++lf) {
      const int32_t* fd = facet_def + static_cast<int64_t>(lf) * nv_facet;
      int32_t* k = keys.data() + (c * n_local_facets + lf) * nv_facet;
      for (int32_t j = 0; j < nv_facet; ++j) k[j] = cv[fd[j]];
      std::sort(k, k + nv_facet);
      n_verts = std::max(n_verts, k[0] + 1);
    }
  }
  // counting sort of the pair ids on their facet's smallest vertex
  std::vector<int64_t> start(static_cast<size_t>(n_verts) + 1, 0);
  for (int64_t p = 0; p < n_pairs; ++p) ++start[keys[p * nv_facet] + 1];
  for (int32_t v = 0; v < n_verts; ++v) start[v + 1] += start[v];
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  std::vector<int64_t> bucket(static_cast<size_t>(n_pairs));
  for (int64_t p = 0; p < n_pairs; ++p) bucket[cursor[keys[p * nv_facet]]++] = p;
  cursor.clear();
  cursor.shrink_to_fit();

  auto same = [&](int64_t p, int64_t q) {
    const int32_t* a = keys.data() + p * nv_facet;
    const int32_t* b = keys.data() + q * nv_facet;
    for (int32_t j = 1; j < nv_facet; ++j)
      if (a[j] != b[j]) return false;
    return true;
  };
  std::vector<int64_t> mate(static_cast<size_t>(n_pairs), -1);
  int64_t n_interior = 0;
  for (int32_t v = 0; v < n_verts; ++v) {
    for (int64_t i = start[v]; i < start[v + 1]; ++i) {
      const int64_t p = bucket[i];
      if (mate[p] >= 0) continue;  // the '-' side of an earlier match
      for (int64_t j = i + 1; j < start[v + 1]; ++j) {
        const int64_t q = bucket[j];
        if (!same(p, q)) continue;
        if (mate[p] >= 0 || mate[q] >= 0) {
          res->status = 1;  // a third pair on the same facet
          continue;
        }
        mate[p] = q;
        mate[q] = p;
        ++n_interior;
      }
    }
  }

  res->n_interior = n_interior;
  res->n_boundary = n_pairs - 2 * n_interior;
  res->boundary = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * 2 * std::max<int64_t>(res->n_boundary, 1)));
  res->interior = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * 4 * std::max<int64_t>(res->n_interior, 1)));
  int64_t ib = 0, ii = 0;
  for (int64_t p = 0; p < n_pairs; ++p) {
    const int64_t q = mate[p];
    if (q < 0) {
      res->boundary[2 * ib] = static_cast<int32_t>(p / n_local_facets);
      res->boundary[2 * ib + 1] = static_cast<int32_t>(p % n_local_facets);
      ++ib;
    } else if (q > p) {
      res->interior[4 * ii] = static_cast<int32_t>(p / n_local_facets);
      res->interior[4 * ii + 1] = static_cast<int32_t>(p % n_local_facets);
      res->interior[4 * ii + 2] = static_cast<int32_t>(q / n_local_facets);
      res->interior[4 * ii + 3] = static_cast<int32_t>(q % n_local_facets);
      ++ii;
    }
  }
  return res;
}

void free_facet_result(FacetResult* r) {
  if (!r) return;
  free(r->boundary);
  free(r->interior);
  delete r;
}

// ---------------------------------------------------------------------
// gmsh 4.1 ASCII parser: nodes + cells of the highest-dimension element
// type present. Element types: 1 line, 2 tri, 3 quad, 4 tet, 5 hex.
// ---------------------------------------------------------------------

struct MshResult {
  double* nodes;      // (n_nodes, 3)
  int64_t n_nodes;
  int32_t* cells;     // (n_cells, nv)
  int64_t n_cells;
  int32_t etype;      // gmsh element type of the cells
  int32_t status;     // 0 ok, nonzero error
};

static const int kNV[6] = {0, 2, 3, 4, 4, 8};
static const int kDim[6] = {0, 1, 2, 2, 3, 3};

MshResult* parse_msh(const char* path) {
  auto* res = new MshResult();
  memset(res, 0, sizeof(MshResult));
  FILE* f = fopen(path, "r");
  if (!f) { res->status = 2; return res; }
  char line[1 << 16];
  std::vector<double> coords;
  std::vector<int64_t> tags;
  std::unordered_map<int64_t, int64_t> tag2idx;
  // per element type storage
  std::vector<std::vector<int32_t>> cells_by_type(6);

  while (fgets(line, sizeof line, f)) {
    if (strncmp(line, "$Nodes", 6) == 0) {
      int64_t nblocks, nnodes, mn, mx;
      if (fscanf(f, "%ld %ld %ld %ld", &nblocks, &nnodes, &mn, &mx) != 4) {
        res->status = 3; fclose(f); return res;
      }
      coords.reserve(nnodes * 3);
      tags.reserve(nnodes);
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t dim, etag, param, n;
        if (fscanf(f, "%ld %ld %ld %ld", &dim, &etag, &param, &n) != 4) {
          res->status = 3; fclose(f); return res;
        }
        // parametric node blocks (param != 0) carry extra per-node
        // coordinates this parser does not read; returning status 0 would
        // hand back silently corrupted geometry — report unsupported so
        // the caller falls back to the numpy parser (which raises)
        if (param != 0) { res->status = 3; fclose(f); return res; }
        int64_t base = static_cast<int64_t>(tags.size());
        for (int64_t i = 0; i < n; ++i) {
          int64_t t; if (fscanf(f, "%ld", &t) != 1) { res->status = 3; fclose(f); return res; }
          tags.push_back(t);
          tag2idx[t] = base + i;
        }
        for (int64_t i = 0; i < n; ++i) {
          double x, y, z;
          if (fscanf(f, "%lf %lf %lf", &x, &y, &z) != 3) { res->status = 3; fclose(f); return res; }
          coords.push_back(x); coords.push_back(y); coords.push_back(z);
        }
      }
    } else if (strncmp(line, "$Elements", 9) == 0) {
      int64_t nblocks, nelems, mn, mx;
      if (fscanf(f, "%ld %ld %ld %ld", &nblocks, &nelems, &mn, &mx) != 4) {
        res->status = 4; fclose(f); return res;
      }
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t dim, etag, etype, n;
        if (fscanf(f, "%ld %ld %ld %ld", &dim, &etag, &etype, &n) != 4) {
          res->status = 4; fclose(f); return res;
        }
        for (int64_t i = 0; i < n; ++i) {
          int64_t t; if (fscanf(f, "%ld", &t) != 1) { res->status = 4; fclose(f); return res; }
          if (etype >= 1 && etype <= 5) {
            for (int k = 0; k < kNV[etype]; ++k) {
              int64_t vt; if (fscanf(f, "%ld", &vt) != 1) { res->status = 4; fclose(f); return res; }
              auto vit = tag2idx.find(vt);
              // unknown node tag: operator[] would default-insert index 0
              // and parse a malformed file 'successfully' with silently
              // wrong connectivity (the numpy fallback raises on it)
              if (vit == tag2idx.end()) { res->status = 4; fclose(f); return res; }
              cells_by_type[etype].push_back(
                  static_cast<int32_t>(vit->second));
            }
          } else {
            // consume rest of the line (unknown element node list)
            if (!fgets(line, sizeof line, f)) break;
          }
        }
      }
    }
  }
  fclose(f);

  int best = 0;
  for (int t = 1; t <= 5; ++t)
    if (!cells_by_type[t].empty() && (best == 0 || kDim[t] > kDim[best]))
      best = t;
  if (best == 0) { res->status = 5; return res; }

  res->n_nodes = static_cast<int64_t>(tags.size());
  res->nodes = static_cast<double*>(malloc(sizeof(double) * coords.size()));
  memcpy(res->nodes, coords.data(), sizeof(double) * coords.size());
  res->etype = best;
  res->n_cells = static_cast<int64_t>(cells_by_type[best].size()) / kNV[best];
  res->cells = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * cells_by_type[best].size()));
  memcpy(res->cells, cells_by_type[best].data(),
         sizeof(int32_t) * cells_by_type[best].size());
  return res;
}

void free_msh_result(MshResult* r) {
  if (!r) return;
  free(r->nodes);
  free(r->cells);
  delete r;
}

// ---------------------------------------------------------------------
// Greedy BFS partitioner over facet adjacency: grows n_parts contiguous
// blocks of (near-)equal size. Alternative to the coordinate-sort
// ---------------------------------------------------------------------
// parse_msh2: gmsh 4.1 parser WITH physical groups (cell + facet tags).
// The reference's mesh read returns (mesh, cell_tags, facet_tags)
// (dolfinx gmshio.read_from_msh, ThermoViscoProblem.py:27-28; the group
// is written at geometry.py:23-24). Entity->physical mapping comes from
// $Entities; facet elements are the (topdim-1)-dimensional elements of
// the facet shape matching the chosen cell type. Output is identical to
// the numpy fallback in fem/mesh.py read_msh.

struct MshResult2 {
  double* nodes;        // (n_nodes, 3)
  int64_t n_nodes;
  int32_t* cells;       // (n_cells, nv) gmsh vertex order
  int64_t n_cells;
  int32_t etype;        // gmsh element type of the cells
  int32_t* cell_tags;   // (n_cells,) physical tag, -1 untagged
  int32_t* facet_verts; // (n_facet_elems, facet_nv) mesh-local node ids
  int32_t* facet_tags;  // (n_facet_elems,)
  int64_t n_facet_elems;
  int32_t facet_nv;
  int32_t status;       // 0 ok
};

MshResult2* parse_msh2(const char* path) {
  auto* res = new MshResult2();
  memset(res, 0, sizeof(MshResult2));
  FILE* f = fopen(path, "r");
  if (!f) { res->status = 2; return res; }
  char line[1 << 16];
  std::vector<double> coords;
  std::vector<int64_t> tags;
  std::unordered_map<int64_t, int64_t> tag2idx;
  // supported element types: 1..5 cells + 15 (point); per-type vertex
  // counts and topological dims
  static const int nvArr[16]  = {0, 2, 3, 4, 4, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
  static const int dimArr[16] = {0, 1, 2, 2, 3, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  std::vector<std::vector<int32_t>> verts_by_type(16);
  std::vector<std::vector<int32_t>> ptags_by_type(16);
  // (dim, entityTag) -> physical tag
  std::unordered_map<int64_t, int32_t> entphys;
  auto entkey = [](int64_t dim, int64_t etag) {
    return dim * 1000000007LL + etag;
  };

  while (fgets(line, sizeof line, f)) {
    if (strncmp(line, "$Entities", 9) == 0) {
      int64_t counts[4];
      if (fscanf(f, "%ld %ld %ld %ld", &counts[0], &counts[1], &counts[2],
                 &counts[3]) != 4) { res->status = 6; fclose(f); return res; }
      for (int dim = 0; dim < 4; ++dim) {
        for (int64_t e = 0; e < counts[dim]; ++e) {
          int64_t etag, nphys;
          double dummy;
          if (fscanf(f, "%ld", &etag) != 1) { res->status = 6; fclose(f); return res; }
          int ncoord = dim == 0 ? 3 : 6;
          for (int k = 0; k < ncoord; ++k)
            if (fscanf(f, "%lf", &dummy) != 1) { res->status = 6; fclose(f); return res; }
          if (fscanf(f, "%ld", &nphys) != 1) { res->status = 6; fclose(f); return res; }
          for (int64_t k = 0; k < nphys; ++k) {
            int64_t p;
            if (fscanf(f, "%ld", &p) != 1) { res->status = 6; fclose(f); return res; }
            if (k == 0) entphys[entkey(dim, etag)] = static_cast<int32_t>(p);
          }
          if (dim > 0) {
            int64_t nbnd;
            if (fscanf(f, "%ld", &nbnd) != 1) { res->status = 6; fclose(f); return res; }
            for (int64_t k = 0; k < nbnd; ++k) {
              int64_t b;
              if (fscanf(f, "%ld", &b) != 1) { res->status = 6; fclose(f); return res; }
            }
          }
        }
      }
    } else if (strncmp(line, "$Nodes", 6) == 0) {
      int64_t nblocks, nnodes, mn, mx;
      if (fscanf(f, "%ld %ld %ld %ld", &nblocks, &nnodes, &mn, &mx) != 4) {
        res->status = 3; fclose(f); return res;
      }
      coords.reserve(nnodes * 3);
      tags.reserve(nnodes);
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t dim, etag, param, n;
        if (fscanf(f, "%ld %ld %ld %ld", &dim, &etag, &param, &n) != 4) {
          res->status = 3; fclose(f); return res;
        }
        // parametric node blocks (param != 0) carry extra per-node
        // coordinates this parser does not read; returning status 0 would
        // hand back silently corrupted geometry — report unsupported so
        // the caller falls back to the numpy parser (which raises)
        if (param != 0) { res->status = 3; fclose(f); return res; }
        int64_t base = static_cast<int64_t>(tags.size());
        for (int64_t i = 0; i < n; ++i) {
          int64_t t; if (fscanf(f, "%ld", &t) != 1) { res->status = 3; fclose(f); return res; }
          tags.push_back(t);
          tag2idx[t] = base + i;
        }
        for (int64_t i = 0; i < n; ++i) {
          double x, y, z;
          if (fscanf(f, "%lf %lf %lf", &x, &y, &z) != 3) { res->status = 3; fclose(f); return res; }
          coords.push_back(x); coords.push_back(y); coords.push_back(z);
        }
      }
    } else if (strncmp(line, "$Elements", 9) == 0) {
      int64_t nblocks, nelems, mn, mx;
      if (fscanf(f, "%ld %ld %ld %ld", &nblocks, &nelems, &mn, &mx) != 4) {
        res->status = 4; fclose(f); return res;
      }
      for (int64_t b = 0; b < nblocks; ++b) {
        int64_t dim, etag, etype, n;
        if (fscanf(f, "%ld %ld %ld %ld", &dim, &etag, &etype, &n) != 4) {
          res->status = 4; fclose(f); return res;
        }
        auto it = entphys.find(entkey(dim, etag));
        int32_t phys = it == entphys.end() ? -1 : it->second;
        bool keep = (etype >= 1 && etype <= 5) || etype == 15;
        for (int64_t i = 0; i < n; ++i) {
          int64_t t; if (fscanf(f, "%ld", &t) != 1) { res->status = 4; fclose(f); return res; }
          if (keep) {
            for (int k = 0; k < nvArr[etype]; ++k) {
              int64_t vt; if (fscanf(f, "%ld", &vt) != 1) { res->status = 4; fclose(f); return res; }
              auto vit = tag2idx.find(vt);
              if (vit == tag2idx.end()) { res->status = 4; fclose(f); return res; }
              verts_by_type[etype].push_back(
                  static_cast<int32_t>(vit->second));
            }
            ptags_by_type[etype].push_back(phys);
          } else {
            if (!fgets(line, sizeof line, f)) break;
          }
        }
      }
    }
  }
  fclose(f);

  int best = 0;
  for (int t = 1; t <= 5; ++t)
    if (!verts_by_type[t].empty() && (best == 0 || dimArr[t] > dimArr[best]))
      best = t;
  if (best == 0) { res->status = 5; return res; }

  res->n_nodes = static_cast<int64_t>(tags.size());
  res->nodes = static_cast<double*>(malloc(sizeof(double) * coords.size()));
  memcpy(res->nodes, coords.data(), sizeof(double) * coords.size());
  res->etype = best;
  res->n_cells = static_cast<int64_t>(ptags_by_type[best].size());
  res->cells = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * verts_by_type[best].size()));
  memcpy(res->cells, verts_by_type[best].data(),
         sizeof(int32_t) * verts_by_type[best].size());
  res->cell_tags = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * res->n_cells));
  memcpy(res->cell_tags, ptags_by_type[best].data(),
         sizeof(int32_t) * res->n_cells);
  // facet elements: the facet shape of the chosen cell type
  static const int facetType[6] = {0, 15, 1, 1, 2, 3};
  int ft = facetType[best];
  res->facet_nv = nvArr[ft];
  res->n_facet_elems = static_cast<int64_t>(ptags_by_type[ft].size());
  if (res->n_facet_elems > 0) {
    res->facet_verts = static_cast<int32_t*>(
        malloc(sizeof(int32_t) * verts_by_type[ft].size()));
    memcpy(res->facet_verts, verts_by_type[ft].data(),
           sizeof(int32_t) * verts_by_type[ft].size());
    res->facet_tags = static_cast<int32_t*>(
        malloc(sizeof(int32_t) * res->n_facet_elems));
    memcpy(res->facet_tags, ptags_by_type[ft].data(),
           sizeof(int32_t) * res->n_facet_elems);
  }
  return res;
}

void free_msh_result2(MshResult2* r) {
  if (!r) return;
  free(r->nodes);
  free(r->cells);
  free(r->cell_tags);
  free(r->facet_verts);
  free(r->facet_tags);
  delete r;
}

// partitioner for unstructured meshes.
// ---------------------------------------------------------------------

int32_t partition_bfs(const int32_t* interior, int64_t n_interior,
                      int64_t n_cells, int32_t n_parts, int32_t* part_out) {
  std::vector<std::vector<int32_t>> adj(n_cells);
  for (int64_t i = 0; i < n_interior; ++i) {
    int32_t a = interior[4 * i], b = interior[4 * i + 2];
    adj[a].push_back(b);
    adj[b].push_back(a);
  }
  std::vector<int32_t> part(n_cells, -1);
  int64_t target = (n_cells + n_parts - 1) / n_parts;
  int64_t next_seed = 0;
  for (int32_t p = 0; p < n_parts; ++p) {
    while (next_seed < n_cells && part[next_seed] >= 0) ++next_seed;
    if (next_seed >= n_cells) break;
    std::queue<int32_t> q;
    q.push(static_cast<int32_t>(next_seed));
    part[next_seed] = p;
    int64_t count = 1;
    while (!q.empty() && count < target) {
      int32_t c = q.front(); q.pop();
      for (int32_t nb : adj[c]) {
        if (part[nb] < 0 && count < target) {
          part[nb] = p;
          ++count;
          q.push(nb);
        }
      }
    }
  }
  // any unassigned cells (disconnected) go to the last part
  for (int64_t c = 0; c < n_cells; ++c)
    if (part[c] < 0) part[c] = n_parts - 1;
  memcpy(part_out, part.data(), sizeof(int32_t) * n_cells);
  return 0;
}

}  // extern "C"
