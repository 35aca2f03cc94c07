"""Deformable-scene graph utilities (ctypes over native/src/diffreg_graph.cpp).

Counterpart of the JAX package's data/graph.py, over the same C++: the
NeuralTracking-heritage toolbox of the reference's vision3d/csrc/cpu/
{graph_proc,deformation_graph,node_sampling}: depth-map triangulation, mesh
erosion, coverage node sampling, geodesic/euclidean graph edges, graph
cleanup, connected components, pixel skinning anchors, min-distance FPS, and
the full deformation-graph builder.

All functions take and return numpy arrays on the host; the library is the
port's own build of both native sources (``data/native.py``), which raises
when it cannot be built.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .native import _load

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_B = ctypes.POINTER(ctypes.c_uint8)

_SIGS = {
    "graph_depth_to_mesh": (None, [_F, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_float, _F, _I, _I, _I]),
    "graph_erode_mesh": (None, [ctypes.c_int32, _I, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, _B]),
    "graph_sample_nodes": (ctypes.c_int32,
                           [_F, ctypes.c_int32, _B, ctypes.c_float,
                            ctypes.c_int32, ctypes.c_int64, _F, _I]),
    "graph_compute_edges_geodesic": (None, [_F, _B, ctypes.c_int32, _I,
                                            ctypes.c_int32, _I, ctypes.c_int32,
                                            ctypes.c_int32, ctypes.c_float,
                                            ctypes.c_int32, ctypes.c_int32,
                                            _I, _F, _F, _F]),
    "graph_compute_edges_euclidean": (None, [_F, ctypes.c_int32, ctypes.c_int32,
                                             ctypes.c_float, _I]),
    "graph_node_and_edge_clean_up": (None, [_I, ctypes.c_int32,
                                            ctypes.c_int32, _B]),
    "graph_compute_clusters": (ctypes.c_int32, [_I, ctypes.c_int32,
                                                ctypes.c_int32, _I, _I]),
    "graph_compute_pixel_anchors_geodesic": (None, [_F, _B, ctypes.c_int32,
                                                    ctypes.c_int32, _I,
                                                    ctypes.c_int32, ctypes.c_int32,
                                                    ctypes.c_int32, ctypes.c_float,
                                                    _I, _F]),
    "graph_compute_pixel_anchors_euclidean": (None, [_F, ctypes.c_int32, _F,
                                                     ctypes.c_int32, ctypes.c_int32,
                                                     ctypes.c_int32, ctypes.c_float,
                                                     _I, _F]),
    "graph_update_pixel_anchors": (None, [_I, ctypes.c_int32, _I,
                                          ctypes.c_int64]),
    "graph_sample_nodes_fps": (ctypes.c_int32, [_F, ctypes.c_int32,
                                                ctypes.c_float, ctypes.c_int32, _I]),
    "graph_build_deformation_graph": (None, [_F, ctypes.c_int32, _I,
                                             ctypes.c_int32, ctypes.c_int32,
                                             ctypes.c_int32, ctypes.c_float,
                                             ctypes.c_float, _I, _F, _F,
                                             _I, _F, _F]),
}


def _lib():
    lib = _load()
    if not getattr(lib, "_graph_sigs", False):
        for name, (res, args) in _SIGS.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        lib._graph_sigs = True
    return lib


def _fp(a):
    return a.ctypes.data_as(_F)


def _ip(a):
    return a.ctypes.data_as(_I)


def _bp(a):
    return a.ctypes.data_as(_B)


def depth_to_mesh(point_image: np.ndarray, max_triangle_edge_distance: float):
    """[H, W, 3] camera-space point image -> (vertices [V,3], faces [F,3],
    vertex_pixels [V,2] as (x, y)). Invalid pixels have z <= 0."""
    pi = np.ascontiguousarray(point_image, np.float32)
    h, w, _ = pi.shape
    verts = np.zeros((h * w, 3), np.float32)
    pixels = np.zeros((h * w, 2), np.int32)
    faces = np.zeros((2 * (h - 1) * (w - 1), 3), np.int32)
    counts = np.zeros(2, np.int32)
    _lib().graph_depth_to_mesh(_fp(pi), h, w, float(max_triangle_edge_distance),
                               _fp(verts), _ip(pixels), _ip(faces), _ip(counts))
    nv, nf = int(counts[0]), int(counts[1])
    return verts[:nv].copy(), faces[:nf].copy(), pixels[:nv].copy()


def erode_mesh(vertices: np.ndarray, faces: np.ndarray, n_iterations: int = 1,
               min_neighbors: int = 4) -> np.ndarray:
    """Boolean mask of vertices surviving ``n_iterations`` of face erosion."""
    f = np.ascontiguousarray(faces, np.int32)
    mask = np.zeros(len(vertices), np.uint8)
    _lib().graph_erode_mesh(len(vertices), _ip(f), len(f), int(n_iterations),
                            int(min_neighbors), _bp(mask))
    return mask.astype(bool)


def sample_nodes(vertices: np.ndarray, non_eroded: Optional[np.ndarray] = None,
                 node_coverage: float = 0.05, use_only_non_eroded: bool = True,
                 seed: Optional[int] = 0):
    """Greedy coverage sampling -> (node_positions [K,3], node_indices [K]).
    ``seed=None`` keeps the vertex order (deterministic);
    any int shuffles reproducibly."""
    v = np.ascontiguousarray(vertices, np.float32)
    ne = np.ascontiguousarray(
        np.ones(len(v), np.uint8) if non_eroded is None
        else non_eroded.astype(np.uint8))
    pos = np.zeros((len(v), 3), np.float32)
    idx = np.zeros(len(v), np.int32)
    k = _lib().graph_sample_nodes(
        _fp(v), len(v), _bp(ne), float(node_coverage),
        int(use_only_non_eroded), -1 if seed is None else int(seed),
        _fp(pos), _ip(idx))
    return pos[:k].copy(), idx[:k].copy()


def compute_edges_geodesic(vertices, valid_vertices, faces, node_indices,
                           max_neighbors: int = 8, node_coverage: float = 0.05,
                           allow_only_valid_vertices: bool = True,
                           enforce_total_num_neighbors: bool = False):
    """Per-node geodesic neighbor nodes over the mesh.

    Returns (edges [K,M] -1-padded, weights [K,M] normalized, dists [K,M],
    node_to_vertex [K,V] geodesic distances, -1 where unreached)."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    ni = np.ascontiguousarray(node_indices, np.int32)
    vv = np.ascontiguousarray(valid_vertices.astype(np.uint8))
    k, n = len(ni), len(v)
    edges = np.zeros((k, max_neighbors), np.int32)
    weights = np.zeros((k, max_neighbors), np.float32)
    dists = np.zeros((k, max_neighbors), np.float32)
    n2v = np.full((k, n), -1.0, np.float32)
    _lib().graph_compute_edges_geodesic(
        _fp(v), _bp(vv), n, _ip(f), len(f), _ip(ni), k, int(max_neighbors),
        float(node_coverage), int(allow_only_valid_vertices),
        int(enforce_total_num_neighbors), _ip(edges), _fp(weights), _fp(dists),
        _fp(n2v))
    return edges, weights, dists, n2v


def compute_edges_euclidean(nodes, max_neighbors: int = 8,
                            max_influence: float = 0.5):
    """k nearest nodes per node, -1-padded (preserves the reference's
    squared-vs-raw threshold comparison)."""
    p = np.ascontiguousarray(nodes, np.float32)
    edges = np.zeros((len(p), max_neighbors), np.int32)
    _lib().graph_compute_edges_euclidean(_fp(p), len(p), int(max_neighbors),
                                         float(max_influence), _ip(edges))
    return edges


def node_and_edge_clean_up(graph_edges, valid_nodes_mask):
    """Iteratively invalidate nodes with <= 1 valid neighbor (in-place
    semantics of the reference; returns the updated bool mask)."""
    e = np.ascontiguousarray(graph_edges, np.int32)
    m = np.ascontiguousarray(valid_nodes_mask.astype(np.uint8))
    _lib().graph_node_and_edge_clean_up(_ip(e), e.shape[0], e.shape[1], _bp(m))
    return m.astype(bool)


def compute_clusters(graph_edges):
    """Connected components -> (cluster_ids [K], cluster_sizes list)."""
    e = np.ascontiguousarray(graph_edges, np.int32)
    ids = np.zeros(e.shape[0], np.int32)
    sizes = np.zeros(max(e.shape[0], 1), np.int32)
    n = _lib().graph_compute_clusters(_ip(e), e.shape[0], e.shape[1],
                                      _ip(ids), _ip(sizes))
    return ids, sizes[:n].tolist()


def compute_pixel_anchors_geodesic(node_to_vertex, valid_nodes, vertices,
                                   vertex_pixels, width: int, height: int,
                                   num_anchors: int = 4,
                                   node_coverage: float = 0.05):
    """Per-pixel skinning anchors from geodesic node-vertex distances.

    NOTE: anchors are the nearest nodes by geodesic DISTANCE (the
    NeuralTracking intent); the reference's vendored copy builds the sorted
    set but accidentally emits its by-node-id map order."""
    n2v = np.ascontiguousarray(node_to_vertex, np.float32)
    vn = np.ascontiguousarray(valid_nodes.astype(np.uint8))
    vp = np.ascontiguousarray(vertex_pixels, np.int32)
    anchors = np.full((height, width, num_anchors), -1, np.int32)
    weights = np.zeros((height, width, num_anchors), np.float32)
    _lib().graph_compute_pixel_anchors_geodesic(
        _fp(n2v), _bp(vn), n2v.shape[0], len(vp), _ip(vp), height, width,
        int(num_anchors), float(node_coverage), _ip(anchors), _fp(weights))
    return anchors, weights


def compute_pixel_anchors_euclidean(nodes, point_image, num_anchors: int = 4,
                                    node_coverage: float = 0.05):
    """Per-pixel euclidean skinning anchors over a [H, W, 3] point image."""
    p = np.ascontiguousarray(nodes, np.float32)
    pi = np.ascontiguousarray(point_image, np.float32)
    h, w, _ = pi.shape
    anchors = np.full((h, w, num_anchors), -1, np.int32)
    weights = np.zeros((h, w, num_anchors), np.float32)
    _lib().graph_compute_pixel_anchors_euclidean(
        _fp(p), len(p), _fp(pi), h, w, int(num_anchors), float(node_coverage),
        _ip(anchors), _fp(weights))
    return anchors, weights


def update_pixel_anchors(node_id_mapping: dict, pixel_anchors: np.ndarray):
    """Remap anchor ids through {old: new}; -1 passes through. In-place on a
    contiguous copy; returns the updated array."""
    a = np.ascontiguousarray(pixel_anchors, np.int32)
    n_old = (max(node_id_mapping) + 1) if node_id_mapping else 0
    mapping = np.arange(max(n_old, 1), dtype=np.int32)
    for old, new in node_id_mapping.items():
        mapping[old] = new
    _lib().graph_update_pixel_anchors(_ip(mapping), len(mapping), _ip(a), a.size)
    return a


def sample_nodes_with_fps(points, min_distance: float = 0.05,
                          num_samples: int = -1):
    """Farthest-point sampling with min-distance pruning -> node indices."""
    p = np.ascontiguousarray(points, np.float32)
    out = np.zeros(len(p), np.int32)
    k = _lib().graph_sample_nodes_fps(_fp(p), len(p), float(min_distance),
                                      int(num_samples), _ip(out))
    return out[:k].astype(np.int64)


def build_deformation_graph_from_point_cloud(
        points, node_indices, num_neighbors: int = 8, num_anchors: int = 4,
        max_distance: float = 0.05, node_coverage: float = 0.05):
    """Full deformation graph: per-node geodesic node neighbors (over the
    voxel-hash point adjacency) and per-point skinning anchors.

    Returns (neighbor_indices [K,Nn], neighbor_distances, neighbor_weights,
    anchor_indices [N,Na], anchor_distances, anchor_weights)."""
    p = np.ascontiguousarray(points, np.float32)
    ni = np.ascontiguousarray(node_indices, np.int32)
    k, n = len(ni), len(p)
    n_idx = np.zeros((k, num_neighbors), np.int32)
    n_dst = np.zeros((k, num_neighbors), np.float32)
    n_wgt = np.zeros((k, num_neighbors), np.float32)
    a_idx = np.zeros((n, num_anchors), np.int32)
    a_dst = np.zeros((n, num_anchors), np.float32)
    a_wgt = np.zeros((n, num_anchors), np.float32)
    _lib().graph_build_deformation_graph(
        _fp(p), n, _ip(ni), k, int(num_neighbors), int(num_anchors),
        float(max_distance), float(node_coverage),
        _ip(n_idx), _fp(n_dst), _fp(n_wgt), _ip(a_idx), _fp(a_dst), _fp(a_wgt))
    return n_idx, n_dst, n_wgt, a_idx, a_dst, a_wgt
