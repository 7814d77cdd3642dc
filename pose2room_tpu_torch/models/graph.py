"""Skeleton graph adjacency (precomputed numpy constants).

Port of pose2room_tpu/models/graph.py: the K-partition 'spatial' adjacency
stack of the ST-GCN backbone, from hop distances by boolean matrix powers,
in-degree normalisation, and a root / closer / further split of each hop
(reference models/p2rnet/modules/stgcn_layers.py:182-233).  Pure numpy, so
the result is bit-equal to the JAX package's.

``build_ntu_graph`` is 2s-AGCN's NTU RGB+D skeleton (lshiwjx/2s-AGCN
graph/ntu_rgb_d.py and graph/tools.py): 25 joints, three subsets (the
identity, the in-degree-normalised inward edges, the outward edges).
"""

import numpy as np

from pose2room_tpu_torch.config.dataset_config import SKELETON_EDGES

# Joint order of the block-sparse eval chain (ops/stgcn_sparse.py): the 53
# joints and one pad slot (value 53, at slot 36) paired so that the (27, 27)
# grid of 128x128 tiles of the folded graph matrix has as few nonzero tiles
# as possible: 279 against 391 in the natural order.  Valid for the default
# 53-joint skeleton with max_hop=5; a copy of the JAX package's constant.
SPARSE_JOINT_ORDER = np.asarray(
    [43, 46, 33, 24, 45, 48, 9, 10, 52, 49, 8, 11, 50, 44, 12, 14, 39, 47,
     5, 19, 37, 34, 41, 38, 15, 35, 7, 0, 23, 30, 31, 25, 22, 21, 29, 26,
     53, 40, 42, 51, 20, 6, 3, 4, 36, 28, 1, 2, 17, 13, 32, 27, 16, 18],
    dtype=np.int32,
)


def get_hop_distance(num_node, edges, max_hop=1):
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
        A[i, j] = 1
    hop_dis = np.full((num_node, num_node), np.inf)
    transfer_mat = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    arrive_mat = np.stack(transfer_mat) > 0
    for d in range(max_hop, -1, -1):
        hop_dis[arrive_mat[d]] = d
    return hop_dis


def normalize_digraph(A):
    """Column-normalise by in-degree: A @ D with D = diag(1/colsum)."""
    Dl = A.sum(0)
    Dn = np.zeros_like(A)
    idx = Dl > 0
    Dn[np.where(idx)[0], np.where(idx)[0]] = Dl[idx] ** (-1)
    return A @ Dn


def build_spatial_graph(num_node=53, edges=None, max_hop=5, center=0):
    """The (K, V, V) float32 spatial-partition adjacency stack, K = 1 + 2*max_hop:
    the hop-0 root partition, then per hop 1..max_hop a (root + closer to
    center) partition and a further-from-center partition."""
    if edges is None:
        edges = SKELETON_EDGES
    edges = [(i, i) for i in range(num_node)] + list(edges)
    hop_dis = get_hop_distance(num_node, edges, max_hop=max_hop)

    valid_hop = range(0, max_hop + 1)
    adjacency = np.zeros((num_node, num_node))
    for hop in valid_hop:
        adjacency[hop_dis == hop] = 1
    norm_adj = normalize_digraph(adjacency)

    A = []
    for hop in valid_hop:
        a_root = np.zeros((num_node, num_node))
        a_close = np.zeros((num_node, num_node))
        a_further = np.zeros((num_node, num_node))
        for i in range(num_node):
            for j in range(num_node):
                if hop_dis[j, i] != hop:
                    continue
                if hop_dis[j, center] == hop_dis[i, center]:
                    a_root[j, i] = norm_adj[j, i]
                elif hop_dis[j, center] > hop_dis[i, center]:
                    a_close[j, i] = norm_adj[j, i]
                else:
                    a_further[j, i] = norm_adj[j, i]
        if hop == 0:
            A.append(a_root)
        else:
            A.append(a_root + a_close)
            A.append(a_further)
    return np.stack(A).astype(np.float32)


# NTU RGB+D's 24 bones as (child, parent), 0-based (graph/ntu_rgb_d.py's
# inward_ori_index less one): each points towards joint 20, the spine at
# the shoulders
NTU_INWARD = [(i - 1, j - 1) for i, j in [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7), (9, 21), (10, 9), (11, 10), (12, 11),
    (13, 1), (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
    (24, 25), (25, 12)]]


def edge_matrix(edges, num_node):
    """A[j, i] = 1 for each edge (i, j): column i holds the edges out of i."""
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
    return A


def build_ntu_graph(num_node=25):
    """The (3, V, V) float32 adjacency stack of 2s-AGCN's 'spatial' labelling:
    the identity, the inward edges and the outward edges, each edge set
    column-normalised by in-degree (graph/tools.py:get_spatial_graph)."""
    outward = [(j, i) for i, j in NTU_INWARD]
    A = np.stack([edge_matrix([(i, i) for i in range(num_node)], num_node),
                  normalize_digraph(edge_matrix(NTU_INWARD, num_node)),
                  normalize_digraph(edge_matrix(outward, num_node))])
    return A.astype(np.float32)
