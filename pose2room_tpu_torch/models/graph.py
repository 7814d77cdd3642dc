"""Skeleton graph adjacency (precomputed numpy constant).

Port of pose2room_tpu/models/graph.py: the K-partition 'spatial' adjacency
stack of the ST-GCN backbone, from hop distances by boolean matrix powers,
in-degree normalisation, and a root / closer / further split of each hop
(reference models/p2rnet/modules/stgcn_layers.py:182-233).  Pure numpy, so
the result is bit-equal to the JAX package's.
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
