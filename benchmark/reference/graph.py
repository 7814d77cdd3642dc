"""The skeleton's spatial-partition adjacency stack (ST-GCN's 'spatial'
strategy), from the published edge list: hop distances up to ``max_hop``,
in-degree normalisation, and per hop a (root + closer) and a further
partition.  Numpy; a frozen copy of the layer's definition, not of the
program's code."""

import numpy as np

# the 53-joint skeleton's bones (reference dataset config)
SKELETON_EDGES = [
    (0, 1), (1, 3), (3, 5), (5, 19), (0, 2), (2, 4), (4, 6), (6, 20),
    (0, 7), (7, 8), (8, 9), (9, 10), (10, 21), (10, 22), (8, 11), (11, 13),
    (13, 15), (15, 17), (8, 12), (12, 14), (14, 16), (16, 18), (17, 23),
    (23, 24), (24, 25), (17, 26), (26, 27), (27, 28), (17, 29), (29, 30),
    (30, 31), (17, 32), (32, 33), (33, 34), (17, 35), (35, 36), (36, 37),
    (18, 38), (38, 39), (39, 40), (18, 41), (41, 42), (42, 43), (18, 44),
    (44, 45), (45, 46), (18, 47), (47, 48), (48, 49), (18, 50), (50, 51),
    (51, 52),
]


def hop_distance(num_node, edges, max_hop):
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = A[i, j] = 1
    hop = np.full((num_node, num_node), np.inf)
    reach = np.stack([np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]) > 0
    for d in range(max_hop, -1, -1):
        hop[reach[d]] = d
    return hop


def spatial_graph(num_node=53, max_hop=5, center=0):
    """(1 + 2 * max_hop, V, V) float32 adjacency stack."""
    edges = [(i, i) for i in range(num_node)] + list(SKELETON_EDGES)
    hop = hop_distance(num_node, edges, max_hop)
    adjacency = (hop <= max_hop).astype(np.float64)
    degree = adjacency.sum(0)
    norm = adjacency / np.where(degree > 0, degree, 1.0)[None, :]
    stack = []
    for h in range(max_hop + 1):
        root, close, further = (np.zeros((num_node, num_node)) for _ in range(3))
        for i in range(num_node):
            for j in range(num_node):
                if hop[j, i] != h:
                    continue
                if hop[j, center] == hop[i, center]:
                    root[j, i] = norm[j, i]
                elif hop[j, center] > hop[i, center]:
                    close[j, i] = norm[j, i]
                else:
                    further[j, i] = norm[j, i]
        stack += [root] if h == 0 else [root + close, further]
    return np.stack(stack).astype(np.float32)
