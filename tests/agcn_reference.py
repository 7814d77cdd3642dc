"""Plain PyTorch 2s-AGCN, joint stream: a reference of the layer equations.

Shi et al., "Two-Stream Adaptive Graph Convolutional Networks for
Skeleton-Based Action Recognition", CVPR 2019; lshiwjx/2s-AGCN
model/agcn.py, graph/ntu_rgb_d.py and graph/tools.py, written out in the
published layout (N*M, C, T, V) with torch's own layers, no fold, fused
layout or kernel.  Departures from the published code: the widths and
strides are arguments (the published ten units are the defaults), the
fixed graph is a buffer, and each graph unit keeps its last C_k
(``attention``, (N*M, K, V, V)).  Parameter names are the published
state_dict's.

Imports neither JAX nor anything of the program.  The caller sets the
precision: ``set_precision(tf32=False)`` before it runs (f32 products),
``tf32=True`` for the lower-precision control.
"""

import numpy as np
import torch
from torch import nn

WIDTHS = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)
STRIDES = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)
# graph/ntu_rgb_d.py's inward_ori_index, 1-based (child, parent)
INWARD_ORI_INDEX = [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7), (9, 21), (10, 9),
                    (11, 10), (12, 11), (13, 1), (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
                    (20, 19), (22, 23), (23, 8), (24, 25), (25, 12)]


def set_precision(tf32):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def edge2mat(link, num_node):
    A = np.zeros((num_node, num_node))
    for i, j in link:
        A[j, i] = 1
    return A


def normalize_digraph(A):
    Dl = np.sum(A, 0)
    Dn = np.zeros((A.shape[1], A.shape[1]))
    for i in range(A.shape[1]):
        if Dl[i] > 0:
            Dn[i, i] = Dl[i] ** (-1)
    return np.dot(A, Dn)


def ntu_graph(num_node=25):
    """(3, V, V): the identity, the normalised inward and outward edges."""
    inward = [(i - 1, j - 1) for (i, j) in INWARD_ORI_INDEX]
    outward = [(j, i) for (i, j) in inward]
    I = edge2mat([(i, i) for i in range(num_node)], num_node)
    return np.stack((I, normalize_digraph(edge2mat(inward, num_node)),
                     normalize_digraph(edge2mat(outward, num_node)))).astype(np.float32)


class unit_gcn(nn.Module):
    def __init__(self, in_channels, out_channels, A, coff_embedding=4, num_subset=3):
        super().__init__()
        self.inter_c = out_channels // coff_embedding
        self.PA = nn.Parameter(torch.from_numpy(A.copy()))
        self.register_buffer("A", torch.from_numpy(A.copy()), persistent=False)
        self.num_subset = num_subset
        self.conv_a = nn.ModuleList(nn.Conv2d(in_channels, self.inter_c, 1) for _ in range(num_subset))
        self.conv_b = nn.ModuleList(nn.Conv2d(in_channels, self.inter_c, 1) for _ in range(num_subset))
        self.conv_d = nn.ModuleList(nn.Conv2d(in_channels, out_channels, 1) for _ in range(num_subset))
        if in_channels != out_channels:
            self.down = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1), nn.BatchNorm2d(out_channels))
        else:
            self.down = lambda x: x
        self.bn = nn.BatchNorm2d(out_channels)
        self.soft = nn.Softmax(-2)
        self.relu = nn.ReLU()
        self.attention = None

    def forward(self, x):
        N, C, T, V = x.size()
        A = self.A + self.PA
        y, maps = None, []
        for i in range(self.num_subset):
            A1 = self.conv_a[i](x).permute(0, 3, 1, 2).contiguous().view(N, V, self.inter_c * T)
            A2 = self.conv_b[i](x).view(N, self.inter_c * T, V)
            A1 = self.soft(torch.matmul(A1, A2) / A1.size(-1))  # N V V
            maps.append(A1)
            A1 = A1 + A[i]
            A2 = x.view(N, C * T, V)
            z = self.conv_d[i](torch.matmul(A2, A1).view(N, C, T, V))
            y = z + y if y is not None else z
        self.attention = torch.stack(maps, 1)
        y = self.bn(y)
        y = y + self.down(x)
        return self.relu(y)


class unit_tcn(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=9, stride=1):
        super().__init__()
        pad = int((kernel_size - 1) / 2)
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size=(kernel_size, 1), padding=(pad, 0),
                              stride=(stride, 1))
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x):
        return self.bn(self.conv(x))


class TCN_GCN_unit(nn.Module):
    def __init__(self, in_channels, out_channels, A, stride=1, residual=True, kernel_size=9,
                 coff_embedding=4):
        super().__init__()
        self.gcn1 = unit_gcn(in_channels, out_channels, A, coff_embedding)
        self.tcn1 = unit_tcn(out_channels, out_channels, kernel_size=kernel_size, stride=stride)
        self.relu = nn.ReLU()
        if not residual:
            self.residual = lambda x: 0
        elif (in_channels == out_channels) and (stride == 1):
            self.residual = lambda x: x
        else:
            self.residual = unit_tcn(in_channels, out_channels, kernel_size=1, stride=stride)

    def forward(self, x):
        x = self.tcn1(self.gcn1(x)) + self.residual(x)
        return self.relu(x)


class Model(nn.Module):
    def __init__(self, num_class=60, num_point=25, num_person=2, in_channels=3, widths=WIDTHS, strides=STRIDES,
                 coff_embedding=4, temporal_kernel=9):
        super().__init__()
        A = ntu_graph(num_point)
        self.data_bn = nn.BatchNorm1d(num_person * in_channels * num_point)
        width = in_channels
        for i, (out, stride) in enumerate(zip(widths, strides)):
            self.add_module(f"l{i + 1}", TCN_GCN_unit(width, out, A, stride=stride, residual=i > 0,
                                                      kernel_size=temporal_kernel,
                                                      coff_embedding=coff_embedding))
            width = out
        self.n_units = len(widths)
        self.fc = nn.Linear(width, num_class)

    def units(self):
        return [getattr(self, f"l{i + 1}") for i in range(self.n_units)]

    def forward(self, x, keep=None):
        """x (N, C, T, V, M) -> (N, num_class); ``keep``, a list, gets each
        unit's output (N*M, C, T, V)."""
        N, C, T, V, M = x.size()
        x = x.permute(0, 4, 3, 1, 2).contiguous().view(N, M * V * C, T)
        x = self.data_bn(x)
        x = x.view(N, M, V, C, T).permute(0, 1, 3, 4, 2).contiguous().view(N * M, C, T, V)
        for unit in self.units():
            x = unit(x)
            if keep is not None:
                keep.append(x)
        c_new = x.size(1)
        x = x.view(N, M, c_new, -1)
        x = x.mean(3).mean(1)
        return self.fc(x)


def load(model, weights):
    """Load a published state_dict less BatchNorm's ``num_batches_tracked``."""
    state = dict(weights)
    for name, buf in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state.setdefault(name, torch.zeros_like(buf))
    model.load_state_dict(state, strict=True)
    return model
