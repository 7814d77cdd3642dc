#!/usr/bin/env python3
"""Start the PyTorch port (pose2room_tpu_torch) on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the device, and its name and power limit from nvidia-smi.
2. Builds every CUDA kernel from csrc/ (nvcc, one process per source),
   and beside them csrc/latency_probe.cu, which measures instruction
   latencies for FPS's floor.
3. Kernel phase: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (epilogue: residual on/off, the unpadded first
   block, B in {1, 8}, atol = rtol = 1e-4 for sums of 192 products taken in
   another order and, on the card, in 3xTF32 (tconv_mma.cuh), pad columns
   exactly 0, two launches the same bits; FPS: B in {1, 8, 32}, 512 -> 128
   with near-origin and duplicated points, indices exactly equal, on the
   card and on the CPU), then times each beside its bound: device time, by
   CUDA events around launches queued
   behind a sleeping kernel, so the host's cost of issuing them is not
   counted (the plain versions and the library calls alike).
   FPS is latency-bound, so beside its roofline bound it prints a latency
   floor: (npoint - 1) dependent picks, each at least LDS.128 + 3 FADD +
   FMUL + FMNMX + log2(16) IMNMX + REDUX cycles (the last pick's
   coordinates, a distance and its min, a lane's 16-point argmax, one
   cross-lane reduction), each latency measured in this run by
   csrc/latency_probe.cu (dependent chains timed with clock64), at the SM
   clock nvidia-smi reads while the card is busy; and ptxas's registers,
   stack frame and spills of each FPS instantiation, which must be 0 bytes.
   The train kernels likewise, at B in {1, 8}, full width, on the fold's
   layout: kernel 3 (tconv + BN1 affine + column moments) and kernel 4 (its
   transpose + ReLU mask + moments + tap gradient) against their plain
   versions (y2, dpre: atol = rtol = 1e-4; column moments within 1e-5 of each
   column's scale, the sum of the magnitudes of its terms; dtaps within 1e-4
   of its max; pad columns exactly 0; two launches the same bits), and
   against float64: kernel 3's conv, kernel 4's dt1 (where the ReLU mask
   lets it through) and its dtaps each within 5e-7 of sum |a*b|, signed bias
   within 5e-8; timed beside their bounds and cuDNN.
   Kernels 1, 3, 4 and 5 form their products on the tensor cores in 3xTF32;
   each prints its share of two bounds: the f32 CUDA-core bound and the
   tensor-core bound max(bytes / 3.35 TB/s, 3 x flops / 495 TFLOP/s), which
   is the ``bound_ms`` of its row in the ``kernels`` line.  The cuDNN conv2d
   of the temporal conv alone (TF32 off) is timed beside kernels 1 and 3,
   cuDNN's conv2d_input + conv2d_weight beside kernel 4.
   Kernel 5 (block-sparse graph matmul + BN1 + ReLU) at B in {1, 8}, full
   width, for the annealed and the natural joint order, on the fold's layout
   (a random folded matrix on the support of A, permuted and packed into its
   279 / 391 nonzero tiles; the pad slot of x and vecs zero): against its
   plain version within atol = rtol = 1e-4 (f32 sums of 1280-2560 products
   taken in another order), the pad slot exactly 0, two launches the same
   bits, its acc (relu(acc) - relu(-acc), two launches with s1 = +-1 and
   b1 = 0) within 5e-7 of sum |a*b| of a float64 matmul, bias within 5e-8,
   and kernel 1 on its output in the permuted layout; timed beside its
   bounds and the dense path's matmul + BN1 + ReLU on the densified matrix.
4. Serving phase: the demo runner at full width (T=768, 53x64 joints, 512
   seeds, 128 proposals, 100 gaussians) on random weights from seed 42,
   answering the demo clip and three rotated copies; the launch counts must
   show 6 epilogue launches and 1 FPS launch per request; the card's
   ``generate`` must match the same model on the CPU (indices exactly, floats
   within 5e-4).  Then batch-1 request latency and B=32 generate clips/s.
5. Train phase: the train runner at the full width of
   configs/config_files/p2rnet_train.yaml, global batch 8, f32, on in-memory
   synthetic scenes (16 train with augmentation, 8 val) for one epoch: 2
   train steps and 1 val pass.  Every loss finite, weights and BN running
   statistics moved, ``model_final.pth`` written and loaded by the runners'
   ``setup``; launches exactly 6 train_fwd + 6 train_bwd + 1 FPS per
   train step and 6 epilogue + 1 FPS per val step.  Then one train step on
   the card against the same step on the CPU (same weights, B=2 full-width
   batch, same MDN noise): seed and proposal indices equal, loss terms within
   1e-4 relative, each gradient within 1e-3 of its max, running statistics
   within 1e-4.  Then the B=8 train step time (CUDA events, median of 5 after
   2 warm-ups), samples/s, peak memory, and a torch.profiler top-10 with
   the hand-written kernels' rows.
5b. Train options phase: the train runner at the same width with weight
   decay 0.01, clip_norm 1.0, a milestone at epoch 1 and a bnscheduler
   (momentum 0.5, then 0.25), on 16 train and 8 val scenes (2 train steps
   and 1 val step an epoch), each run from its own working directory (the
   TensorBoard board writes to ./runs) with its launch counts (6 train_fwd
   + 6 train_bwd + 1 FPS a train step, 6 epilogue + 1 FPS a val step).
   R0, R0', R1 and R2 run with PyTorch's deterministic algorithms (the
   gathers' backward otherwise adds by atomics), the ops without a
   deterministic implementation listed.  R0 and R0' (2 epochs each):
   bit-equal or not, and the largest gap.  R1 (1 epoch) and R2 (``resume:
   True``, a sibling run dir): R2 resumes from R1's model_last_1.pth,
   starts at epoch index 1, its restored state (net, optimizer, epoch,
   min_loss) equals the file, its epoch-2 lr, BN momentum and AdamW step
   counts equal R0's, its epoch-2 mean losses are within 1e-4 relative of
   R0's, and its final state equals R0's bit for bit where R0 == R0'
   (scripts/torch_train_determinism.py measures the same pair with the
   default algorithms).  R3 (``finetune`` from R1's best less one head
   tensor, ``freeze: [backbone]``, detection ``optim_spec: {lr: 1e-4}``):
   the partial load
   logged, every backbone parameter bit-identical under weight decay, its
   BN running statistics moved, the groups' lr.  The process- and
   thread-mode loaders (2 workers) at full width: batches bit-equal,
   samples/s.  R4 (process workers, ``h2d_dtype: float16``,
   ``profile_steps: 1``, 2 epochs): the step's targets are the
   float16-rounded host arrays and its input the f32 one, the trace under
   the run dir names the train kernels and FPS, and the board's tags and
   steps (or a note that tensorboard is not installed).  The phase's wall
   time.
6. Test phase: the test runner at the full width of p2rnet_test.yaml with
   ``model.sparse_eval: true``, random weights from seed 42, on 8 in-memory
   synthetic scenes (900 frames resampled to 768, no augmentation) at batch
   1: launches exactly 6 stgcn_sparse + 6 epilogue + 1 FPS per batch, every
   metric finite, the per-batch test time, and a profile of a second run.
   The card's sparse ``generate`` against the same model on the CPU
   (indices exactly, floats within 5e-4, seed features within 2e-4) and
   against the card's dense ``generate`` on the same weights (same bands),
   and both chains' batch-1 and B=32 ``generate`` times, in turns, and a
   profile of each chain's B=32 ``generate``.  Then ``remove_far_box: false`` runs on 4
   scenes on the card and on the CPU, with the size head's mixture means set
   so that the random boxes are ~1.5 m wide and AP is not trivially 0: every
   AP and recall within 1e-6.
6b. Multi-mode and mesh test phase: the test runner with ``test.multi_mode:
   true`` on the 8 scenes at batch 1 (launches exactly 6 stgcn_sparse + 6
   epilogue + 1 FPS per batch, as the deterministic run; finite metrics;
   ``drawn_run_salt`` / ``drawn_n_samples`` in out_config.yaml equal to
   ``runners/test.multi_mode_draws``; the per-batch time beside the drawn
   n); the card's multi-mode sparse ``generate`` at n=99 against the CPU's
   on the same noise (drawn on the CPU, copied to the card): indices equal,
   at most 1e-5 of the Bernoulli weights ``u < pi`` flipped (counted and
   printed), the box outputs within generate_gap's bands on the proposals
   whose masks agree, the rest on all; multi-mode against deterministic
   ``generate`` in turns (CUDA events) at batch 1 with n = 1, the drawn n
   and 99 and at B=32 with n=99, the device noise draw's own time, and the
   B=32 peak device memory; three multi-mode runs with dumps at threshold
   0.05 on 4 scenes (remove_far_box off, the metre-sized boxes), then
   ``eval.multi_modal`` over them (max mAP finite, TMD finite and >= 1);
   and an ``eval_mesh_ap`` run on the card and on the CPU on those 4
   scenes: every key, ``_mesh`` ones included, within 1e-6, with the
   voxelizing and metric stages' host times.
7. bf16 kernel phase (``model.compute_dtype: bfloat16``): the bf16 legs of
   kernels 1 (residual on/off; 128-column items, double-buffered copies,
   the output staged in shared memory) and 5 (annealed order; on wgmma) at
   B in {1, 8}, full width, on bf16 operands in the fold's layout: against
   their plain versions on the card (within 1 bf16 ulp wherever the plain
   output is above 1e-3 of its max, within 2^-7 of the max elsewhere; the
   share of elements that differ printed beside the 0.0018-0.0059% of the
   earlier mma.sync legs), against float64 from the same bf16
   operands (within 1 bf16 ulp of the float64 value rounded to bf16
   wherever that value is above 2^-12 of the element's term scale
   S = |s| * sum|a*b| + |b| [+ |x|], within 2^-10 of S elsewhere), the pad
   columns exactly 0, two launches the same bits; timed beside their bounds
   at the bf16 tensor-core peak (989 TFLOP/s) and 3.35 TB/s, beside cuDNN's
   bf16 conv2d (kernel 1, tconv only) and the dense matmul on the densified
   matrix + BN1 + ReLU (kernel 5; the f32-upcast route and, timing only,
   bf16 operands).
8. bf16 serving phase: the demo runner with ``compute_dtype: bfloat16`` at
   full width on the four demo clips: 6 ``stgcn_epilogue_bf16`` and 1 FPS
   launches per request; the card's bf16 ``generate`` against the CPU's
   (seed indices equal, seed features and votes within 1e-2 of their max,
   proposal agreement printed; over the proposals both pick, each output's
   median row within 2e-2 of its max and at most a tenth of the rows beyond
   0.05, the JAX package's bf16 band: a vote at the ball's edge can change
   one proposal's pooled feature); batch-1 request
   latency and B=1 / B=32 ``generate`` beside the f32 chain's, in turns; a
   profile of the B=32 bf16 ``generate``.
9. bf16 test phase: the test runner with ``compute_dtype: bfloat16`` and
   ``sparse_eval`` on the 8 synthetic scenes: 6 ``stgcn_sparse_bf16`` + 6
   ``stgcn_epilogue_bf16`` + 1 FPS launches per batch, finite metrics; the
   card's bf16 sparse ``generate`` against the CPU's (as in 8); with
   ``remove_far_box: false`` and metre-sized boxes on 4 scenes, AP and
   recall on the card against the CPU (mAP and AR within 0.1; one class's AP
   can move by a step when a vote at a ball's edge changes one box).
10. bf16 train phase (``compute_dtype: bfloat16`` training): the
   full-width ``FusedTrainLayer`` (B=2, the residual block) on the card
   against the CPU (at most 1e-3 of the output's elements differing, the
   output and each gradient in the JAX package's bulk band, the batch
   statistics within 1e-3 of their max: a y rounding that flips between the
   two sum orders moves what follows it); one bf16 ``--mode train`` epoch
   through the runner at global batch 8 (6 ``stgcn_train_fwd_bf16`` + 6
   ``stgcn_train_bwd_bf16`` + 1 FPS launches per train step, 6
   ``stgcn_epilogue_bf16`` + 1 FPS per val step, no f32 leg; finite losses;
   f32 state, moved; ``model_final.pth`` loaded by the bf16 demo runner);
   a B=2 bf16 step on the card against the CPU (before FPS: seed indices
   equal, seed features and votes within 1e-2 of their max, the vote loss
   within 2e-2 and the backbone's running statistics within 2e-2; FPS's
   picks over bf16 votes meet near ties, so their agreement is printed and
   the later loss terms are held only where every pick agrees; each
   gradient's relative L2 gap within twice the larger of the two devices'
   batch-order spreads, the step with the clips in the other order: bf16
   rounding noise dominates the backbone's gradient); the B=8 bf16 step beside the
   f32 step, in turns (samples/s, peak memory, launch counts of one bf16
   step) and a profile of the bf16 step.  The bf16 kernel phase (7) also
   holds the bf16 legs of kernels 3 and 4 at B in {1, 8} (and T=50, which
   16 does not divide): against their plain versions (y2, dpre within 1
   bf16 ulp; kernel 4's moments within 1e-5 of scale, dtaps within 1e-4 of
   max), against float64 on the same bf16 operands (y2, dpre within 1 bf16
   ulp above 2^-12 of the term scale; the moments and dtaps within 5e-7 of
   sum|a*b|, bias within 5e-8), pad columns 0, two launches the same bits;
   timed beside their bounds and cuDNN's bf16 conv2d (kernel 3) and
   conv2d_input + conv2d_weight (kernel 4), with the kernel / cuDNN ratio.
   Both legs run on items of 128 rows x 64 columns, two 8-warp blocks an
   SM, double-buffered copies; kernel 3 stores y2 from a staged tile,
   kernel 4 shares its two products over all warps; their sums are the
   earlier legs', so the one-ulp shares are printed beside the earlier
   legs' (EARLIER_TRAIN_SHARES).
11. Data-parallel phase: ranks as subprocesses of ``python -m
   torch.distributed.run ... chip_smoke.py --ddp-worker <spec.json>`` on
   localhost (the kernels are built already), each from its own working
   directory, with deterministic algorithms, p2rnet_train.yaml at full
   width, f32, clipping at 1.0, two train steps on eight synthetic clips
   with each step's noise drawn for the whole batch and sliced by rank.
   (a) World 1 on NCCL: losses, step-1 gradients, parameters and running
   statistics after each step bit-equal to the same steps in this process;
   6 + 6 + 1 launches a step.  (b) World 2 on gloo, both ranks on cuda:0,
   4 + 4, 6 + 6 + 1 launches a step a rank: both ranks' states bit-equal;
   step 1 against this process at 8:
   losses within 1e-4 relative, each gradient within 1e-3 of its max or
   no further from a CPU float64 step's (whose seeds and proposals must
   equal the card's) than three times that leaf's own error in two
   one-process runs (this batch order and another), running statistics
   within 1e-4.  After step 1 f32 runs that round differently part (ROADMAP
   section 3), so the card's later state is printed, not held; the update
   through DDP is held in float64 instead: the two ranks run the same two
   steps on the CPU in float64 (gloo), against this process's float64
   steps at 8: step-1 gradients within 1e-8 of their max, losses within
   1e-6 relative, parameters and running statistics after each step within
   1e-5 of their max, both ranks bit-equal.  Then the train runner under the two ranks (1
   epoch of 16 train and 8 val scenes, 4 a rank): 6 + 6 + 1 launches a
   train step and 6 + 1 a val step a rank, both ranks' final states bit-equal
   (at the config's lr), one run dir holding rank 0's files only, no board
   from rank 1.  (c) The sparse_eval test runner
   under the two ranks on 8 scenes (4 a rank; metre-sized boxes,
   remove_far_box off): 6 + 6 + 1 launches a batch a rank, every merged
   AP / recall within 1e-6 of this process's run, the merged mean losses
   too, one out_config.yaml.  The backend of each run, the B=8 step times
   of this process, (a) and (b) (CUDA events, median of 5), and the
   collectives' host and device time a step from the profiler.
12. Data pipeline phase, recordings to pictures, in its own directory: a
   scene graph made here (an 8x3x8 m room, a sofa, a fridge, a tv and a
   desk, an apple to grab, a door) through stage 1
   (``datagen.generate_room_programs``, 3 scripts), stage 2
   (``render_recordings`` driving a stand-in simulator that writes a
   900-frame, 56-joint ``pd_script.txt`` walk past the scripts' objects),
   stage 3 (``read_pd_script`` and ``build_samples``, 8 augmentations: 24
   samples, each checked for shapes, class ids and a vote mask).  Where
   h5py imports, ``generate_samples`` writes them and
   scripts/torch_split_samples.py splits them (they must read back equal to
   the in-memory samples, and ``DatasetConfig(split=)`` must read the
   written avg_data.json); otherwise they stay in memory, split by
   ``generate_splits``' rule.  Then one train runner epoch at
   p2rnet_train.yaml's width, batch 8 (6 + 6 + 1 launches a train step,
   6 + 1 a val step, finite losses, model_final.pth), ``eval_nn_loss`` on
   a val batch on the card and the CPU (same weights, batch and MDN noise:
   assignments equal, each term within 1e-4 relative), the sparse_eval test
   runner finetuned from model_final.pth on the held-out samples at batch 1
   (6 + 6 + 1 launches a batch, dumps, per-class AP), ``three_nn`` at B=8,
   1024 x 256 with repeated known points (indices equal on the card and the
   CPU, distances within 1e-5, also with TF32 on around the call), and,
   where matplotlib imports, scripts/torch_render_results.py on the first
   test dump (with its sample file where h5py imports) and
   scripts/torch_render_sample.py (where h5py imports): each PNG over
   10 kB.  Host seconds of datagen, the train epoch, the test run and the
   renders, and the phase's wall time, beside the card's name and power
   limit.
13. Prints the ``kernels`` JSON line (nine entries), the nvidia-smi line,
   and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA card and the repository around it.
"""

import ctypes
import dataclasses
import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from pose2room_tpu_torch import kernels
from pose2room_tpu_torch.config.loader import CONFIG, mount_external_config, read_to_dict
from pose2room_tpu_torch.data import synth
from pose2room_tpu_torch.data.dataset import SceneDataset, load_demo_clip
from pose2room_tpu_torch.data.loader import DataLoader, collate
from pose2room_tpu_torch.device import set_precision_policy
from pose2room_tpu_torch.eval import multi_modal
from pose2room_tpu_torch.models.graph import SPARSE_JOINT_ORDER, build_spatial_graph
from pose2room_tpu_torch.models.p2rnet import P2RNet, P2RNetConfig
from pose2room_tpu_torch.ops import sampling, stgcn_fused, stgcn_sparse, stgcn_train
from pose2room_tpu_torch.parallel import init_distributed, process_count, process_index, shutdown, wrap_model
from pose2room_tpu_torch.runners import common, demo
from pose2room_tpu_torch.runners import test as test_runner
from pose2room_tpu_torch.runners import train as train_runner
from pose2room_tpu_torch.train import engine
from pose2room_tpu_torch.train.checkpoint import CheckpointIO
from pose2room_tpu_torch.train.state import make_optimizer
from pose2room_tpu_torch.train.step import batch_to_device, train_step

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO_CLIP = os.path.join(REPO, "demo", "inputs", "input_joints_1.npy")
TEST_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_test.yaml")
TRAIN_YAML = os.path.join(REPO, "configs", "config_files", "p2rnet_train.yaml")

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# TF32 on the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
BF16 = torch.bfloat16
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: time for the host to queue a timing loop
T, V, C = 768, 53, 64
W0 = V * C
WP = stgcn_fused.pad_merged(W0)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(log):
    """[(kernel, registers, stack frame, spill stores, spill loads)] per entry
    function of an ``nvcc -Xptxas -v`` report, in bytes; the kernel's name
    the last component of its mangled (length-prefixed) nested name, with
    its integer template arguments (``fps_kernel<1,16>``)."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym = m.group(1)
            i, name = len(re.match(r"_ZN?", sym).group()), sym
            while n := re.match(r"\d+", sym[i:]):
                i += n.end() + int(n.group())
                name = sym[i - int(n.group()):i]
            if targs := re.match(r"I((?:Li-?\d+E)+)E", sym[i:]):
                name += "<" + ",".join(re.findall(r"Li(-?\d+)E", targs.group(1))) + ">"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return rows


# csrc/latency_probe.cu's dependent chains (the last two: one warp's issue
# interval on eight independent chains), in the order of its output
PROBE_OPS = ("LDS.32", "LDS.128", "FADD", "FMUL", "FMNMX", "IMNMX", "SHFL", "REDUX", "BAR", "FADD x8", "FMNMX x8")
PROBE_ITERS = 64  # x 64 ops a chain
FPS_PER_LANE = 16  # csrc/fps.cu: points a lane


def start_probe_build():
    """Start nvcc on csrc/latency_probe.cu (a measuring tool, not a kernel of
    the path, so not in kernels.SOURCES); returns a function that waits for
    the build and returns the loaded library."""
    path = kernels._lib_path("latency_probe")
    proc = None
    if not os.path.isfile(path):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", tmp,
                                 os.path.join(kernels.CSRC, "latency_probe.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        if proc is not None:
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"latency_probe.cu did not build:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.p2r_latency_chains.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.p2r_sm_clock.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        return lib
    return finish


def fps_latency_floor(probe):
    """FPS's latency floor from this card: {op: cycles} of each dependent
    chain, the SM clock (MHz) nvidia-smi reads while a spinning kernel keeps
    the card busy, the clock64 / %globaltimer rate over one spin, and the
    cycles of one pick's critical path, at the fewest levels any layout
    without a barrier allows (16 points a lane over one warp)."""
    stream = torch.cuda.current_stream().cuda_stream
    cycles = torch.zeros(len(PROBE_OPS), dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    for _ in range(2):  # the second run is read: no cold instruction cache
        kernels.check(probe.p2r_latency_chains(cycles.data_ptr(), sink.data_ptr(), PROBE_ITERS, stream),
                      "latency_probe")
    lat = {op: c / (PROBE_ITERS * 64) for op, c in zip(PROBE_OPS, cycles.tolist())}
    torch.cuda._sleep(20 * SLEEP_CYCLES)  # ~1 s of spin while nvidia-smi reads the clock
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    sm_mhz, max_mhz = (float(v) for v in out.stdout.strip().splitlines()[0].split(","))
    spin = torch.zeros(2, dtype=torch.int64, device="cuda")
    kernels.check(probe.p2r_sm_clock(SLEEP_CYCLES * 2, spin.data_ptr(), stream), "latency_probe clock")
    c, ns = spin.tolist()
    pick = (lat["LDS.128"] + 3 * lat["FADD"] + lat["FMUL"] + lat["FMNMX"]
            + np.log2(FPS_PER_LANE) * lat["IMNMX"] + lat["REDUX"])
    return dict(lat=lat, sm_mhz=sm_mhz, max_mhz=max_mhz, timer_mhz=c / ns * 1e3, pick_cycles=pick)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms: CUDA events around ``iters`` calls
    queued behind a sleeping kernel, so that the device runs them back to
    back and the host's cost of issuing them (the wrappers' checks and
    allocations) is not counted, as it would be at small shapes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    """Least time on f32 CUDA cores: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def tc_bound_ms(nbytes, flops):
    """Least time of f32 products done as three TF32 tensor-core products
    (3xTF32): (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, 3 * flops / PEAK_TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_shares(k_ms, f32_ms, tc_ms, tc_by):
    return (f"f32 CUDA-core bound {f32_ms:.4f} ms (share {f32_ms / k_ms:.3f}), "
            f"3xTF32 tensor-core bound {tc_ms:.4f} ms ({tc_by}; share {tc_ms / k_ms:.3f})")


def epilogue_operands(B, g, dev):
    """Production-shape operands in the fold's layout: pad rows/columns of M
    and pad entries of vecs zero, KB block-diagonal with one 64x64 tap."""
    x = torch.zeros(B, T, WP)
    x[..., :W0] = torch.relu(torch.randn(B, T, W0, generator=g))
    M = torch.zeros(WP, WP)
    M[:W0, :W0] = torch.randn(W0, W0, generator=g) * 0.02
    vecs = torch.zeros(8, WP)
    vecs[0:4, :W0] = torch.randn(4, W0, generator=g) * 0.1
    vecs[0, :W0] += 1.0
    vecs[2, :W0] += 1.0
    taps = torch.randn(3, C, C, generator=g) * 0.1
    KB = torch.einsum("sio,pq->spiqo", taps, torch.eye(2)).reshape(3, 128, 128)
    return [t.to(dev) for t in (x, M, vecs, KB)]


def fps_cloud(B, g):
    """The FPS phase's cloud: the production vote cloud's size (512 points),
    near-origin points that are never candidates, and exact duplicates."""
    xyz = torch.randn(B, 512, 3, generator=g) * 1.5
    xyz[:, 7:40] *= 1e-3  # near the origin: never candidates
    xyz[:, 300:340] = xyz[:, 100:140]  # duplicates: exact ties
    return xyz


def kernel_phase(dev, smi, floor):
    g = torch.Generator().manual_seed(0)
    rows = {}
    errs = {"stgcn_epilogue": 0.0, "fps": 0.0}

    # --- kernel 1: the fused ST-GCN epilogue ---
    for B in (1, 8):
        x, M, vecs, KB = epilogue_operands(B, g, dev)
        t1 = stgcn_fused.graph_matmul_bn_relu(x, M, vecs[0], vecs[1])
        for residual in (True, False):
            xr = x if residual else None
            out = stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual)
            again = stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual)
            ref = stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KB, residual=residual)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            errs["stgcn_epilogue"] = max(errs["stgcn_epilogue"], err)
            check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4),
                  f"epilogue B={B} residual={residual}: max |err| {err}")
            check(bool(torch.all(out[..., W0:] == 0)), f"epilogue B={B} pad columns not 0")
            check(torch.equal(out, again), f"epilogue B={B} residual={residual}: two launches differ")
            nbytes = (3 if residual else 2) * B * T * WP * 4 + 8 * WP * 4 + 3 * 128 * 128 * 4
            flops = 2 * B * T * WP * 3 * C
            f_ms, _ = bound_ms(nbytes, flops)
            b_ms, b_by = tc_bound_ms(nbytes, flops)
            k_ms = device_ms(lambda: stgcn_fused.fused_epilogue(t1, xr, vecs, KB, residual=residual))
            p_ms = device_ms(lambda: stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KB, residual=residual))
            # library yardstick, temporal conv only: cuDNN conv2d over (B, C, T, V), TF32 off
            t_nchw = t1[..., :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
            w = KB[:, :C, :C].permute(2, 1, 0)[..., None].contiguous()  # (out, in, 3, 1)
            l_ms = device_ms(lambda: torch.nn.functional.conv2d(t_nchw, w, padding=(1, 0)))
            rows[("stgcn_epilogue", B, residual)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
            print(f"[{smi}] epilogue B={B} residual={residual}: max|err| {err:.3e}  same bits on relaunch  "
                  f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN conv2d (tconv only) {l_ms:.4f} ms  "
                  f"{bound_shares(k_ms, f_ms, b_ms, b_by)}")
        # the first block: unpadded 3392-wide input contracted against M[:W0]
        xu = x[..., :W0].contiguous()
        out = stgcn_fused.fused_stgcn_layer(xu, M, vecs, KB, residual=False)
        ref = stgcn_fused.stgcn_layer_merged_ref(xu, M, vecs, KB, residual=False)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        errs["stgcn_epilogue"] = max(errs["stgcn_epilogue"], err)
        check(out.shape == (B, T, WP), f"first block output shape {tuple(out.shape)}")
        check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4), f"first block B={B}: max |err| {err}")
        check(bool(torch.all(out[..., W0:] == 0)), "first block pad columns not 0")
        print(f"first block (unpadded {W0}-wide input) B={B}: max|err| {err:.3e}")
        del x, M, vecs, KB, t1, out, ref, again

    # --- kernel 2: furthest-point sampling ---
    lat = floor["lat"]
    print(f"[{smi}] latencies (cycles, dependent chains of {PROBE_ITERS * 64}, one warp; BAR: four warps): "
          + ", ".join(f"{op} {c:.2f}" for op, c in lat.items())
          + f"; SM clock {floor['sm_mhz']:.0f} MHz by nvidia-smi under load (max {floor['max_mhz']:.0f}; "
          f"clock64 / globaltimer {floor['timer_mhz']:.1f}); one pick's floor LDS.128 + 3 FADD + FMUL + FMNMX + "
          f"log2({FPS_PER_LANE}) IMNMX + REDUX = {floor['pick_cycles']:.2f} cycles")
    for B in (1, 8, 32):
        xyz = fps_cloud(B, g).to(dev)
        got = sampling.furthest_point_sample(xyz, 128)
        plain = sampling.fps_ref(xyz, 128)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"FPS B={B}: kernel != plain on the card")
        check(torch.equal(got.cpu(), sampling.fps_ref(xyz.cpu(), 128)), f"FPS B={B}: kernel != plain on the CPU")
        nbytes = B * 512 * 3 * 4 + B * 128 * 4
        flops = 127 * B * 512 * 8  # per pick and point: 3 sub, 3 mul, 2 add
        b_ms, b_by = bound_ms(nbytes, flops)
        k_ms = device_ms(lambda: sampling.furthest_point_sample(xyz, 128))
        p_ms = device_ms(lambda: sampling.fps_ref(xyz, 128), iters=5, warmup=1)
        f_ms = 127 * floor["pick_cycles"] / floor["sm_mhz"] * 1e-3
        rows[("fps", B)] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None, floor_ms=f_ms)
        print(f"[{smi}] FPS B={B} 512->128: indices equal  kernel {k_ms:.4f} ms "
              f"({k_ms * 1e3 * floor['sm_mhz'] / 127:.1f} cycles a pick)  plain {p_ms:.4f} ms  "
              f"latency floor {f_ms:.4f} ms (127 x {floor['pick_cycles']:.2f} cycles at {floor['sm_mhz']:.0f} MHz; "
              f"share {f_ms / k_ms:.3f})  roofline bound {b_ms:.7f} ms ({b_by}; share {b_ms / k_ms:.5f})")
    return rows


def train_kernel_operands(B, g, dev):
    """Kernel 3/4 operands at production shape: y, dy2 (B*T, Wp) and vecs
    (4, Wp) with pad columns zero, KB block-diagonal with one 64x64 tap."""
    y = torch.zeros(B * T, WP)
    y[:, :W0] = torch.randn(B * T, W0, generator=g) * 0.7
    dy2 = torch.zeros(B * T, WP)
    dy2[:, :W0] = torch.randn(B * T, W0, generator=g) * 0.5
    vecs = torch.zeros(4, WP)
    vecs[0, :W0] = 0.5 + torch.rand(W0, generator=g)
    vecs[1, :W0] = torch.randn(W0, generator=g) * 0.3
    vecs[2, :W0] = torch.randn(W0, generator=g) * 0.1
    KB = stgcn_fused.block_diag_taps(torch.randn(3, C, C, generator=g) * 0.15)
    return [t.to(dev) for t in (y, dy2, vecs, KB)]


def tconv_float64(t1, KB):
    """The temporal conv of t1 (B, T, Wp) in float64 and its sum of |a*b|."""
    h, K = t1.double(), KB.double()
    y, mag = 0.0, 0.0
    for s, hs in enumerate((stgcn_fused.shift_prev(h), h, stgcn_fused.shift_next(h))):
        y = y + stgcn_fused.tconv_group(hs, K[s])
        mag = mag + stgcn_fused.tconv_group(hs.abs(), K[s].abs())
    return y, mag


def tap_grad_float64(t1, d):
    """The folded tap gradient sum over rows and joints of shift_s(t1)^T @ d,
    t1 and d (B, T, Wp), in float64, and its sum of |a*b|: (3, C, C) each."""
    dd = d.double()[..., :W0].reshape(-1, C)
    grads, mags = [], []
    for hs in (stgcn_fused.shift_prev(t1.double()), t1.double(), stgcn_fused.shift_next(t1.double())):
        a = hs[..., :W0].reshape(-1, C)
        grads.append(a.t() @ dd)
        mags.append(a.abs().t() @ dd.abs())
    return torch.stack(grads), torch.stack(mags)


def float64_gap(got, exact, mag):
    """Largest error and signed bias of got against float64 over sum |a*b|
    (the tensor cores' truncating adds would show as a bias toward zero)."""
    d = got.double() - exact
    return (d.abs() / mag).max().item(), ((d * torch.sign(exact)).sum() / mag.sum()).item()


def parts_err(parts, ref, magnitudes):
    """Largest column-moment error over each column's scale (the sum of the
    magnitudes of its terms, which bounds a sum's rounding in any order)."""
    scale = torch.stack(magnitudes, dim=1).clamp_min(1e-6)
    return ((parts - ref).abs() / scale).max().item()


def train_kernel_phase(dev, smi):
    g = torch.Generator().manual_seed(1)
    rows = {}
    for B in (1, 8):
        y, dy2, vecs, KB = train_kernel_operands(B, g, dev)
        vecs_b = vecs.clone()
        vecs_b[2] = 0.0
        KBT = KB.transpose(1, 2).contiguous()
        N = B * T
        # library yardstick: cuDNN over (B, C, T, V) with the joint's tap, TF32 off
        t1_nchw = torch.relu(y * vecs[0] + vecs[1])[:, :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
        dy_nchw = dy2[:, :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
        w = KB[:, :C, :C].permute(2, 1, 0)[..., None].contiguous()  # (out, in, 3, 1)

        # --- kernel 3 ---
        y2, parts = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
        again = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T)
        y2_ref, parts_ref = stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T)
        torch.cuda.synchronize()
        err = (y2 - y2_ref).abs().max().item()
        y3 = y2_ref.reshape(B, T, WP)
        perr = parts_err(parts, parts_ref, [y3.abs().sum(1), (y3 * y3).sum(1)])
        check(torch.allclose(y2, y2_ref, atol=1e-4, rtol=1e-4), f"train_fwd B={B}: max |err| {err}")
        check(perr <= 1e-5, f"train_fwd B={B}: column moments off by {perr} of their scale")
        check(bool(torch.all(y2[:, W0:] == 0)) and bool(torch.all(parts[..., W0:] == 0)),
              f"train_fwd B={B} pad columns not 0")
        check(torch.equal(y2, again[0]) and torch.equal(parts, again[1]), f"train_fwd B={B}: two launches differ")
        # 3xTF32 against float64: largest error and signed bias over sum |a*b|
        exact, mag = tconv_float64(torch.relu(y * vecs[0] + vecs[1]).reshape(B, T, WP), KB)
        e_max, e_bias = float64_gap(y2.reshape(B, T, WP)[..., :W0].double() - vecs[2, :W0].double(),
                                    exact[..., :W0], mag[..., :W0])
        check(e_max <= 5e-7 and abs(e_bias) <= 5e-8,
              f"train_fwd B={B}: tconv off float64 by {e_max} of sum|a*b| (bias {e_bias})")
        nbytes = 2 * N * WP * 4 + 4 * WP * 4 + 3 * 128 * 128 * 4 + B * 2 * WP * 4
        f_ms, _ = bound_ms(nbytes, 2 * N * WP * 3 * C)
        b_ms, b_by = tc_bound_ms(nbytes, 2 * N * WP * 3 * C)
        k_ms = device_ms(lambda: stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T))
        p_ms = device_ms(lambda: stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T))
        l_ms = device_ms(lambda: torch.nn.functional.conv2d(t1_nchw, w, padding=(1, 0)))
        rows[("stgcn_train_fwd", B)] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                            bound_by=b_by, library_ms=l_ms)
        print(f"[{smi}] train_fwd B={B}: max|err| {err:.3e}  moments {perr:.2e} of scale  same bits on relaunch  "
              f"vs float64: max {e_max:.2e}, bias {e_bias:.2e} of sum|a*b|  "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN conv2d (tconv only) {l_ms:.4f} ms  "
              f"{bound_shares(k_ms, f_ms, b_ms, b_by)}")

        # --- kernel 4 ---
        del again, exact, mag
        dpre, parts, dtaps = stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=C)
        dpre_ref, parts_ref, dkb_ref = stgcn_train.tconv_bwd_ref(dy2, y, vecs_b, KBT, T=T)
        dtaps_ref = stgcn_train._fold_diag_blocks(dkb_ref, C)
        again = stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=C)
        torch.cuda.synchronize()
        err = (dpre - dpre_ref).abs().max().item()
        d3, yy = dpre_ref.reshape(B, T, WP), y.reshape(B, T, WP)
        perr = parts_err(parts, parts_ref, [d3.abs().sum(1), (d3 * yy).abs().sum(1)])
        terr = (dtaps - dtaps_ref).abs().max().item() / dtaps_ref.abs().max().item()
        check(torch.allclose(dpre, dpre_ref, atol=1e-4, rtol=1e-4), f"train_bwd B={B}: max |err| {err}")
        check(perr <= 1e-5, f"train_bwd B={B}: column moments off by {perr} of their scale")
        check(terr <= 1e-4, f"train_bwd B={B}: dtaps off by {terr} of its max")
        check(bool(torch.all(dpre[:, W0:] == 0)) and bool(torch.all(parts[..., W0:] == 0)),
              f"train_bwd B={B} pad columns not 0")
        check(all(torch.equal(a, b) for a, b in zip((dpre, parts, dtaps), again)),
              f"train_bwd B={B}: two launches differ")
        # 3xTF32 against float64: dt1 where the mask lets it through (dpre is
        # dt1 there) and dtaps, each over its sum |a*b|
        t1 = torch.relu(y * vecs_b[0] + vecs_b[1]).reshape(B, T, WP)
        exact, mag = tconv_float64(dy2.reshape(B, T, WP), KBT.flip(0))
        live = (t1 > 0)[..., :W0]
        dt_max, dt_bias = float64_gap(dpre.reshape(B, T, WP)[..., :W0][live], exact[..., :W0][live],
                                      mag[..., :W0][live])
        g_exact, g_mag = tap_grad_float64(t1, dy2.reshape(B, T, WP))
        g_max, g_bias = float64_gap(dtaps, g_exact, g_mag)
        check(dt_max <= 5e-7 and abs(dt_bias) <= 5e-8,
              f"train_bwd B={B}: dt1 off float64 by {dt_max} of sum|a*b| (bias {dt_bias})")
        check(g_max <= 5e-7 and abs(g_bias) <= 5e-8,
              f"train_bwd B={B}: dtaps off float64 by {g_max} of sum|a*b| (bias {g_bias})")
        del t1, exact, mag, live, g_exact, g_mag
        nbytes = 3 * N * WP * 4 + 4 * WP * 4 + 3 * 128 * 128 * 4 + B * 2 * WP * 4 + 3 * C * C * 4
        f_ms, _ = bound_ms(nbytes, 2 * 2 * N * WP * 3 * C)
        b_ms, b_by = tc_bound_ms(nbytes, 2 * 2 * N * WP * 3 * C)
        k_ms = device_ms(lambda: stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T, C=C))
        p_ms = device_ms(lambda: stgcn_train.tconv_bwd_ref(dy2, y, vecs_b, KBT, T=T), iters=5, warmup=1)

        def library_bwd():
            torch.nn.grad.conv2d_input(t1_nchw.shape, w, dy_nchw, padding=(1, 0))
            torch.nn.grad.conv2d_weight(t1_nchw, w.shape, dy_nchw, padding=(1, 0))

        l_ms = device_ms(library_bwd)
        rows[("stgcn_train_bwd", B)] = dict(max_abs_err=max(err, terr * dtaps_ref.abs().max().item()),
                                            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                            library_ms=l_ms)
        print(f"[{smi}] train_bwd B={B}: max|err| dpre {err:.3e}  moments {perr:.2e} of scale  dtaps {terr:.2e} of max  "
              f"same bits on relaunch  vs float64 (of sum|a*b|): dt1 max {dt_max:.2e} bias {dt_bias:.2e}, "
              f"dtaps max {g_max:.2e} bias {g_bias:.2e}  "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN conv2d_input+conv2d_weight {l_ms:.4f} ms  "
              f"{bound_shares(k_ms, f_ms, b_ms, b_by)}")
        del y, dy2, vecs, KB, KBT, y2, y2_ref, dpre, dpre_ref, dkb_ref, t1_nchw, dy_nchw, again
    return rows


def sparse_operands(B, order, g, dev):
    """Kernel 5 operands at production shape in the fold's layout: a random
    folded matrix on the support of A, permuted by ``order`` and packed into
    its nonzero tiles; x and vecs zero at the pad slot.  Also returns the
    densified permuted matrix, the epilogue's KB, and the pad slot."""
    support = np.zeros((54, 54), bool)
    support[:V, :V] = (build_spatial_graph() != 0).any(0)
    col_off, vlist = stgcn_sparse.sparse_tile_lists(support[:V, :V], order)
    perm = torch.from_numpy(order.astype(np.int64))
    M = torch.randn(54, C, 54, C, generator=g) * 0.02 * torch.from_numpy(support)[:, None, :, None]
    Mp = M[perm][:, :, perm].reshape(WP, WP)
    pad = int(np.where(order == 53)[0][0])
    x = torch.relu(torch.randn(B, T, WP, generator=g))
    vecs = torch.zeros(8, WP)
    vecs[0:4] = torch.randn(4, WP, generator=g) * 0.1
    vecs[0] += 1.0
    vecs[2] += 1.0
    for t in (x, vecs):
        t[..., pad * C:(pad + 1) * C] = 0
    tiles = stgcn_sparse.gather_m_tiles(Mp, col_off, vlist).contiguous()
    KB = stgcn_fused.block_diag_taps(torch.randn(3, C, C, generator=g) * 0.1)
    ops = [t.to(dev) for t in (x, tiles, vecs, torch.from_numpy(col_off), torch.from_numpy(vlist), Mp, KB)]
    return ops + [pad]


def sparse_kernel_phase(dev, smi):
    g = torch.Generator().manual_seed(2)
    rows = {}
    for name, order in (("annealed", SPARSE_JOINT_ORDER), ("natural", np.arange(54, dtype=np.int32))):
        for B in (1, 8):
            x, tiles, vecs, col_off, vlist, Mp, KB, pad = sparse_operands(B, order, g, dev)
            pad_cols = slice(pad * C, (pad + 1) * C)
            out = stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off, vlist)
            again = stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off, vlist)
            ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(x, tiles, vecs, col_off, vlist)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4), f"sparse {name} B={B}: max |err| {err}")
            check(bool(torch.all(out[..., pad_cols] == 0)), f"sparse {name} B={B}: pad slot {pad} not 0")
            check(torch.equal(out, again), f"sparse {name} B={B}: two launches differ")
            # kernel 1 serves the permuted layout: the pad slot stays 0
            ep = stgcn_fused.fused_epilogue(out, x, vecs, KB, residual=True)
            ep_ref = stgcn_fused.epilogue_merged_ref(out, x, vecs, KB, residual=True)
            torch.cuda.synchronize()
            check(torch.allclose(ep, ep_ref, atol=1e-4, rtol=1e-4) and bool(torch.all(ep[..., pad_cols] == 0)),
                  f"epilogue on the permuted layout, {name} B={B}")
            # 3xTF32 against float64: acc = relu(acc) - relu(-acc), both exact with
            # s1 = +-1 and b1 = 0, against x @ M over its sum |a*b|
            unit = torch.zeros_like(vecs)
            unit[0] = 1.0
            acc = stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, unit, col_off, vlist)
            unit[0] = -1.0
            acc -= stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, unit, col_off, vlist)
            xd = x.reshape(B * T, WP).double()
            exact, mag = xd @ Mp.double(), xd.abs() @ Mp.double().abs()
            live = mag > 0
            a_max, a_bias = float64_gap(acc.reshape(B * T, WP)[live], exact[live], mag[live])
            check(a_max <= 5e-7 and abs(a_bias) <= 5e-8,
                  f"sparse {name} B={B}: acc off float64 by {a_max} of sum|a*b| (bias {a_bias})")
            del unit, acc, xd, exact, mag, live
            nnz, N = tiles.shape[0], B * T
            flops = 2 * N * nnz * 128 * 128
            nbytes = 2 * N * WP * 4 + nnz * 128 * 128 * 4 + 8 * WP * 4 + (col_off.numel() + nnz) * 4
            f_ms, _ = bound_ms(nbytes, flops)
            b_ms, b_by = tc_bound_ms(nbytes, flops)
            k_ms = device_ms(lambda: stgcn_sparse.sparse_graph_matmul_bn_relu(x, tiles, vecs, col_off, vlist))
            p_ms = device_ms(lambda: stgcn_sparse.sparse_graph_matmul_bn_relu_ref(x, tiles, vecs, col_off, vlist),
                           iters=5, warmup=1)
            # library yardstick: the dense path, one f32 matmul on the densified matrix + BN1 + ReLU
            l_ms = device_ms(lambda: stgcn_fused.graph_matmul_bn_relu(x, Mp, vecs[0], vecs[1]))
            mm_ms = device_ms(lambda: torch.matmul(x, Mp))
            rows[("stgcn_sparse", name, B)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
            print(f"[{smi}] sparse {name} ({nnz} tiles) B={B}: max|err| {err:.3e}  same bits on relaunch  "
                  f"acc vs float64: max {a_max:.2e}, bias {a_bias:.2e} of sum|a*b|  kernel {k_ms:.4f} ms "
                  f"({flops / k_ms / 1e9:.1f} TFLOP/s)  plain {p_ms:.4f} ms  "
                  f"dense matmul+BN1+ReLU {l_ms:.4f} ms (matmul alone {mm_ms:.4f} ms)  "
                  f"{bound_shares(k_ms, f_ms, b_ms, b_by)}")
            del x, tiles, vecs, Mp, KB, out, again, ref, ep, ep_ref
    return rows


def bf16_bound_ms(nbytes, flops):
    """Least time of bf16 products on the tensor cores: (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bf16_ordinal(t):
    """bf16 tensor -> int64 in value order: adjacent bf16 values differ by 1."""
    u = t.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    return torch.where(u >= 0x8000, -(u & 0x7FFF), u)


def bf16_vs_plain(got, ref, what):
    """Kernel against its plain version, both bf16 (the same sums in another
    order): within 1 ulp where |ref| > 1e-3 of its max, within 2^-7 of the
    max elsewhere.  Returns (max |err|, share of elements that differ)."""
    scale = ref.float().abs().max().item()
    diff = (got.float() - ref.float()).abs()
    live = ref.float().abs() > 1e-3 * scale
    ulps = (bf16_ordinal(got) - bf16_ordinal(ref)).abs()[live].max().item()
    err = diff.max().item()
    check(ulps <= 1 and err <= scale * 2 ** -7, f"{what}: {ulps} ulps from the plain version, max |err| {err}")
    return err, (got != ref).float().mean().item()


def bf16_vs_float64(got, exact, S, what):
    """Kernel (bf16) against the float64 value of the same function on the
    same bf16 operands: within 1 bf16 ulp of round_bf16(exact) where |exact|
    >= 2^-12 S (S: the element's term scale, which bounds the f32 rounding
    before the one cast, ~2^-22 S), within 2^-10 S elsewhere.  Returns (max
    ulps, max |err| / S where not checked in ulps, share checked in ulps)."""
    live = exact.abs() >= 2 ** -12 * S
    ulps = (bf16_ordinal(got) - bf16_ordinal(exact.float().to(BF16))).abs()[live].max().item()
    rel = ((got.double() - exact).abs() / S.clamp_min(1e-30))[~live]
    rel = rel.max().item() if rel.numel() else 0.0
    check(ulps <= 1 and rel <= 2 ** -10, f"{what}: {ulps} bf16 ulps from float64 (elsewhere |err| {rel:.2e} of S)")
    return ulps, rel, live.double().mean().item()


def bf16_kernel_phase(dev, smi):
    g = torch.Generator().manual_seed(4)
    rows = {}
    for B in (1, 8):
        # --- kernel 1, bf16 leg ---
        x, M, vecs, KB = epilogue_operands(B, g, dev)
        xb, Mb, KBb = x.to(BF16), M.to(BF16), KB.to(BF16)
        del x, M, KB
        t1 = stgcn_fused.graph_matmul_bn_relu(xb, Mb, vecs[0], vecs[1])
        y2, mag = tconv_float64(t1, KBb)
        s2, b2 = vecs[2].double(), vecs[3].double()
        for residual in (True, False):
            xr = xb if residual else None
            out = stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual)
            again = stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual)
            ref = stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KBb, residual=residual)
            torch.cuda.synchronize()
            what = f"epilogue bf16 B={B} residual={residual}"
            err, share = bf16_vs_plain(out, ref, what)
            check(bool(torch.all(out[..., W0:] == 0)), f"{what}: pad columns not 0")
            check(torch.equal(out, again), f"{what}: two launches differ")
            exact = y2 * s2 + b2
            S = s2.abs() * mag + b2.abs()
            if residual:
                exact, S = exact + xb.double(), S + xb.double().abs()
            u, rel, cov = bf16_vs_float64(out[..., :W0], torch.relu(exact)[..., :W0], S[..., :W0], what)
            nbytes = (3 if residual else 2) * B * T * WP * 2 + 8 * WP * 4 + 3 * 128 * 128 * 2
            b_ms, b_by = bf16_bound_ms(nbytes, 2 * B * T * WP * 3 * C)
            k_ms = device_ms(lambda: stgcn_fused.fused_epilogue(t1, xr, vecs, KBb, residual=residual))
            p_ms = device_ms(lambda: stgcn_fused.epilogue_merged_ref(t1, xr, vecs, KBb, residual=residual))
            # library yardstick, temporal conv only: cuDNN conv2d in bf16 over (B, C, T, V)
            t_nchw = t1[..., :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
            w = KBb[:, :C, :C].permute(2, 1, 0)[..., None].contiguous()  # (out, in, 3, 1)
            l_ms = device_ms(lambda: torch.nn.functional.conv2d(t_nchw, w, padding=(1, 0)))
            rows[("stgcn_epilogue_bf16", B, residual)] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
            print(f"[{smi}] {what}: vs plain max|err| {err:.3e}, {100 * share:.4f}% of elements differ "
                  f"(the mma.sync legs: 0.0018-0.0059%); "
                  f"vs float64 max {u} ulp ({100 * cov:.2f}% of elements in ulps, elsewhere |err| <= {rel:.2e} S); "
                  f"same bits on relaunch  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                  f"cuDNN bf16 conv2d (tconv only) {l_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; share "
                  f"{b_ms / k_ms:.3f})")
            del out, again, ref, exact, S, t_nchw
        del xb, Mb, KBb, t1, y2, mag

        # --- kernel 5, bf16 leg, annealed order ---
        x, tiles, vecs, col_off, vlist, Mp, KB, pad = sparse_operands(B, SPARSE_JOINT_ORDER, g, dev)
        xb, tb, Mpb = x.to(BF16), tiles.to(BF16), Mp.to(BF16)
        del x, tiles, Mp, KB
        what = f"sparse bf16 annealed B={B}"
        out = stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist)
        again = stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist)
        ref = stgcn_sparse.sparse_graph_matmul_bn_relu_ref(xb, tb, vecs, col_off, vlist)
        torch.cuda.synchronize()
        err, share = bf16_vs_plain(out, ref, what)
        check(bool(torch.all(out[..., pad * C:(pad + 1) * C] == 0)), f"{what}: pad slot {pad} not 0")
        check(torch.equal(out, again), f"{what}: two launches differ")
        xd, Md = xb.reshape(B * T, WP).double(), Mpb.double()
        s1, b1 = vecs[0].double(), vecs[1].double()
        exact = torch.relu((xd @ Md) * s1 + b1)
        S = s1.abs() * (xd.abs() @ Md.abs()) + b1.abs()
        u, rel, cov = bf16_vs_float64(out.reshape(B * T, WP), exact, S, what)
        del xd, Md, exact, S
        nnz, N = tb.shape[0], B * T
        flops = 2 * N * nnz * 128 * 128
        nbytes = 2 * N * WP * 2 + nnz * 128 * 128 * 2 + 8 * WP * 4 + (col_off.numel() + nnz) * 4
        b_ms, b_by = bf16_bound_ms(nbytes, flops)
        k_ms = device_ms(lambda: stgcn_sparse.sparse_graph_matmul_bn_relu(xb, tb, vecs, col_off, vlist))
        p_ms = device_ms(lambda: stgcn_sparse.sparse_graph_matmul_bn_relu_ref(xb, tb, vecs, col_off, vlist),
                         iters=5, warmup=1)
        # library yardsticks: the dense matmul on the densified matrix + BN1 + ReLU, by the
        # f32-upcast route the dense bf16 chain takes, and (timing only) on bf16 operands
        l_ms = device_ms(lambda: stgcn_fused.graph_matmul_bn_relu(xb, Mpb, vecs[0], vecs[1]))
        lb_ms = device_ms(lambda: torch.relu(torch.matmul(xb, Mpb).float() * vecs[0] + vecs[1]).to(BF16))
        rows[("stgcn_sparse_bf16", B)] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        print(f"[{smi}] {what} ({nnz} tiles): vs plain max|err| {err:.3e}, {100 * share:.4f}% of elements differ "
              f"(the mma.sync legs: 0.0018-0.0059%); "
              f"vs float64 max {u} ulp ({100 * cov:.2f}% of elements in ulps, elsewhere |err| <= {rel:.2e} S); "
              f"same bits on relaunch  kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s)  "
              f"plain {p_ms:.4f} ms  dense matmul+BN1+ReLU f32-upcast {l_ms:.4f} ms, bf16 operands "
              f"{lb_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; share {b_ms / k_ms:.3f})")
        del xb, tb, Mpb, out, again, ref
    return rows


def moments_float64(v):
    """Per-(clip, column) [sum(v), sum(v^2)] of v (B, T, Wp) in float64, and
    the sums of the terms' magnitudes."""
    v = v.double()
    return (torch.stack([v.sum(1), (v * v).sum(1)], dim=1),
            torch.stack([v.abs().sum(1), (v * v).sum(1)], dim=1))


def bf16_train_legs_vs_plain(y, dy2, vecs, KB, T_, what):
    """Kernels 3 and 4, bf16 legs, against their plain versions on the card
    (y2 and dpre within 1 bf16 ulp; kernel 4's moments, sums of the unrounded
    dpre, within 1e-5 of each column's scale, its dtaps within 1e-4 of max),
    pad columns 0, two launches the same bits.  Returns the outputs and the
    errors."""
    vecs_b = vecs.clone()
    vecs_b[2] = 0.0
    KBT = KB.transpose(1, 2).contiguous()
    B_ = y.shape[0] // T_
    y2, parts = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T_)
    again = stgcn_train.tconv_stats_fwd(y, vecs, KB, T=T_)
    y2_ref, _ = stgcn_train.tconv_stats_fwd_ref(y, vecs, KB, T=T_)
    dpre, dparts, dtaps = stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T_, C=C)
    dagain = stgcn_train.tconv_bwd(dy2, y, vecs_b, KBT, T=T_, C=C)
    dpre_ref, dparts_ref, dkb_ref = stgcn_train.tconv_bwd_ref(dy2, y, vecs_b, KBT, T=T_)
    dtaps_ref = stgcn_train._fold_diag_blocks(dkb_ref, C)
    torch.cuda.synchronize()
    err3, share3 = bf16_vs_plain(y2, y2_ref, f"train_fwd bf16 {what}")
    err4, share4 = bf16_vs_plain(dpre, dpre_ref, f"train_bwd bf16 {what}")
    # the plain moments of the unrounded dpre: kernel 4's dt1 where the mask passes it
    t1f = torch.relu(y.float() * vecs_b[0] + vecs_b[1]).reshape(B_, T_, WP)
    dt1 = stgcn_fused.tconv_group(stgcn_fused.shift_next(dy2.reshape(B_, T_, WP)), KBT[0]) + \
        stgcn_fused.tconv_group(dy2.reshape(B_, T_, WP), KBT[1]) + \
        stgcn_fused.tconv_group(stgcn_fused.shift_prev(dy2.reshape(B_, T_, WP)), KBT[2])
    d3 = torch.where(t1f > 0, dt1, torch.zeros_like(dt1))
    y3 = y.float().reshape(B_, T_, WP)
    perr = parts_err(dparts, dparts_ref, [d3.abs().sum(1), (d3 * y3).abs().sum(1)])
    terr = (dtaps - dtaps_ref).abs().max().item() / dtaps_ref.abs().max().item()
    check(perr <= 1e-5, f"train_bwd bf16 {what}: column moments off by {perr} of their scale")
    check(terr <= 1e-4, f"train_bwd bf16 {what}: dtaps off by {terr} of its max")
    for name, out in (("train_fwd", y2), ("train_bwd", dpre)):
        check(bool(torch.all(out[:, W0:] == 0)), f"{name} bf16 {what}: pad columns not 0")
    check(torch.equal(y2, again[0]) and torch.equal(parts, again[1]), f"train_fwd bf16 {what}: two launches differ")
    check(all(torch.equal(a, b) for a, b in zip((dpre, dparts, dtaps), dagain)),
          f"train_bwd bf16 {what}: two launches differ")
    return dict(y2=y2, parts=parts, dpre=dpre, dparts=dparts, dtaps=dtaps, vecs_b=vecs_b, KBT=KBT,
                err3=err3, share3=share3, err4=max(err4, terr * dtaps_ref.abs().max().item()), share4=share4,
                perr4=perr, terr4=terr)


# the share of bf16 elements one ulp from the plain version for the earlier
# bf16 legs of kernels 3 and 4 (single-buffered, in two warp roles), at B = 1
# / 8, measured by this script on an NVIDIA H100 80GB HBM3; the legs now
# shipped keep their sums, so their bits and shares are the same
EARLIER_TRAIN_SHARES = {"train_fwd": "0.0047% / 0.0043%", "train_bwd": "0.0039% / 0.0036%"}


def bf16_train_kernel_phase(dev, smi):
    """The bf16 legs of kernels 3 and 4 at B in {1, 8} (and T = 50, which
    16 does not divide, at B = 2): against their plain versions and
    against float64 on the same bf16 operands; timed beside their bounds
    and cuDNN's bf16 convolutions."""
    g = torch.Generator().manual_seed(5)
    y, dy2, vecs, KB = train_kernel_operands(2, g, dev)
    T50 = 50
    r = bf16_train_legs_vs_plain(y[: 2 * T50].to(BF16), dy2[: 2 * T50].to(BF16), vecs, KB.to(BF16), T50, "T=50")
    print(f"[{smi}] train_fwd / train_bwd bf16 B=2 T=50: vs plain max|err| {r['err3']:.3e} / {r['err4']:.3e}, "
          f"{100 * r['share3']:.4f}% / {100 * r['share4']:.4f}% of elements differ; same bits on relaunch")
    del y, dy2, vecs, KB, r
    rows = {}
    for B in (1, 8):
        y, dy2, vecs, KB = train_kernel_operands(B, g, dev)
        yb, dy2b, KBb = y.to(BF16), dy2.to(BF16), KB.to(BF16)
        del y, dy2, KB
        N = B * T
        r = bf16_train_legs_vs_plain(yb, dy2b, vecs, KBb, T, f"B={B}")

        # --- kernel 3 against float64: the conv of the bf16 t1 (the same
        # f32 ops and one rounding, so the same bits) with the bf16 taps ---
        t1 = torch.relu(yb.float() * vecs[0] + vecs[1]).to(BF16).reshape(B, T, WP)
        exact, mag = tconv_float64(t1, KBb)
        cb = vecs[2].double()
        what = f"train_fwd bf16 B={B}"
        u, rel, cov = bf16_vs_float64(r["y2"].reshape(B, T, WP)[..., :W0], (exact + cb)[..., :W0],
                                      (mag + cb.abs())[..., :W0], what)
        m_exact, m_mag = moments_float64(r["y2"].reshape(B, T, WP))
        m_max, m_bias = float64_gap(r["parts"], m_exact, m_mag.clamp_min(1e-30))
        check(m_max <= 5e-7 and abs(m_bias) <= 5e-8,
              f"{what}: moments off float64 by {m_max} of sum|terms| (bias {m_bias})")
        del exact, mag, m_exact, m_mag
        nbytes = 2 * N * WP * 2 + 4 * WP * 4 + 3 * 128 * 128 * 2 + B * 2 * WP * 4
        b_ms, b_by = bf16_bound_ms(nbytes, 2 * N * WP * 3 * C)
        k_ms = device_ms(lambda: stgcn_train.tconv_stats_fwd(yb, vecs, KBb, T=T))
        p_ms = device_ms(lambda: stgcn_train.tconv_stats_fwd_ref(yb, vecs, KBb, T=T))
        t_nchw = t1[..., :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
        w = KBb[:, :C, :C].permute(2, 1, 0)[..., None].contiguous()  # (out, in, 3, 1)
        l_ms = device_ms(lambda: torch.nn.functional.conv2d(t_nchw, w, padding=(1, 0)))
        rows[("stgcn_train_fwd_bf16", B)] = dict(max_abs_err=r["err3"], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                 bound_by=b_by, library_ms=l_ms)
        print(f"[{smi}] {what}: vs plain max|err| {r['err3']:.3e}, {100 * r['share3']:.4f}% of elements differ "
              f"(the earlier leg at B=1 / 8: {EARLIER_TRAIN_SHARES['train_fwd']}); vs float64 max {u} ulp "
              f"({100 * cov:.2f}% of elements in ulps, elsewhere |err| <= {rel:.2e} S), "
              f"moments max {m_max:.2e} bias {m_bias:.2e} of sum|terms|; same bits on relaunch  "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN bf16 conv2d (tconv only) {l_ms:.4f} ms "
              f"(kernel / cuDNN {k_ms / l_ms:.3f})  bound {b_ms:.4f} ms ({b_by}; share {b_ms / k_ms:.3f})")

        # --- kernel 4 against float64: dt1 of the bf16 dy2 and taps where
        # the mask passes it, the moments of the unrounded dpre, and the tap
        # gradient of the bf16 t1 and dy2 ---
        what = f"train_bwd bf16 B={B}"
        vecs_b, KBT = r["vecs_b"], r["KBT"]
        pre = yb.float() * vecs_b[0] + vecs_b[1]
        live = (pre > 0).reshape(B, T, WP)
        t1 = torch.relu(pre).to(BF16).reshape(B, T, WP)
        del pre
        exact, mag = tconv_float64(dy2b.reshape(B, T, WP), KBT.flip(0))
        exact, mag = exact * live, mag * live
        lw = live[..., :W0]
        u4, rel4, cov4 = bf16_vs_float64(r["dpre"].reshape(B, T, WP)[..., :W0][lw], exact[..., :W0][lw],
                                         mag[..., :W0][lw], what)
        m_exact = torch.stack([exact.sum(1), (exact * yb.double().reshape(B, T, WP)).sum(1)], dim=1)
        m_mag = torch.stack([mag.sum(1), (mag * yb.double().abs().reshape(B, T, WP)).sum(1)], dim=1)
        dm_max, dm_bias = float64_gap(r["dparts"][..., :W0], m_exact[..., :W0], m_mag[..., :W0].clamp_min(1e-30))
        del exact, mag, live, lw, m_exact, m_mag
        g_exact, g_mag = tap_grad_float64(t1, dy2b.reshape(B, T, WP))
        g_max, g_bias = float64_gap(r["dtaps"], g_exact, g_mag)
        check(dm_max <= 5e-7 and abs(dm_bias) <= 5e-8,
              f"{what}: moments off float64 by {dm_max} of sum|terms| (bias {dm_bias})")
        check(g_max <= 5e-7 and abs(g_bias) <= 5e-8,
              f"{what}: dtaps off float64 by {g_max} of sum|a*b| (bias {g_bias})")
        del g_exact, g_mag
        nbytes = 3 * N * WP * 2 + 4 * WP * 4 + 3 * 128 * 128 * 2 + B * 2 * WP * 4 + 3 * C * C * 4
        b_ms, b_by = bf16_bound_ms(nbytes, 2 * 2 * N * WP * 3 * C)
        k_ms = device_ms(lambda: stgcn_train.tconv_bwd(dy2b, yb, vecs_b, KBT, T=T, C=C))
        p_ms = device_ms(lambda: stgcn_train.tconv_bwd_ref(dy2b, yb, vecs_b, KBT, T=T), iters=5, warmup=1)
        t_nchw = t1[..., :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()
        dy_nchw = dy2b[:, :W0].reshape(B, T, V, C).permute(0, 3, 1, 2).contiguous()

        def library_bwd():
            torch.nn.grad.conv2d_input(t_nchw.shape, w, dy_nchw, padding=(1, 0))
            torch.nn.grad.conv2d_weight(t_nchw, w.shape, dy_nchw, padding=(1, 0))

        l_ms = device_ms(library_bwd)
        rows[("stgcn_train_bwd_bf16", B)] = dict(max_abs_err=r["err4"], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                                 bound_by=b_by, library_ms=l_ms)
        print(f"[{smi}] {what}: vs plain max|err| dpre {r['err4']:.3e}, {100 * r['share4']:.4f}% of elements "
              f"differ (the earlier leg at B=1 / 8: {EARLIER_TRAIN_SHARES['train_bwd']}), moments "
              f"{r['perr4']:.2e} of scale, dtaps {r['terr4']:.2e} of max; vs float64 dpre max {u4} "
              f"ulp ({100 * cov4:.2f}% of the live elements in ulps, elsewhere |err| <= {rel4:.2e} S), moments max "
              f"{dm_max:.2e} bias {dm_bias:.2e}, dtaps max {g_max:.2e} bias {g_bias:.2e} of sum|a*b|; same bits on "
              f"relaunch  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN bf16 conv2d_input+conv2d_weight "
              f"{l_ms:.4f} ms (kernel / cuDNN {k_ms / l_ms:.3f})  bound {b_ms:.4f} ms ({b_by}; share "
              f"{b_ms / k_ms:.3f})")
        del yb, dy2b, KBb, vecs, r, t1, t_nchw, dy_nchw, w
    return rows


def rotated_clip(joints, angle):
    """Rotate a (F, 53, 3) clip about +Y by ``angle``."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], dtype=np.float32)
    return (joints @ R.T).astype(np.float32)


def generate_gap(a, b, what):
    """Largest |a - b| of each float output; raises if an index differs or a
    gap exceeds its band (seed features 2e-4, the rest 5e-4)."""
    for key in ("seed_inds", "aggregated_vote_inds"):
        check(torch.equal(a[key].cpu(), b[key].cpu()), f"{what}: {key} differ")
    diffs = {k: (a[k].cpu() - b[k].cpu()).abs().max().item()
             for k in ("center", "size", "heading", "objectness_scores", "sem_cls_scores", "seed_features")}
    diffs.update({f"pi/{k}": (a["pi"][k].cpu() - b["pi"][k].cpu()).abs().max().item()
                  for k in ("center", "size", "heading")})
    for key, d in diffs.items():
        tol = 2e-4 if key == "seed_features" else 5e-4
        check(d <= tol, f"{what}: {key} differs by {d} (tolerance {tol})")
    return diffs


def serving_phase(workdir, smi):
    raw = np.load(DEMO_CLIP)
    angles = np.random.RandomState(0).uniform(0, 2 * np.pi, 3)
    demo_dir = os.path.join(workdir, "demo")
    os.makedirs(os.path.join(demo_dir, "inputs"))
    np.save(os.path.join(demo_dir, "inputs", "input_joints_1.npy"), raw)
    for i, a in enumerate(angles):
        np.save(os.path.join(demo_dir, "inputs", f"input_joints_1_rot{i}.npy"), rotated_clip(raw, a))

    config = read_to_dict(TEST_YAML)
    config.update(finetune=False, seed=42, demo_path=demo_dir)
    config["log"]["path"] = os.path.join(workdir, "out")
    cfg = CONFIG(config, mode="demo")
    try:
        kernels.reset_launch_counts()
        results = demo.run(cfg)
        launches = dict(kernels.LAUNCHES)
        n = len(results)
        check(n == 4, f"served {n} requests, expected 4")
        check(launches.get("stgcn_epilogue", 0) == 6 * n,
              f"epilogue launches {launches.get('stgcn_epilogue', 0)} != 6 per request x {n}")
        check(launches.get("fps", 0) == n, f"FPS launches {launches.get('fps', 0)} != 1 per request x {n}")
        for path, dump_dir, n_boxes, _ in results:
            for f in ("skeleton_points.ply", "000000_pi_dict.json"):
                check(os.path.isfile(os.path.join(dump_dir, f)), f"{path}: {f} not written")
            print(f"served {os.path.basename(path)}: {n_boxes} confident boxes")
        print(f"main path launch counts over {n} requests: {launches}")

        # the card's generate against the same model on the CPU (plain versions)
        clip = load_demo_clip(DEMO_CLIP, num_frames=768)[None]
        gpu_model = common.build_model(cfg, device="cuda")
        cpu_model = common.build_model(cfg, device="cpu")
        folded = gpu_model.fold_eval()
        x_gpu = torch.from_numpy(clip).cuda()
        ep_gpu = gpu_model.generate(x_gpu, folded=folded)
        ep_cpu = cpu_model.generate(torch.from_numpy(clip), folded=cpu_model.fold_eval())
        print("card vs CPU max |diff|: " + json.dumps(generate_gap(ep_gpu, ep_cpu, "card vs CPU")))
        for key in ("center", "size", "heading", "sem_cls_scores"):
            check(bool(torch.isfinite(ep_gpu[key]).all()), f"{key} not finite")
        check(ep_gpu["center"].shape == (1, 128, 3) and ep_gpu["pi"]["center"].shape == (1, 128, 100),
              "generate output shapes")

        request_s = [r[3] for r in results[1:]]
        gen1_ms = [cuda_ms(lambda: gpu_model.generate(x_gpu, folded=folded), iters=10) for _ in range(3)]
        batch = np.stack([
            load_demo_clip(DEMO_CLIP, num_frames=768) if i == 0 else
            rotated_clip(load_demo_clip(DEMO_CLIP, num_frames=768), a)
            for i, a in enumerate(np.random.RandomState(1).uniform(0, 2 * np.pi, 32))
        ])
        x32 = torch.from_numpy(batch).cuda()
        torch.cuda.reset_peak_memory_stats()
        gen32_ms = cuda_ms(lambda: gpu_model.generate(x32, folded=folded), iters=5, warmup=2)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        print(f"[{smi}] batch-1 request latency (load+generate+parse+NMS+dumps, host clock), "
              f"requests 2-4: {', '.join(f'{s * 1e3:.3f}' for s in request_s)} ms")
        print(f"[{smi}] batch-1 generate {min(gen1_ms):.3f} ms (CUDA events, best of 3 means of 10)")
        print(f"[{smi}] B=32 generate {gen32_ms:.3f} ms -> {32e3 / gen32_ms:.1f} clips/s; "
              f"peak memory {peak_gib:.2f} GiB")
        return launches
    finally:
        cfg.close()


def bf16_generate_gap(a, b, what):
    """bf16 generate a (card) against b (CPU): seed indices equal; seed
    features and votes, which come before FPS, within 1e-2 of their max.
    Another sum order flips a few bf16 roundings, and FPS and the 0.3 ball
    query over the bf16-rounded votes meet near ties: a proposal may be
    picked on one side only (the agreement is returned), and a vote at the
    ball's edge may enter one side's ball and change that proposal's pooled
    feature.  So each proposal output is compared row by row over the
    proposals both pick: the median row within 2e-2 of the output's max, at
    most a tenth of the rows beyond 0.05 of it (the JAX package's bf16
    band, tests/test_stgcn_sparse.py:191).  Returns (agreement, gaps)."""
    check(torch.equal(a["seed_inds"].cpu(), b["seed_inds"].cpu()), f"{what}: seed_inds differ")
    gaps = {}
    for key in ("seed_features", "vote_xyz", "vote_features"):
        ref = b[key].cpu().float()
        gaps[key] = (a[key].cpu().float() - ref).abs().max().item() / ref.abs().max().item()
        check(gaps[key] <= 1e-2, f"{what}: {key} differs by {gaps[key]} of its max")
    ia, ib = a["aggregated_vote_inds"].cpu().numpy(), b["aggregated_vote_inds"].cpu().numpy()
    outs = {k: (a[k], b[k]) for k in ("center", "size", "heading", "objectness_scores", "sem_cls_scores")}
    outs.update({f"pi/{k}": (a["pi"][k], b["pi"][k]) for k in ("center", "size", "heading")})
    rows = {k: [] for k in outs}
    same = 0
    for i in range(ia.shape[0]):
        common, pa, pb = np.intersect1d(ia[i], ib[i], return_indices=True)
        same += len(common)
        for k, (ta, tb) in outs.items():
            ref = tb[i].cpu().float()
            d = (ta[i].cpu().float()[pa] - ref[pb]).abs().reshape(len(common), -1).amax(dim=1)
            rows[k].append(d / ref.abs().max())
    for k, r in rows.items():
        r = torch.cat(r)
        median, far = r.median().item(), (r > 0.05).double().mean().item()
        gaps[k] = {"max": r.max().item(), "median": median, "rows_beyond_0.05": far}
        check(median <= 2e-2 and far <= 0.1,
              f"{what}: {k} on the common proposals: median row {median} of its max, {far} of rows beyond 0.05")
    return same / ia.size, gaps


def bf16_serving_phase(workdir, smi):
    """The demo runner in bf16 at full width; card vs CPU bf16 generate; the
    bf16 chain's latency and throughput beside the f32 chain's, in turns."""
    raw = np.load(DEMO_CLIP)
    demo_dir = os.path.join(workdir, "demo_bf16")
    os.makedirs(os.path.join(demo_dir, "inputs"))
    np.save(os.path.join(demo_dir, "inputs", "input_joints_1.npy"), raw)
    for i, a in enumerate(np.random.RandomState(0).uniform(0, 2 * np.pi, 3)):
        np.save(os.path.join(demo_dir, "inputs", f"input_joints_1_rot{i}.npy"), rotated_clip(raw, a))
    configs = {}
    for dtype in ("bfloat16", "float32"):
        config = read_to_dict(TEST_YAML)
        config.update(finetune=False, seed=42, demo_path=demo_dir)
        config["model"]["compute_dtype"] = dtype
        config["log"]["path"] = os.path.join(workdir, f"out_{dtype}")
        configs[dtype] = config
    cfg = CONFIG(configs["bfloat16"], mode="demo")
    try:
        kernels.reset_launch_counts()
        results = demo.run(cfg)
        launches = dict(kernels.LAUNCHES)
        n = len(results)
        expect = {"stgcn_epilogue_bf16": 6 * n, "fps": n}
        check(n == 4 and launches == expect, f"bf16 serving: {n} requests, launch counts {launches} != {expect}")
        for path, dump_dir, n_boxes, _ in results:
            check(os.path.isfile(os.path.join(dump_dir, "000000_pi_dict.json")), f"{path}: dumps not written")
        print(f"bf16 serving: main path launch counts over {n} requests: {launches}")

        clip = load_demo_clip(DEMO_CLIP, num_frames=768)[None]
        gpu = common.build_model(cfg, device="cuda")
        cpu = common.build_model(cfg, device="cpu")
        folded = gpu.fold_eval()
        x_gpu = torch.from_numpy(clip).cuda()
        ep_gpu = gpu.generate(x_gpu, folded=folded)
        ep_cpu = cpu.generate(torch.from_numpy(clip), folded=cpu.fold_eval())
        agree, gaps = bf16_generate_gap(ep_gpu, ep_cpu, "bf16 card vs CPU")
        print(f"bf16 card vs CPU generate: proposals agree {agree:.4f}; max |diff| / max: " + json.dumps(gaps))
        check(ep_gpu["sem_cls_scores"].dtype == BF16 and ep_gpu["center"].shape == (1, 128, 3),
              "bf16 generate output dtypes / shapes")
        for key in ("center", "size", "heading", "sem_cls_scores"):
            check(bool(torch.isfinite(ep_gpu[key].float()).all()), f"bf16 {key} not finite")
        del cpu
    finally:
        cfg.close()

    f32_cfg = CONFIG(configs["float32"], mode="demo")
    try:
        f32_model = common.build_model(f32_cfg, device="cuda")
    finally:
        f32_cfg.close()
    chains = {"bf16": (gpu, folded), "f32": (f32_model, f32_model.fold_eval())}
    batch = np.stack([rotated_clip(clip[0], a) for a in np.random.RandomState(1).uniform(0, 2 * np.pi, 32)])
    x32 = torch.from_numpy(batch).cuda()
    times = {"bf16": [], "f32": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        model, fold = chains[name]
        times[name].append((cuda_ms(lambda: model.generate(x_gpu, folded=fold), iters=10),
                            cuda_ms(lambda: model.generate(x32, folded=fold), iters=3, warmup=1)))
    request_s = [r[3] for r in results[1:]]
    print(f"[{smi}] bf16 batch-1 request latency (load+generate+parse+NMS+dumps, host clock), "
          f"requests 2-4: {', '.join(f'{t * 1e3:.3f}' for t in request_s)} ms")
    for name, runs in times.items():
        print(f"[{smi}] {name} chain generate (CUDA events, in turns f32/bf16/bf16/f32): batch 1 "
              f"{' / '.join(f'{b1:.3f}' for b1, _ in runs)} ms (means of 10); B=32 "
              f"{' / '.join(f'{b32:.3f}' for _, b32 in runs)} ms (means of 3) -> "
              f"{32e3 / min(b32 for _, b32 in runs):.1f} clips/s")
    device_profile(lambda i: gpu.generate(x32, folded=folded), 2, "B=32 bf16 generate",
                   min(b32 for _, b32 in times["bf16"]), smi)
    return launches


def scene_datasets(seed, n_train, n_val):
    """In-memory synthetic scenes through the loader's item path (no h5py):
    {"train": augmented, "val": not}."""
    rng = np.random.RandomState(seed)
    scenes = [synth.as_stored(*synth.make_scene(rng, n_objects=int(rng.randint(2, 6)), n_frames=900))
              for _ in range(n_train + n_val)]
    return {"train": SceneDataset(scenes[:n_train], num_frames=T, augment=True),
            "val": SceneDataset(scenes[n_train:], num_frames=T, augment=False)}


def train_config(workdir):
    config = read_to_dict(TRAIN_YAML)
    config.update(seed=42, resume=False, finetune=False)
    config["train"].update(epochs=1, batch_size=8)
    config["val"]["batch_size"] = 8
    config["log"].update(path=os.path.join(workdir, "out"), print_step=1)
    return config


def relative_gap(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def card_vs_cpu_step(cfg, datasets):
    """One train step at B=2, full width, on the card and on the CPU: same
    weights, batch and MDN noise; a float64 run on the CPU is the referee
    for the gradients.

    The f32 gradient of the backbone is ill-conditioned (the BN backward
    through six blocks cancels): rounding alone moves some tensors'
    gradients by ~1e-2 of their max, on either device and on different
    tensors each time.  So each card gradient must be within 1e-3 of its max
    of the CPU's, or no further from the float64 gradient than three times
    the worst error of the CPU's f32 gradient (ROADMAP "Faults found")."""
    model_cfg = P2RNetConfig.from_cfg(cfg)
    items = [datasets["val"].__getitem__(i, rng=np.random.RandomState(i)) for i in range(2)]
    batch = collate(items)
    results = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        model = P2RNet(model_cfg, device=dev, generator=torch.Generator().manual_seed(42)).to(dtype)
        optimizer, _, _ = make_optimizer(model, cfg.config["optimizer"])
        eps = {k: v.to(dtype) for k, v in model.mdn_eps(2, torch.Generator().manual_seed(7)).items()}
        inputs = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch_to_device(batch, dev).items()}
        losses, ep = train_step(model, optimizer, inputs, eps=eps)
        results.append((
            {k: float(v) for k, v in losses.items()},
            {k: ep[k].cpu() for k in ("seed_inds", "aggregated_vote_inds")},
            {k: p.grad.cpu().double() for k, p in model.named_parameters()},
            {k: b.cpu() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))},
        ))
    (l_g, i_g, g_g, s_g), (l_c, i_c, g_c, s_c), (_, i_64, g_64, _) = results
    for k in i_c:
        check(torch.equal(i_g[k], i_c[k]), f"card vs CPU train step: {k} differ")
        check(torch.equal(i_64[k], i_c[k]), f"CPU float64 referee: {k} differ from float32")
    loss_gap = {k: abs(l_g[k] - l_c[k]) / max(abs(l_c[k]), 1e-7) for k in l_c}
    grad_gap = {k: relative_gap(g_g[k], g_c[k]) for k in g_c}
    card_err = {k: relative_gap(g_g[k], g_64[k]) for k in g_64}
    cpu_err = {k: relative_gap(g_c[k], g_64[k]) for k in g_64}
    stat_gap = {k: (s_g[k] - s_c[k]).abs().max().item() for k in s_c}
    worst = sorted(grad_gap, key=lambda k: -grad_gap[k])[:5]
    print("card vs CPU train step (B=2): loss terms max rel gap "
          f"{max(loss_gap.values()):.2e}; running stats max |gap| {max(stat_gap.values()):.2e}; "
          f"{sum(v <= 1e-3 for v in grad_gap.values())} of {len(grad_gap)} gradients within 1e-3 of max|g|")
    print("  worst gradients, gap / max|g|: card vs CPU f32 | card vs CPU f64 | CPU f32 vs CPU f64")
    for k in worst:
        print(f"  {k}: {grad_gap[k]:.2e} | {card_err[k]:.2e} | {cpu_err[k]:.2e}")
    for k, v in loss_gap.items():
        check(v <= 1e-4, f"card vs CPU: loss {k} differs by {v} relative")
    cpu_worst = max(cpu_err.values())
    print(f"  worst error against float64: card {max(card_err.values()):.2e}, CPU f32 {cpu_worst:.2e}")
    for k, v in grad_gap.items():
        check(v <= 1e-3 or card_err[k] <= 3 * cpu_worst,
              f"card vs CPU: gradient {k} differs by {v} of its max, and the card is "
              f"{card_err[k]} from float64 against the CPU's worst {cpu_worst}")
    for k in s_c:
        check(torch.allclose(s_g[k], s_c[k], atol=1e-4, rtol=1e-4), f"card vs CPU: running stat {k}")
    conv_bias = [k for k in g_g if k.endswith("tcn.2.bias")]
    check(all(bool(torch.all(g_g[k] == 0)) for k in conv_bias), "fused chain: conv bias gradient not 0")


def time_train_step(cfg, datasets, smi):
    """B=8 train step: CUDA-event median of 5 after 2 warm-ups, peak memory,
    then a torch.profiler top-10 of device ops over 3 steps."""
    model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cuda", generator=torch.Generator().manual_seed(42))
    optimizer, _, _ = make_optimizer(model, cfg.config["optimizer"])
    items = [datasets["train"].__getitem__(i, rng=np.random.RandomState(i)) for i in range(8)]
    batch = batch_to_device(collate(items), "cuda")

    def step(i):
        return train_step(model, optimizer, batch, generator=torch.Generator().manual_seed(i))

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(2 + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{smi}] B=8 train step {step_ms:.3f} ms (CUDA events, median of 5: "
          f"{', '.join(f'{t:.3f}' for t in times)}) -> {8e3 / step_ms:.2f} samples/s; "
          f"peak memory {peak_gib:.2f} GiB")

    device_profile(lambda i: step(10 + i), 3, "B=8 train step", step_ms, smi)
    return step_ms, peak_gib


# the hand-written kernels, by the names the profiler gives them
OWN_KERNELS = ("epilogue_kernel", "fps_kernel", "train_fwd_kernel", "train_bwd_kernel", "sparse_kernel")


def device_profile(run, n, what, run_ms, smi, top=10):
    """torch.profiler over ``n`` calls of run(i): device kernel time per call,
    its share of ``run_ms``, the top kernels and every hand-written kernel
    with its rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    total_us = sum(dev_us(e) for e in events)
    ranked = sorted(events, key=lambda e: -dev_us(e))
    print(f"[{smi}] profiler, {n} x {what}: device kernels {total_us / n / 1e3:.3f} ms per call, "
          f"busy share {total_us / n / 1e3 / run_ms:.3f} of the {run_ms:.3f} ms call; "
          f"top {top} kernels by device time per call, then the hand-written ones:")
    for rank, e in enumerate(ranked, 1):
        if rank <= top or any(k in e.key for k in OWN_KERNELS):
            print(f"  #{rank:<3d} {dev_us(e) / n / 1e3:9.3f} ms  {100 * dev_us(e) / total_us:5.1f}%  "
                  f"x{e.count / n:<5.1f} {e.key[:110]}")


def train_phase(workdir, smi):
    config = train_config(workdir)
    cfg = CONFIG(config, mode="train")
    try:
        mount_external_config(cfg)
        datasets = scene_datasets(seed=3, n_train=16, n_val=8)
        initial = P2RNet(P2RNetConfig.from_cfg(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(42)).state_dict()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, history = train_runner.run(cfg, datasets=datasets)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        print(f"train run (1 epoch: 2 train steps of 8, 1 val step of 8) {time.perf_counter() - t0:.1f} s; "
              f"launch counts {launches}")
        expect = {"stgcn_train_fwd": 6 * 2, "stgcn_train_bwd": 6 * 2, "stgcn_epilogue": 6 * 1, "fps": 2 + 1}
        check(launches == expect, f"train run launch counts {launches} != {expect} "
              "(6 train_fwd + 6 train_bwd + 1 fps per train step, 6 epilogue + 1 fps per val step)")
        for phase in ("train", "val"):
            means = history[0][phase]
            check(all(np.isfinite(v) for v in means.values()), f"{phase} losses not finite: {means}")
            print(f"mean {phase} losses: " + json.dumps({k: round(v, 5) for k, v in means.items()}))
        final = model.state_dict()
        moved = [k for k in initial if not torch.equal(initial[k], final[k].cpu())]
        stats = [k for k in initial if k.endswith(("running_mean", "running_var"))]
        weights = [k for k, _ in model.named_parameters()]
        check(all(k in moved for k in stats), "some BN running statistics did not move")
        check(sum(k in moved for k in weights) >= len(weights) - 6,
              "weights did not move")  # the six conv biases have an exactly zero gradient
        ckpt = os.path.join(cfg.save_path, "model_final.pth")
        check(os.path.isfile(ckpt), "model_final.pth not written")
        demo_cfg = CONFIG(dict(config, finetune=True, weight=[ckpt], seed=0,
                               log={"path": os.path.join(workdir, "demo_out")}), mode="demo")
        try:
            served = common.setup(demo_cfg, device="cuda")[0]
        finally:
            demo_cfg.close()
        check(all(torch.equal(served.state_dict()[k], v) for k, v in final.items()),
              "demo setup did not load model_final.pth")
        print(f"checkpoint {os.path.basename(ckpt)} written and loaded by the demo runner; "
              f"{len(moved)} of {len(initial)} state tensors moved")
        del model, served

        card_vs_cpu_step(cfg, datasets)
        step_ms, peak_gib = time_train_step(cfg, datasets, smi)
        return launches, step_ms, peak_gib
    finally:
        cfg.close()


# the options phase's BN-momentum schedule: 0.5 in epoch 1, 0.25 in epoch 2
# (torch convention), while the lr drops tenfold at the same boundary
OPTION_BNS = {"bn_momentum_init": 0.5, "bn_decay_rate": 0.5, "bn_decay_step": 1, "bn_momentum_max": 0.001}
# loader workers of R4 and of the loader comparison: process-mode workers
# start one after another, ~11 s each on the card's host, since each takes
# a pickled copy of the in-memory scenes through the pool's start-up pipe
OPTION_WORKERS = 2
# the hand-written kernels of a train step, by the names the profiler gives them
TRAIN_KERNELS = ("train_fwd_kernel", "train_bwd_kernel", "fps_kernel")


def options_config(workdir, name, epochs, **extra):
    """p2rnet_train.yaml at full width, global batch 8, with weight decay,
    clipping, a milestone at epoch 1 and the BN-momentum schedule; each run
    keeps its run dirs under <workdir>/<name>."""
    config = train_config(workdir)
    config["train"]["epochs"] = epochs
    config["optimizer"].update(weight_decay=0.01, clip_norm=1.0)
    config["scheduler"]["milestones"] = [1]
    config["bnscheduler"] = dict(OPTION_BNS)
    config["log"].update(path=os.path.join(workdir, name), save_weight_step=1)
    config.update(extra)
    return config


def options_run(config, datasets, workdir, name):
    """One train run from its own working directory (the TensorBoard board
    writes to ./runs).  Launch counts from 0 just before the run, read just
    after; each train step must launch 6 train_fwd + 6 train_bwd + 1 fps,
    each val step 6 epilogue + 1 fps.  Returns (model, history, run dir,
    log text, launches)."""
    cwd = os.path.join(workdir, f"{name}_cwd")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    cfg = CONFIG(config, mode="train")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, history = train_runner.run(cfg, datasets=datasets)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        seconds = time.perf_counter() - t0
    finally:
        cfg.close()
        os.chdir(workdir)
    with open(os.path.join(cfg.save_path, "log.txt")) as f:
        log = f.read()
    epochs = len(history)
    expect = {"stgcn_train_fwd": 6 * 2 * epochs, "stgcn_train_bwd": 6 * 2 * epochs,
              "stgcn_epilogue": 6 * epochs, "fps": 3 * epochs}
    print(f"  {name}: {epochs} epoch(s) in {seconds:.1f} s; launch counts {launches}")
    check(launches == expect, f"{name}: launch counts {launches} != {expect}")
    for means in history:
        for phase in ("train", "val"):
            check(all(np.isfinite(v) for v in means[phase].values()), f"{name}: {phase} losses not finite")
    return model, history, cfg.save_path, log, launches


def load_ckpt(run_dir, suffix):
    return torch.load(os.path.join(run_dir, f"model_{suffix}.pth"), map_location="cpu", weights_only=True)


def tree_gap(a, b):
    """(bit-equal, largest |a - b| over the float tensors) of two nested
    checkpoint trees (dicts, lists, tensors, numbers)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return False, float("inf")
        parts = [tree_gap(a[k], b[k]) for k in a]
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return False, float("inf")
        parts = [tree_gap(x, y) for x, y in zip(a, b)]
    elif torch.is_tensor(a):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            return False, float("inf")
        gap = (a.double() - b.double()).abs().max().item() if a.is_floating_point() and a.numel() else 0.0
        return torch.equal(a, b), gap
    elif isinstance(a, float) and isinstance(b, float):
        return a == b, abs(a - b)
    else:
        return a == b, 0.0 if a == b else float("inf")
    return all(p[0] for p in parts), max((p[1] for p in parts), default=0.0)


def host_copy(tree):
    """A copy of a nested dict / list of tensors on the host."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def momenta(model):
    return {m.momentum for m in model.modules() if type(m).__name__ == "BatchNorm"}


def loader_rates(datasets, smi):
    """Process- against thread-mode batches of the train split at full width
    (OPTION_WORKERS workers each, global batch 8): bit-equal over two
    epochs, and each mode's samples/s (host clock) once its pool is up."""
    loaders, rates, epochs = {}, {}, {}
    try:
        for mode in ("thread", "process"):
            loader = loaders[mode] = DataLoader(datasets["train"], batch_size=8, shuffle=True, seed=42,
                                                num_workers=OPTION_WORKERS, worker_mode=mode)
            # a process pool starts its workers on demand, each with a pickled
            # copy of the in-memory scenes, over the first epochs: six
            # epochs, the rate over the last two
            epochs[mode], seconds = [], []
            for epoch in range(6):
                loader.set_epoch(epoch)
                t0 = time.perf_counter()
                batches = list(loader)
                seconds.append(time.perf_counter() - t0)
                if epoch < 2:
                    epochs[mode].append(batches)
            rates[mode] = 2 * len(datasets["train"]) / sum(seconds[-2:])
            print(f"  [{smi}] loader {mode}: {rates[mode]:.1f} samples/s at full width over epochs 5-6 "
                  f"(host clock; epochs 1-6 {', '.join(f'{t:.3f}' for t in seconds)} s)")
    finally:
        for loader in loaders.values():
            loader.close()
    for a, b in zip(sum(epochs["process"], []), sum(epochs["thread"], [])):
        check(a["sample_idx"] == b["sample_idx"], "process vs thread loader: sample order differs")
        for k in a:
            if k != "sample_idx":
                check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                      f"process vs thread loader: {k} differs")
    print(f"  process-mode batches == thread-mode batches, bit for bit ({len(sum(epochs['thread'], []))} batches); "
          f"process / thread samples/s {rates['process'] / rates['thread']:.3f}")
    return epochs["thread"]


def board_scalars(run_cwd):
    """The LogBoard's scalars under <run_cwd>/runs, {tag: [steps]}, or None
    where tensorboard is not installed (the board is then a no-op)."""
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        return None
    acc = EventAccumulator(os.path.join(run_cwd, "runs"))
    acc.Reload()
    return {tag: [e.step for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def resume_runs(datasets, workdir):
    """R0 and R0' (2 epochs each), R1 (1 epoch) and R2 (R1 resumed for the
    second epoch in a sibling run dir), with R2's restored state captured as
    ``load_into_state`` leaves it, held against R1's file and against R0.
    Returns R1's run dir."""
    m0, h0, d0, log0, _ = options_run(options_config(workdir, "r0", 2), datasets, workdir, "r0")
    _, h0b, d0b, _, _ = options_run(options_config(workdir, "r0b", 2), datasets, workdir, "r0b")
    final0 = load_ckpt(d0, "final")
    same0, gap0 = tree_gap(final0, load_ckpt(d0b, "final"))
    print(f"  R0 vs R0' (two uninterrupted runs): bit-equal {same0}, largest gap {gap0:.3e}")
    _, _, d1, _, _ = options_run(options_config(workdir, "r1", 1), datasets, workdir, "r1")
    same1, gap1 = tree_gap(load_ckpt(d1, "last_1"), load_ckpt(d0, "last_1"))
    print(f"  R1 vs R0 after epoch 1 (model_last_1): bit-equal {same1}, largest gap {gap1:.3e}")
    restored = {}
    load_into_state = CheckpointIO.load_into_state

    def capture(path, model, optimizer):
        epoch, min_loss = load_into_state(path, model, optimizer)
        restored.update(path=path, net=host_copy(model.state_dict()), optimizer=host_copy(optimizer.state_dict()),
                        epoch=epoch, min_loss=min_loss)
        return epoch, min_loss

    CheckpointIO.load_into_state = staticmethod(capture)
    try:
        m2, h2, d2, log2, _ = options_run(options_config(workdir, "r1", 2, resume=True), datasets, workdir, "r2")
    finally:
        CheckpointIO.load_into_state = staticmethod(load_into_state)
    last1 = os.path.join(d1, "model_last_1.pth")
    check(os.path.dirname(d2) == os.path.dirname(d1) and d2 != d1, "R2 is not in a sibling run dir of R1")
    check(f"Resuming from {last1}" in log2 and restored.get("path") == last1, f"R2 did not resume from {last1}")
    check("-- Epoch 1/2" not in log2 and "-- Epoch 2/2" in log2 and len(h2) == 1, "R2 did not start at epoch index 1")
    saved = load_ckpt(d1, "last_1")
    same_restored, _ = tree_gap({k: restored[k] for k in saved}, saved)
    check(same_restored, "R2's restored state differs from R1's model_last_1.pth")
    final2 = load_ckpt(d2, "final")
    for g2, g0 in zip(final2["optimizer"]["param_groups"], final0["optimizer"]["param_groups"]):
        check(g2["lr"] == g0["lr"] and abs(g0["lr"] - 1e-4) < 1e-12, f"R2 vs R0 epoch-2 lr: {g2['lr']} vs {g0['lr']}")
    steps = lambda ck: sorted(float(s["step"]) for s in ck["optimizer"]["state"].values())  # noqa: E731
    check(steps(final2) == steps(final0) and set(steps(final0)) == {4.0}, "R2 vs R0: AdamW step counts")
    bn_log = r"Current BN decay momentum :([0-9.]+)\."
    check(re.findall(bn_log, log2) == re.findall(bn_log, log0)[1:] == ["0.250000"], "R2 vs R0: epoch-2 BN momentum")
    check(momenta(m2) == momenta(m0) == {0.75}, "R2 vs R0: BatchNorm keep-rates")
    loss_gap = {k: abs(h2[0]["train"][k] - h0[1]["train"][k]) / max(abs(h0[1]["train"][k]), 1e-7)
                for k in h0[1]["train"]}
    loss_gap.update({f"val/{k}": abs(h2[0]["val"][k] - h0[1]["val"][k]) / max(abs(h0[1]["val"][k]), 1e-7)
                     for k in h0[1]["val"]})
    print(f"  R2 resumed from {os.path.basename(d1)}/model_last_1.pth: restored state == the file "
          f"(net, optimizer, epoch {restored['epoch']}, min_loss {restored['min_loss']:.6f}); epoch-2 lr 1e-4, "
          f"BN momentum 0.25, AdamW steps 4 as R0; epoch-2 mean losses vs R0, max rel gap {max(loss_gap.values()):.2e}")
    spread = {k: abs(h0b[1][p][k] - h0[1][p][k]) / max(abs(h0[1][p][k]), 1e-7)
              for p in ("train", "val") for k in h0[1][p]}
    print(f"  R0' vs R0 epoch-2 mean losses, max rel gap {max(spread.values()):.2e}")
    check(max(loss_gap.values()) <= 1e-4, f"R2 vs R0 epoch-2 mean losses: {loss_gap}")
    same2, gap2 = tree_gap(final2, final0)
    print(f"  R2 vs R0 final state: bit-equal {same2}, largest gap {gap2:.3e} (R0 vs R0': {same0}, {gap0:.3e})")
    if same0:
        check(same2, "R0 == R0' bit for bit, but the resumed R2 differs from R0")
    return d1


def options_phase(workdir, smi):
    """The train runner's options at full width (p2rnet_train.yaml, global
    batch 8, 16 train and 8 val scenes: 2 train steps and 1 val step an
    epoch): resume, finetune + freeze + optim_spec, process workers,
    h2d_dtype, a profile window and the board.  Launch counts of every run:
    6 train_fwd + 6 train_bwd + 1 fps a train step, 6 epilogue + 1 fps a val
    step."""
    datasets = scene_datasets(seed=5, n_train=16, n_val=8)
    t_phase = time.perf_counter()

    # The gathers' backward adds by atomics on the card, so two runs of the
    # default step differ; R0, R0', R1 and R2 run with PyTorch's
    # deterministic algorithms, whose fallbacks are listed.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            d1 = resume_runs(datasets, workdir)
    finally:
        torch.use_deterministic_algorithms(False)
    fallbacks = sorted({str(w.message).split("\n")[0][:160] for w in caught
                        if "deterministic" in str(w.message)})
    print(f"  deterministic algorithms on for R0, R0', R1, R2; {len(fallbacks)} ops without a deterministic "
          f"implementation warned{':' if fallbacks else ''}")
    for msg in fallbacks:
        print(f"    {msg}")

    # R3: finetune from R1's best less one head tensor, backbone frozen,
    # the detection module at its own lr
    best1 = load_ckpt(d1, "best")["net"]
    head = "detection.conv_sem_obj.2.conv.weight"
    weight = os.path.join(workdir, "r1_best_less_head.pth")
    torch.save({"net": {k: v for k, v in best1.items() if k != head}}, weight)
    config = options_config(workdir, "r3", 1, finetune=True, weight=[weight])
    config["train"]["freeze"] = ["backbone"]
    config["model"]["detection"] = {**config["model"]["detection"], "optim_spec": {"lr": 1e-4}}
    m3, _, d3, log3, _ = options_run(config, datasets, workdir, "r3")
    check(f"partial weight load: {len(best1) - 1}/{len(best1)} tensors" in log3, "R3: the partial load was not logged")
    final3 = m3.state_dict()
    params = {k for k, _ in m3.named_parameters()}
    backbone = [k for k in params if k.startswith("backbone.")]
    stats = [k for k in final3 if k.startswith("backbone.") and k.endswith(("running_mean", "running_var"))]
    check(all(torch.equal(final3[k].cpu(), best1[k]) for k in backbone),
          "R3: a frozen backbone parameter moved")
    check(all(not torch.equal(final3[k].cpu(), best1[k]) for k in stats), "R3: a backbone BN running statistic did not move")
    moved = [k for k in params if not k.startswith("backbone.") and k != head and not torch.equal(final3[k].cpu(), best1[k])]
    groups = {g["name"]: g["lr"] for g in load_ckpt(d3, "final")["optimizer"]["param_groups"]}
    check(groups == {"centervoting": 1e-3, "detection": 1e-4}, f"R3 param groups' lr {groups}")
    print(f"  R3 (finetune less {head}, freeze backbone, detection lr 1e-4): {len(backbone)} backbone parameters "
          f"bit-identical under weight decay 0.01, {len(stats)} backbone running statistics moved, "
          f"{len(moved)} other parameters moved; group lr {groups}")
    del m3

    # R4: process workers, h2d_dtype float16, a profile window, the board
    thread_epochs = loader_rates(datasets, smi)
    seen = []
    train_step_fn = engine.train_step

    def recording_step(model, optimizer, batch, **kw):
        seen.append({k: v.cpu() for k, v in batch.items()})
        return train_step_fn(model, optimizer, batch, **kw)

    config = options_config(workdir, "r4", 2)
    config["device"].update(worker_mode="process", num_workers=OPTION_WORKERS)
    config["train"]["h2d_dtype"] = "float16"
    config["log"]["profile_steps"] = 1
    engine.train_step = recording_step
    try:
        _, _, d4, _, _ = options_run(config, datasets, workdir, "r4")
    finally:
        engine.train_step = train_step_fn
    host = sum(thread_epochs, [])
    check(len(seen) == len(host) == 4, f"R4: {len(seen)} train steps")
    for got, batch in zip(seen, host):
        check(torch.equal(got["input_joints"], torch.from_numpy(batch["input_joints"])), "R4: input_joints changed")
        for k, v in got.items():
            if k == "input_joints":
                continue
            want = batch[k].astype(np.float16).astype(np.float32) if batch[k].dtype == np.float32 else batch[k]
            check(v.dtype == torch.from_numpy(want).dtype and np.array_equal(v.numpy(), want),
                  f"R4: the step's {k} is not the float16-rounded host array")
    traces = [os.path.join(d4, "profile", f) for f in os.listdir(os.path.join(d4, "profile"))]
    check(len(traces) == 1, f"R4: {len(traces)} profile traces")
    with open(traces[0]) as f:
        text = f.read()
    named = {k: text.count(k) for k in TRAIN_KERNELS}
    check(all(named.values()), f"R4: the trace does not name every hand-written train kernel: {named}")
    print(f"  R4 (process workers, h2d_dtype float16, profile_steps 1): the step saw the float16-rounded "
          f"targets and the f32 input; trace {os.path.basename(traces[0])} ({len(text) / 2**20:.1f} MiB) "
          f"names {named}")
    scalars = board_scalars(os.path.join(workdir, "r4_cwd"))
    if scalars is None:
        print("  tensorboard is not installed: the LogBoard is a no-op, as in the JAX package")
    else:
        check(scalars.get("total/train") == [1, 2, 3, 4] and scalars.get("total/val") == [2, 4]
              and "grad_norm/train" in scalars, f"R4 board scalars {scalars}")
        print(f"  LogBoard: {len(scalars)} tags, total/train at steps {scalars['total/train']}, "
              f"total/val at {scalars['total/val']}")
    print(f"train options phase wall time {time.perf_counter() - t_phase:.1f} s")


def bulk_gap(a, b):
    """The JAX package's bulk statistics of a against b for tensors that
    cross bf16 roundings at other points (tests/test_stgcn_train.py:
    270-283): errors over max(|b|, 1e-3); (median, share beyond 7e-2, max)."""
    err = (a.double() - b.double()).abs() / max(b.double().abs().max().item(), 1e-3)
    return err.median().item(), (err > 7e-2).double().mean().item(), err.max().item()


def bulk_ok(gap):
    median, far, largest = gap
    return median < 3e-2 and far < 0.02 and largest < 0.5


def bf16_layer_card_vs_cpu(smi):
    """The full-width FusedTrainLayer in bf16 (B=2, T=768, 53 joints, the
    residual block) on the card against the CPU.  The two sum y = x @ M in
    other orders, so about 1e-4 of y's bf16 roundings differ, and every
    rounding and ReLU downstream can amplify one: an output near a
    cancellation moves many ulps, a ReLU mask that flips moves dx by the
    whole incoming gradient there.  So: at most 1e-3 of the output's
    elements differ at all; the output and each gradient in the JAX
    package's bulk band (median error < 3e-2 of the max, under 2% beyond
    7e-2, max < 0.5); the batch statistics within 1e-3 of each one's max;
    one launch of each bf16 train leg, none of the f32 legs."""
    g = torch.Generator().manual_seed(8)
    B2 = 2
    x = torch.zeros(B2, T, WP)
    x[..., :W0] = torch.randn(B2, T, W0, generator=g) * 0.6
    M = torch.zeros(WP, WP)
    M[:W0, :W0] = torch.randn(W0, W0, generator=g) * 0.02
    bias_col = torch.zeros(WP)
    bias_col[:W0] = torch.randn(W0, generator=g) * 0.1
    rest = [0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2,
            torch.randn(3, C, C, generator=g) * 0.15, torch.randn(C, generator=g) * 0.1,
            0.7 + torch.rand(C, generator=g), torch.randn(C, generator=g) * 0.2]
    w = torch.randn(B2, T, WP, generator=g).to(BF16).float()
    results = []
    for dev in ("cuda", "cpu"):
        args = [t.to(dev).to(BF16 if i < 2 else torch.float32).requires_grad_()
                for i, t in enumerate([x, M, bias_col, *rest])]
        kernels.reset_launch_counts()
        outs = stgcn_train.FusedTrainLayer.apply(*args, True, V, C, T)
        (outs[0].float() * w.to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            check(dict(kernels.LAUNCHES) == {"stgcn_train_fwd_bf16": 1, "stgcn_train_bwd_bf16": 1},
                  f"bf16 layer on the card: launch counts {dict(kernels.LAUNCHES)}")
        results.append(([o.detach().cpu() for o in outs], [a.grad.cpu().float() for a in args]))
    (outs_g, grads_g), (outs_c, grads_c) = results
    out_g, out_c = outs_g[0], outs_c[0]
    check(out_g.dtype == out_c.dtype == BF16, "bf16 layer output dtype")
    live = out_c.float().abs() > 1e-3 * out_c.float().abs().max()
    ulps = (bf16_ordinal(out_g) - bf16_ordinal(out_c)).abs()
    share = (out_g != out_c).double().mean().item()
    out_gap = bulk_gap(out_g, out_c)
    stat_gap = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(outs_g[1:], outs_c[1:]))
    names = ["x", "M", "bias_col", "g1", "b1", "taps", "cb", "g2", "b2"]
    grad_gap = {n: bulk_gap(a, b) for n, a, b in zip(names, grads_g, grads_c) if n != "cb"}
    print(f"[{smi}] bf16 FusedTrainLayer B=2 full width, card vs CPU: output {100 * share:.4f}% of elements "
          f"differ, {100 * (ulps[live] > 1).double().mean().item():.5f}% of the live ones by more than 1 ulp "
          f"(max {ulps[live].max().item()}), bulk (median, share > 7e-2, max) {out_gap}; batch statistics max "
          f"gap / max {stat_gap:.2e}; gradients, bulk: " + json.dumps(
              {k: [float(f"{v:.3e}") for v in gap] for k, gap in grad_gap.items()}))
    check(share <= 1e-3 and bulk_ok(out_gap), f"bf16 layer: card vs CPU output: {share} of elements differ, "
          f"bulk {out_gap}")
    check(stat_gap <= 1e-3, f"bf16 layer: card vs CPU batch statistics differ by {stat_gap} of their max")
    for k, gap in grad_gap.items():
        check(bulk_ok(gap), f"bf16 layer: card vs CPU gradient {k} outside the bulk band: {gap}")
    check(bool(torch.all(grads_g[6] == 0)) and bool(torch.all(grads_c[6] == 0)), "bf16 layer: conv bias gradient")


def relative_l2(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# the loss terms that FPS's picks do not feed (the votes' loss) and the
# running statistics computed before FPS (backbone, vote head)
PRE_FPS_LOSSES = ("vote_loss",)
PRE_FPS_STATS = ("backbone.", "centervoting.")


def bf16_card_vs_cpu_step(cfg, datasets):
    """One bf16 train step at B=2, full width, on the card and on the CPU
    (same weights, batch and MDN noise), each also with the two clips in
    the other order: the same function summed in another order.

    Everything before FPS is held in the bf16 bands: seed indices equal,
    seed features and votes within 1e-2 of their max (as bf16 generate),
    the vote loss within 2e-2 relative, the backbone's and the vote head's
    running statistics within 2e-2 of their max.  FPS over bf16-rounded
    votes meets near ties (ROADMAP "Faults found"): at full width a 1-ulp
    vote flip reselects proposals, so their agreement is printed, and the
    loss terms after FPS are held (within 2e-2, counts within one proposal)
    only where every proposal agrees.  The bf16 gradient is dominated by
    rounding noise (the JAX package's jit and eager runs differ by 0.40-0.97
    in relative L2 on the backbone), so each parameter's card gradient must
    be no further from the CPU's, in relative L2, than twice the larger
    batch-order spread of the two devices (+1e-3)."""
    model_cfg = P2RNetConfig.from_cfg(cfg)
    items = [datasets["val"].__getitem__(i, rng=np.random.RandomState(i)) for i in range(2)]
    results = {}
    for dev in ("cuda", "cpu"):
        for swap in (False, True):
            model = P2RNet(model_cfg, device=dev, generator=torch.Generator().manual_seed(42))
            optimizer, _, _ = make_optimizer(model, cfg.config["optimizer"])
            eps = model.mdn_eps(2, torch.Generator().manual_seed(7))
            batch = batch_to_device(collate(items[::-1] if swap else items), dev)
            losses, ep = train_step(model, optimizer, batch,
                                    eps={k: v.flip(0) for k, v in eps.items()} if swap else eps)
            outs = {k: ep[k].detach().cpu().float() for k in
                    ("seed_inds", "aggregated_vote_inds", "seed_features", "vote_xyz", "vote_features")}
            results[dev, swap] = (
                {k: float(v) for k, v in losses.items()},
                {k: v.flip(0) for k, v in outs.items()} if swap else outs,
                {k: p.grad.cpu().double() for k, p in model.named_parameters()},
                {k: b.cpu() for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))},
            )
    (l_g, o_g, g_g, s_g), (l_c, o_c, g_c, s_c) = results["cuda", False], results["cpu", False]
    agree = (o_g["aggregated_vote_inds"] == o_c["aggregated_vote_inds"]).double().mean().item()
    same_picks = {dev: bool(torch.equal(results[dev, True][1]["aggregated_vote_inds"],
                                        results[dev, False][1]["aggregated_vote_inds"])) for dev in ("cuda", "cpu")}
    pre_gap = {k: relative_gap(o_g[k], o_c[k]) for k in ("seed_features", "vote_xyz", "vote_features")}
    n_prop = o_c["aggregated_vote_inds"].numel()
    counts = ("pos_ratio", "neg_ratio", "obj_acc")
    loss_gap = {k: abs(l_g[k] - l_c[k]) / max(abs(l_c[k]), 1e-7) for k in l_c if k not in counts}
    count_gap = {k: abs(l_g[k] - l_c[k]) * n_prop for k in counts}
    params = [k for k in g_c if not k.endswith("tcn.2.bias")]
    grad_gap = {k: relative_l2(g_g[k], g_c[k]) for k in params}
    spread = {k: max(relative_l2(results[dev, True][2][k], results[dev, False][2][k]) for dev in ("cuda", "cpu"))
              for k in params}
    stat_gap = {k: relative_gap(s_g[k], s_c[k]) for k in s_c}
    pre_stats = [k for k in stat_gap if k.startswith(PRE_FPS_STATS)]
    worst = sorted(params, key=lambda k: -grad_gap[k] / max(spread[k], 1e-12))[:5]
    print(f"bf16 card vs CPU train step (B=2): seed features / votes / vote features max gap over max "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in pre_gap.items()})}; proposals agree {agree:.4f} "
          f"(the clip order changes no pick: {json.dumps(same_picks)}); loss terms rel gap "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in loss_gap.items()})}; proposal counts gap (proposals) "
          f"{json.dumps(count_gap)}; running stats max gap / max: before FPS "
          f"{max(stat_gap[k] for k in pre_stats):.2e}, all {max(stat_gap.values()):.2e}; gradients, relative L2 "
          f"card vs CPU: median {np.median(list(grad_gap.values())):.3e}, max {max(grad_gap.values()):.3e}; "
          f"batch-order spread: median {np.median(list(spread.values())):.3e}, max {max(spread.values()):.3e}")
    print("  largest card-vs-CPU gaps over the batch-order spread: " + ", ".join(
        f"{k} {grad_gap[k]:.3e} / {spread[k]:.3e}" for k in worst))
    check(torch.equal(o_g["seed_inds"], o_c["seed_inds"]), "bf16 card vs CPU train step: seed_inds differ")
    for k, v in pre_gap.items():
        check(v <= 1e-2, f"bf16 card vs CPU train step: {k} differs by {v} of its max")
    for k in pre_stats:
        check(stat_gap[k] <= 2e-2, f"bf16 card vs CPU: running stat {k} differs by {stat_gap[k]} of its max")
    held = PRE_FPS_LOSSES if agree < 1 else [k for k in loss_gap]
    for k in held:
        check(loss_gap[k] <= 2e-2, f"bf16 card vs CPU: loss {k} differs by {loss_gap[k]} relative")
    if agree == 1:
        for k, v in count_gap.items():
            check(v <= 1 + 1e-6 * n_prop, f"bf16 card vs CPU: {k} differs by {v} proposals")
    for k, v in grad_gap.items():
        check(v <= 2 * spread[k] + 1e-3, f"bf16 card vs CPU: gradient {k} relative L2 gap {v}, "
              f"twice the batch-order spread is {2 * spread[k]}")
    conv_bias = [k for k in g_g if k.endswith("tcn.2.bias")]
    check(all(bool(torch.all(g_g[k] == 0)) for k in conv_bias), "fused chain: conv bias gradient not 0")


def time_train_steps_in_turns(cfgs, datasets, smi):
    """The B=8 train step of each compute dtype, in turns f32/bf16/bf16/f32:
    each turn the CUDA-event median of 5 steps after 2 warm-ups; peak
    memory; a bf16 step's launch counts (6 of each bf16 train leg, 1 FPS,
    no f32 train leg); a profile of the bf16 step."""
    items = [datasets["train"].__getitem__(i, rng=np.random.RandomState(i)) for i in range(8)]
    batch = batch_to_device(collate(items), "cuda")
    runs = {}
    for name, cfg in cfgs.items():
        model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cuda", generator=torch.Generator().manual_seed(42))
        optimizer, _, _ = make_optimizer(model, cfg.config["optimizer"])
        runs[name] = (model, optimizer)

    def step(name, i):
        model, optimizer = runs[name]
        return train_step(model, optimizer, batch, generator=torch.Generator().manual_seed(i))

    kernels.reset_launch_counts()
    step("bf16", 0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expect = {"stgcn_train_fwd_bf16": 6, "stgcn_train_bwd_bf16": 6, "fps": 1}
    check(launches == expect, f"bf16 train step launch counts {launches} != {expect}")
    times, peaks = {name: [] for name in cfgs}, {}
    for name in ("f32", "bf16", "bf16", "f32"):
        for i in range(2):
            step(name, 1 + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        turn = []
        for i in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(name, 3 + i)
            end.record()
            torch.cuda.synchronize()
            turn.append(start.elapsed_time(end))
        times[name].append(float(np.median(turn)))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    for name, t in times.items():
        print(f"[{smi}] B=8 {name} train step (CUDA events, median of 5 after 2 warm-ups, in turns "
              f"f32/bf16/bf16/f32): {' / '.join(f'{v:.3f}' for v in t)} ms -> "
              f"{8e3 / min(t):.2f} samples/s; peak memory {peaks[name]:.2f} GiB")
    print(f"bf16 train step launch counts: {launches}")
    device_profile(lambda i: step("bf16", 10 + i), 3, "B=8 bf16 train step", min(times["bf16"]), smi)
    return times, peaks


def bf16_train_phase(workdir, smi):
    """bf16 training: the full-width layer and a B=2 step, card vs CPU; the
    B=8 bf16 step beside the f32 step; one bf16 ``--mode train`` epoch
    through the runner, whose checkpoint the demo runner loads."""
    bf16_layer_card_vs_cpu(smi)
    configs = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        config = train_config(os.path.join(workdir, f"train_{name}"))
        config["model"] = {**(config.get("model") or {}), "compute_dtype": dtype}
        configs[name] = config
    cfgs = {name: CONFIG(config, mode="train") for name, config in configs.items()}
    try:
        for cfg in cfgs.values():
            mount_external_config(cfg)
        cfg = cfgs["bf16"]
        datasets = scene_datasets(seed=3, n_train=16, n_val=8)
        initial = P2RNet(P2RNetConfig.from_cfg(cfg), device="cpu",
                         generator=torch.Generator().manual_seed(42)).state_dict()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, history = train_runner.run(cfg, datasets=datasets)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        print(f"bf16 train run (1 epoch: 2 train steps of 8, 1 val step of 8) {time.perf_counter() - t0:.1f} s; "
              f"launch counts {launches}")
        expect = {"stgcn_train_fwd_bf16": 6 * 2, "stgcn_train_bwd_bf16": 6 * 2, "stgcn_epilogue_bf16": 6 * 1,
                  "fps": 2 + 1}
        check(launches == expect, f"bf16 train run launch counts {launches} != {expect} (6 train_fwd_bf16 + "
              "6 train_bwd_bf16 + 1 fps per train step, 6 epilogue_bf16 + 1 fps per val step)")
        for phase in ("train", "val"):
            means = history[0][phase]
            check(all(np.isfinite(v) for v in means.values()), f"bf16 {phase} losses not finite: {means}")
            print(f"bf16 mean {phase} losses: " + json.dumps({k: round(v, 5) for k, v in means.items()}))
        final = model.state_dict()
        check(all(v.dtype in (torch.float32, torch.int64) for v in final.values()), "bf16 run: state not f32")
        moved = [k for k in initial if not torch.equal(initial[k], final[k].cpu())]
        weights = [k for k, _ in model.named_parameters()]
        check(all(k in moved for k in initial if k.endswith(("running_mean", "running_var"))),
              "bf16 run: some BN running statistics did not move")
        check(sum(k in moved for k in weights) >= len(weights) - 6, "bf16 run: weights did not move")
        ckpt = os.path.join(cfg.save_path, "model_final.pth")
        check(os.path.isfile(ckpt), "bf16 run: model_final.pth not written")
        demo_cfg = CONFIG(dict(configs["bf16"], finetune=True, weight=[ckpt], seed=0,
                               log={"path": os.path.join(workdir, "demo_out_bf16")}), mode="demo")
        try:
            served = common.setup(demo_cfg, device="cuda")[0]
        finally:
            demo_cfg.close()
        check(served.compute_dtype == BF16 and all(torch.equal(served.state_dict()[k], v) for k, v in final.items()),
              "demo setup did not load the bf16 run's model_final.pth")
        print(f"bf16 checkpoint {os.path.basename(ckpt)} written and loaded by the bf16 demo runner; "
              f"{len(moved)} of {len(initial)} state tensors moved")
        del model, served

        bf16_card_vs_cpu_step(cfg, datasets)
        time_train_steps_in_turns(cfgs, datasets, smi)
        return launches
    finally:
        for cfg in cfgs.values():
            cfg.close()


def test_config(workdir, **test_knobs):
    config = read_to_dict(TEST_YAML)
    config.update(finetune=False, seed=42)
    config["model"]["sparse_eval"] = True
    config["test"].update(batch_size=1, **test_knobs)
    config["log"]["path"] = os.path.join(workdir, "out")
    return config


def metre_box_weights(cfg, path):
    """The config's model on random weights from seed 42, with the size
    head's mixture means set so that its boxes are ~1.5 m wide (AP is then
    not trivially 0), saved to ``path`` for ``finetune``.  Returns path."""
    model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cpu", generator=torch.Generator().manual_seed(42))
    mu = model.detection.gmm_size.mdn.mu
    with torch.no_grad():
        mu.fill_(2 * np.log(1.5) / mu.shape[0])
    torch.save({"net": model.state_dict()}, path)
    return path


def profile_test_run(cfg, dataset, batch_ms, smi):
    """torch.profiler over a second test run: device kernel time per batch
    (the one-time fold included), its share of the per-batch time, and the
    top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        test_runner.run(cfg, dataset=dataset)
        torch.cuda.synchronize()
    n = len(dataset)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    per_batch = sum(dev_us(e) for e in events) / n / 1e3
    print(f"[{smi}] profiler, test run of {n} batches of 1: device kernels {per_batch:.3f} ms per batch, "
          f"busy share {per_batch / batch_ms:.3f} of the {batch_ms:.3f} ms batch; top 6 kernels per batch:")
    for e in sorted(events, key=lambda e: -dev_us(e))[:6]:
        print(f"  {dev_us(e) / n / 1e3:8.3f} ms  x{e.count / n:<5.1f} {e.key[:110]}")


def test_phase(workdir, smi):
    dataset = scene_datasets(seed=5, n_train=0, n_val=8)["val"]  # test scenes: no augmentation
    cfg = CONFIG(test_config(workdir), mode="test")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = test_runner.run(cfg, dataset=dataset)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        seconds = time.perf_counter() - t0
        summary = cfg.test_summary
        n = len(dataset)
        expect = {"stgcn_sparse": 6 * n, "stgcn_epilogue": 6 * n, "fps": n}
        check(launches == expect, f"test run launch counts {launches} != {expect} "
              "(6 stgcn_sparse + 6 epilogue + 1 fps per batch of 1)")
        for t, m in metrics.items():
            check(all(np.isfinite(v) for v in m.values()), f"AP@{t}: a metric is not finite")
            print(f"AP@{t}: mAP {m['mAP']:.6f} AR {m['AR']:.6f}")
        check(all(np.isfinite(v) for v in summary["mean_losses"].values()), "test losses not finite")
        batch_ms = [s * 1e3 for s in summary["batch_seconds"]]
        print(f"[{smi}] test run, {n} batches of 1 (sparse_eval, IoU on the {summary['iou_path']} path): "
              f"{seconds:.2f} s with set-up; per-batch time (between batch completions, host clock) "
              f"median of batches 2-{n} {np.median(batch_ms[1:]):.3f} ms: {', '.join(f'{b:.3f}' for b in batch_ms)}")
        print(f"test launch counts: {launches}")
        profile_test_run(cfg, dataset, np.median(batch_ms[1:]), smi)

        # the card's sparse generate against the CPU's and against the card's dense chain
        clip = torch.from_numpy(dataset[0]["input_joints"][None])
        gpu = common.build_model(cfg, device="cuda")
        cpu = common.build_model(cfg, device="cpu")
        dense = P2RNet(dataclasses.replace(gpu.config, sparse_eval=False), device="cuda")
        dense.load_state_dict(gpu.state_dict())
        folded_s, folded_d = gpu.fold_eval(), dense.fold_eval()
        x_gpu = clip.cuda()
        ep_gpu = gpu.generate(x_gpu, folded=folded_s)
        ep_cpu = cpu.generate(clip, folded=cpu.fold_eval())
        ep_dense = dense.generate(x_gpu, folded=folded_d)
        print("sparse card vs CPU max |diff|: " + json.dumps(generate_gap(ep_gpu, ep_cpu, "sparse card vs CPU")))
        print("sparse vs dense on the card max |diff|: "
              + json.dumps(generate_gap(ep_gpu, ep_dense, "sparse vs dense on the card")))
        # sparse against dense chain, in turns (sparse, dense, dense, sparse)
        x32 = torch.from_numpy(np.stack([dataset[i % n]["input_joints"] for i in range(32)])).cuda()
        chains = {"sparse": (gpu, folded_s), "dense": (dense, folded_d)}
        times = {"sparse": [], "dense": []}
        for name in ("sparse", "dense", "dense", "sparse"):
            model, folded = chains[name]
            times[name].append((cuda_ms(lambda: model.generate(x_gpu, folded=folded), iters=10),
                                cuda_ms(lambda: model.generate(x32, folded=folded), iters=3, warmup=1)))
        for name, runs in times.items():
            print(f"[{smi}] {name} chain generate (CUDA events): batch 1 "
                  f"{' / '.join(f'{b1:.3f}' for b1, _ in runs)} ms (means of 10); B=32 "
                  f"{' / '.join(f'{b32:.3f}' for _, b32 in runs)} ms (means of 3) -> "
                  f"{32e3 / min(b32 for _, b32 in runs):.1f} clips/s")
        for name, (model, folded) in chains.items():
            device_profile(lambda i: model.generate(x32, folded=folded), 2, f"B=32 {name} generate",
                           min(b32 for _, b32 in times[name]), smi, top=6)
        del gpu, cpu, dense, chains, x32
    finally:
        cfg.close()

    # remove_far_box off, metre-sized random boxes: the same AP on the card and the CPU
    ckpt = metre_box_weights(cfg, os.path.join(workdir, "test_weights.pth"))
    small = SceneDataset(dataset.samples[:4], num_frames=T, augment=False)
    results = {}
    for dev in ("cuda", "cpu"):
        config = test_config(workdir, remove_far_box=False)
        config.update(finetune=True, weight=[ckpt])
        cfg = CONFIG(config, mode="test")
        try:
            results[dev] = test_runner.run(cfg, device=dev, dataset=small)
        finally:
            cfg.close()
    for t, want in results["cpu"].items():
        got = results["cuda"][t]
        check(list(got) == list(want), f"AP@{t}: card and CPU report other keys")
        gap = max(abs(got[k] - v) for k, v in want.items())
        check(gap <= 1e-6, f"AP@{t}: card vs CPU differ by {gap}")
        print(f"remove_far_box off, 4 scenes, AP@{t}: card mAP {got['mAP']:.6f} AR {got['AR']:.6f}, "
              f"CPU mAP {want['mAP']:.6f} AR {want['AR']:.6f}, max |gap| {gap:.2e}")
    return launches


def multi_mode_gap(a, b, noise, what):
    """Card vs CPU multi-mode ``generate`` on the same noise: indices equal;
    the Bernoulli weights ``u < pi`` that flip between the two devices' pi
    counted, at most 1e-5 of them; the box outputs within generate_gap's
    bands on the proposals whose masks agree in every head, the other
    outputs on every proposal.  Returns (flips, weights, agreeing
    proposals, proposals, max |diff| of each output)."""
    for key in ("seed_inds", "aggregated_vote_inds"):
        check(torch.equal(a[key].cpu(), b[key].cpu()), f"{what}: {key} differ")
    flips, total, rows = 0, 0, None
    for k, (_, u) in noise.items():
        u = u.cpu()
        ma, mb = u < a["pi"][k].cpu()[..., None], u < b["pi"][k].cpu()[..., None]
        flips += int((ma != mb).sum())
        total += u.numel()
        agree = (ma == mb).all(-1).all(-1)
        rows = agree if rows is None else rows & agree
    check(flips <= 1e-5 * total, f"{what}: {flips} of {total} Bernoulli weights flipped (more than 1e-5)")
    diffs = {k: (a[k].cpu()[rows] - b[k].cpu()[rows]).abs().max().item() for k in ("center", "size", "heading")}
    diffs.update({k: (a[k].cpu() - b[k].cpu()).abs().max().item()
                  for k in ("objectness_scores", "sem_cls_scores", "seed_features")})
    diffs.update({f"pi/{k}": (a["pi"][k].cpu() - b["pi"][k].cpu()).abs().max().item()
                  for k in ("center", "size", "heading")})
    for key, d in diffs.items():
        tol = 2e-4 if key == "seed_features" else 5e-4
        check(d <= tol, f"{what}: {key} differs by {d} (tolerance {tol})")
    return flips, total, int(rows.sum()), rows.numel(), diffs


def time_multi_mode_generate(gpu, folded, clip, x32, drawn, smi):
    """Multi-mode generate (its device draw included) against the
    deterministic one, in turns (det, multi, multi, det), CUDA events: batch
    1 at n = 1, the drawn n and 99, and B=32 at n=99; the draw's own time;
    the peak device memory of a B=32 generate at n=99 and a deterministic
    one."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, x, n, iters in ((1, clip, 1, 10), (1, clip, drawn, 10), (1, clip, 99, 10), (32, x32, 99, 3)):
        warmup = 1 if B == 32 else 3
        times = {"deterministic": [], "multi-mode": []}
        for name in ("deterministic", "multi-mode", "multi-mode", "deterministic"):
            if name == "deterministic":
                fn = lambda: gpu.generate(x, folded=folded)  # noqa: E731
            else:
                fn = lambda: gpu.generate(x, multi_mode=True, n_samples=n, folded=folded, generator=g)  # noqa: E731
            times[name].append(cuda_ms(fn, iters=iters, warmup=warmup))
        draw = cuda_ms(lambda: gpu.multi_noise(B, n, g), iters=iters, warmup=warmup)
        det, multi = times["deterministic"], times["multi-mode"]
        print(f"[{smi}] generate B={B} n={n} (CUDA events, means of {iters}): deterministic "
              f"{' / '.join(f'{t:.3f}' for t in det)} ms, multi-mode {' / '.join(f'{t:.3f}' for t in multi)} ms "
              f"(+{min(multi) - min(det):.3f} ms); the noise draw alone {draw:.3f} ms")
    for name, fn in (("multi-mode n=99", lambda: gpu.generate(x32, multi_mode=True, n_samples=99, folded=folded,
                                                               generator=g)),
                     ("deterministic", lambda: gpu.generate(x32, folded=folded))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[{smi}] B=32 {name} generate: peak device memory {peak / 2**30:.3f} GiB "
              f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before it)")


def multi_mode_phase(workdir, smi):
    """The multi-mode and mesh test phase (6b in the docstring)."""
    dataset = scene_datasets(seed=5, n_train=0, n_val=8)["val"]
    n = len(dataset)
    cfg = CONFIG(test_config(workdir, multi_mode=True), mode="test")
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = test_runner.run(cfg, dataset=dataset)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        seconds = time.perf_counter() - t0
        expect = {"stgcn_sparse": 6 * n, "stgcn_epilogue": 6 * n, "fps": n}
        check(launches == expect, f"multi-mode test run launch counts {launches} != {expect}")
        for t, m in metrics.items():
            check(all(np.isfinite(v) for v in m.values()), f"multi-mode AP@{t}: a metric is not finite")
        summary = cfg.test_summary
        check(all(np.isfinite(v) for v in summary["mean_losses"].values()), "multi-mode test losses not finite")
        salt, drawn = test_runner.multi_mode_draws(cfg.save_path, 42)
        written = read_to_dict(os.path.join(cfg.save_path, "out_config.yaml"))["test"]
        check((written["drawn_run_salt"], written["drawn_n_samples"], summary["n_samples"]) == (salt, drawn, drawn),
              f"out_config.yaml holds {written.get('drawn_run_salt')} / {written.get('drawn_n_samples')}, "
              f"the formula gives {salt} / {drawn}")
        batch_ms = [b * 1e3 for b in summary["batch_seconds"]]
        print(f"[{smi}] multi-mode sparse test run, {n} batches of 1, n_samples {drawn} (run salt {salt}, "
              f"both in out_config.yaml): {seconds:.2f} s with set-up; per-batch time (host clock) median of "
              f"batches 2-{n} {np.median(batch_ms[1:]):.3f} ms: {', '.join(f'{b:.3f}' for b in batch_ms)}")
        print(f"multi-mode test launch counts: {launches}")

        clip = torch.from_numpy(dataset[0]["input_joints"][None])
        gpu = common.build_model(cfg, device="cuda")
        cpu = common.build_model(cfg, device="cpu")
        folded = gpu.fold_eval()
        noise = cpu.multi_noise(1, 99, torch.Generator().manual_seed(99))
        ep_gpu = gpu.generate(clip.cuda(), multi_mode=True, n_samples=99, folded=folded,
                              noise={k: (e.cuda(), u.cuda()) for k, (e, u) in noise.items()})
        ep_cpu = cpu.generate(clip, multi_mode=True, n_samples=99, folded=cpu.fold_eval(), noise=noise)
        flips, total, agree, props, diffs = multi_mode_gap(ep_gpu, ep_cpu, noise, "multi-mode card vs CPU")
        print(f"multi-mode sparse generate n=99 card vs CPU on the same noise: {flips} of {total} Bernoulli "
              f"weights flipped, {agree} of {props} proposals with every mask equal; max |diff|: "
              + json.dumps(diffs))
        x32 = torch.from_numpy(np.stack([dataset[i % n]["input_joints"] for i in range(32)])).cuda()
        time_multi_mode_generate(gpu, folded, clip.cuda(), x32, drawn, smi)
        del gpu, cpu, noise, x32
    finally:
        cfg.close()

    # three multi-mode runs with dumps, then the multi-modal metrics over them
    ckpt = metre_box_weights(cfg, os.path.join(workdir, "multi_mode_weights.pth"))
    small = SceneDataset(dataset.samples[:4], num_frames=T, augment=False)
    run_dirs, drawn_ns = [], []
    for _ in range(3):
        config = test_config(workdir, multi_mode=True, remove_far_box=False)
        config.update(finetune=True, weight=[ckpt])
        config["generation"].update(dump_results=True, dump_threshold=0.05)
        cfg = CONFIG(config, mode="test")
        try:
            test_runner.run(cfg, dataset=small)
            run_dirs.append(cfg.save_path)
            drawn_ns.append(cfg.test_summary["n_samples"])
        finally:
            cfg.close()
    max_map, tmd = multi_modal.multi_modal_metrics(run_dirs)
    check(len(max_map) == 2 and np.all(np.isfinite(max_map)), f"max mAP {max_map} not finite")
    check(np.isfinite(tmd) and tmd >= 1.0, f"TMD {tmd} not finite or below 1")
    print(f"three multi-mode runs (n_samples {drawn_ns}, 4 scenes, remove_far_box off, dumps at 0.05): "
          f"max mAP per threshold {[float(m) for m in max_map]}, TMD {tmd:.6f}")

    # eval_mesh_ap: the same keys and values on the card and the CPU
    results, stages = {}, {}
    for dev in ("cuda", "cpu"):
        config = test_config(workdir, remove_far_box=False, eval_mesh_ap=True)
        config.update(finetune=True, weight=[ckpt])
        cfg = CONFIG(config, mode="test")
        try:
            t0 = time.perf_counter()
            results[dev] = test_runner.run(cfg, device=dev, dataset=small)
            stages[dev] = (time.perf_counter() - t0, cfg.test_summary["voxel_seconds"],
                           cfg.test_summary["metrics_seconds"])
        finally:
            cfg.close()
    for t, want in results["cpu"].items():
        got = results["cuda"][t]
        check(list(got) == list(want) and "mAP_mesh" in got, f"mesh AP@{t}: card and CPU report other keys")
        gap = max(abs(got[k] - v) for k, v in want.items())
        check(gap <= 1e-6, f"mesh AP@{t}: card vs CPU differ by {gap}")
        print(f"eval_mesh_ap, 4 scenes, AP@{t}: card mAP {got['mAP']:.6f} mAP_mesh {got['mAP_mesh']:.6f} "
              f"AR_mesh {got['AR_mesh']:.6f}, CPU mAP_mesh {want['mAP_mesh']:.6f}, max |gap| over "
              f"{len(want)} keys {gap:.2e}")
    for dev, (run_s, vox_s, metrics_s) in stages.items():
        print(f"[{smi}] eval_mesh_ap run on the {dev} (host clock): {run_s:.3f} s with set-up; voxelizing "
              f"{vox_s:.3f} s, box + mesh metrics of both thresholds {metrics_s:.3f} s")
    return launches


def bf16_test_phase(workdir, smi):
    """The sparse_eval test runner in bf16 on the 8 synthetic scenes; card vs
    CPU bf16 sparse generate; AP on the card against the CPU."""
    dataset = scene_datasets(seed=5, n_train=0, n_val=8)["val"]
    config = test_config(workdir)
    config["model"]["compute_dtype"] = "bfloat16"
    cfg = CONFIG(config, mode="test")
    try:
        kernels.reset_launch_counts()
        metrics = test_runner.run(cfg, dataset=dataset)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        n = len(dataset)
        expect = {"stgcn_sparse_bf16": 6 * n, "stgcn_epilogue_bf16": 6 * n, "fps": n}
        check(launches == expect, f"bf16 test run launch counts {launches} != {expect}")
        for t, m in metrics.items():
            check(all(np.isfinite(v) for v in m.values()), f"bf16 AP@{t}: a metric is not finite")
        check(all(np.isfinite(v) for v in cfg.test_summary["mean_losses"].values()), "bf16 test losses not finite")
        batch_ms = [t * 1e3 for t in cfg.test_summary["batch_seconds"]]
        print(f"[{smi}] bf16 sparse test run, {n} batches of 1: per-batch time (host clock) median of batches "
              f"2-{n} {np.median(batch_ms[1:]):.3f} ms; launch counts {launches}")

        clip = torch.from_numpy(dataset[0]["input_joints"][None])
        gpu = common.build_model(cfg, device="cuda")
        cpu = common.build_model(cfg, device="cpu")
        ep_gpu = gpu.generate(clip.cuda(), folded=gpu.fold_eval())
        ep_cpu = cpu.generate(clip, folded=cpu.fold_eval())
        agree, gaps = bf16_generate_gap(ep_gpu, ep_cpu, "bf16 sparse card vs CPU")
        print(f"bf16 sparse card vs CPU generate: proposals agree {agree:.4f}; max |diff| / max: " + json.dumps(gaps))
        x32 = torch.from_numpy(np.stack([dataset[i % n]["input_joints"] for i in range(32)])).cuda()
        folded = gpu.fold_eval()
        b32 = min(cuda_ms(lambda: gpu.generate(x32, folded=folded), iters=3, warmup=1) for _ in range(2))
        print(f"[{smi}] bf16 sparse chain B=32 generate {b32:.3f} ms -> {32e3 / b32:.1f} clips/s")
        device_profile(lambda i: gpu.generate(x32, folded=folded), 2, "B=32 bf16 sparse generate", b32, smi, top=6)
        del gpu, cpu, x32
    finally:
        cfg.close()

    # remove_far_box off, metre-sized random boxes: AP on the card against the CPU
    ckpt = metre_box_weights(cfg, os.path.join(workdir, "test_weights_bf16.pth"))
    small = SceneDataset(dataset.samples[:4], num_frames=T, augment=False)
    results, inds = {}, {}
    for dev in ("cuda", "cpu"):
        config = test_config(workdir, remove_far_box=False)
        config["model"]["compute_dtype"] = "bfloat16"
        config.update(finetune=True, weight=[ckpt])
        cfg = CONFIG(config, mode="test")
        try:
            results[dev] = test_runner.run(cfg, device=dev, dataset=small)
            m = common.setup(cfg, device=dev)[0]
            f = m.fold_eval()
            inds[dev] = [m.generate(torch.from_numpy(small[i]["input_joints"][None]).to(dev),
                                   folded=f)["aggregated_vote_inds"].cpu() for i in range(len(small))]
        finally:
            cfg.close()
    # bf16 AP on the card against the CPU: even with the same proposals, a
    # vote at the ball's edge changes one proposal's pooled feature and so
    # its box, which can move one class's AP by a whole step (one GT box);
    # mAP and AR, over every class and scene, are held within 0.1
    all_agree = all(torch.equal(a, b) for a, b in zip(inds["cuda"], inds["cpu"]))
    for t, want in results["cpu"].items():
        got = results["cuda"][t]
        check(list(got) == list(want), f"bf16 AP@{t}: card and CPU report other keys")
        gap = max(abs(got[k] - v) for k, v in want.items())
        held = max(abs(got[k] - want[k]) for k in ("mAP", "AR"))
        check(held <= 0.1, f"bf16 AP@{t}: card vs CPU mAP / AR differ by {held}")
        print(f"bf16 remove_far_box off, 4 scenes, AP@{t}: card mAP {got['mAP']:.6f} AR {got['AR']:.6f}, "
              f"CPU mAP {want['mAP']:.6f} AR {want['AR']:.6f}, mAP/AR gap {held:.2e}, largest gap of any "
              f"class {gap:.2e} (every proposal index agrees: {all_agree})")
    return launches


# ---------------------------------------------------------------------------
# data-parallel phase: ranks as subprocesses of torch.distributed.run
# ---------------------------------------------------------------------------

DDP_STEPS = 2
DDP_TIMED = 5
DDP_BATCH = 8
# profiler rows of the collectives: the backends' host ops (gloo:*, nccl:*) and NCCL's kernels
COLLECTIVE_KEYS = ("nccl", "gloo")


def ddp_config(workdir, name, batch):
    """p2rnet_train.yaml at full width as the train phase's, ``batch`` a
    process, clipping by the global norm on, under <workdir>/<name>."""
    config = train_config(os.path.join(workdir, name))
    config["train"]["batch_size"] = config["val"]["batch_size"] = batch
    config["optimizer"]["clip_norm"] = 1.0
    return config


def ddp_clips():
    """The eight clips of the data-parallel steps: synthetic scenes without
    augmentation, made from a seed in every process."""
    dataset = scene_datasets(seed=3, n_train=0, n_val=DDP_BATCH)["val"]
    return [dataset[i] for i in range(DDP_BATCH)]


def collective_rows(prof, n_steps):
    """(host ms, device ms) a step in the collectives' profiler rows, and the
    rows: host time is the CPU total of the c10d / gloo / NCCL ops, device
    time NCCL's kernels."""
    from torch.autograd import DeviceType

    host_ms = dev_ms = 0.0
    rows = []
    for e in prof.key_averages():
        if not any(k in e.key.lower() for k in COLLECTIVE_KEYS):
            continue
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            dev_ms += us / n_steps / 1e3
            rows.append((f"device {e.key[:70]}", us / n_steps / 1e3, e.count / n_steps))
        else:
            host_ms += e.cpu_time_total / n_steps / 1e3
            rows.append((f"host {e.key[:70]}", e.cpu_time_total / n_steps / 1e3, e.count / n_steps))
    return host_ms, dev_ms, sorted(rows, key=lambda r: -r[1])[:6]


def ddp_steps(cfg, items, perm=None, timed=0, profile=False):
    """DDP_STEPS train steps on this process's rows of the global batch of
    eight (``perm``: the batch's rows in another order, for one process)
    with each step's noise drawn for the whole batch: the launches of those
    steps, each step's global losses, the first step's gradients (reduced)
    and the state (parameters and running statistics) after each step; then
    ``timed`` more steps' times (CUDA events) and, with ``profile``, the
    collectives' share of two profiled steps."""
    rank, n = process_index(), process_count()
    rows = list(perm if perm is not None else range(DDP_BATCH))[rank::n]
    model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cuda", generator=torch.Generator().manual_seed(42))
    optimizer, _, clip_norm = make_optimizer(model, cfg.config["optimizer"])
    net = wrap_model(model)
    batch = batch_to_device(collate([items[i] for i in rows]), "cuda")

    def step(i):
        eps = {k: v[rows] for k, v in model.mdn_eps(DDP_BATCH, torch.Generator().manual_seed(100 + i)).items()}
        return train_step(net, optimizer, batch, eps=eps, clip_norm=clip_norm)

    out = {"losses": [], "state": []}
    kernels.reset_launch_counts()
    for i in range(DDP_STEPS):
        losses, end_points = step(i)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            scale = max(out["losses"][0]["grad_norm"] / clip_norm, 1.0)  # undo the clipping
            out["grads"] = {k: (p.grad * scale).cpu() for k, p in model.named_parameters()}
            out["picks"] = {k: end_points[k].cpu() for k in ("seed_inds", "aggregated_vote_inds")}
        out["state"].append(host_copy(model.state_dict()))
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    times = []
    for i in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(DDP_STEPS + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out["step_ms"] = times
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            for i in range(2):
                step(100 + i)
            torch.cuda.synchronize()
        out["profiled_ms"] = (time.perf_counter() - t0) * 1e3 / 2
        out["collectives"] = collective_rows(prof, 2)
    return out


def float64_steps(cfg, items):
    """``ddp_steps``' steps on the CPU in float64 on this process's rows of
    the global batch (through DDP in a group): each step's losses and state,
    and the first step's gradients (reduced, before clipping) and discrete
    choices (seeds, proposals), the referee of the f32 train band."""
    rank, n = process_index(), process_count()
    rows = list(range(DDP_BATCH))[rank::n]
    model = P2RNet(P2RNetConfig.from_cfg(cfg), device="cpu", generator=torch.Generator().manual_seed(42)).double()
    optimizer, _, clip_norm = make_optimizer(model, cfg.config["optimizer"])
    net = wrap_model(model)
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch_to_device(collate([items[i] for i in rows]), "cpu").items()}
    out = {"losses": [], "state": []}
    for i in range(DDP_STEPS):
        eps = {k: v[rows].double() for k, v in model.mdn_eps(DDP_BATCH, torch.Generator().manual_seed(100 + i)).items()}
        losses, end_points = train_step(net, optimizer, batch, eps=eps, clip_norm=clip_norm)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if i == 0:
            scale = max(out["losses"][0]["grad_norm"] / clip_norm, 1.0)  # undo the clipping
            out["grads"] = {k: p.grad * scale for k, p in model.named_parameters()}
            out["picks"] = {k: end_points[k] for k in ("seed_inds", "aggregated_vote_inds")}
        out["state"].append(host_copy(model.state_dict()))
    return out


def ddp_train_run(cfg, datasets):
    """The train runner under the group: launches, losses, run dir, the
    final state and what this rank's working directory holds."""
    kernels.reset_launch_counts()
    model, history = train_runner.run(cfg, datasets=datasets)
    torch.cuda.synchronize()
    return {"launches": dict(kernels.LAUNCHES), "history": history, "save_path": cfg.save_path,
            "state": host_copy(model.state_dict()),
            "run_dir": sorted(os.listdir(cfg.save_path)) if cfg.is_main_process else None,
            "cwd": sorted(os.listdir("."))}


def ddp_test_run(cfg, dataset):
    """The test runner under the group, written as the CLI writes it."""
    cfg.write_config()
    kernels.reset_launch_counts()
    metrics = test_runner.run(cfg, dataset=dataset)
    torch.cuda.synchronize()
    return {"launches": dict(kernels.LAUNCHES), "metrics": metrics, "save_path": cfg.save_path,
            "mean_losses": cfg.test_summary["mean_losses"], "batch_seconds": cfg.test_summary["batch_seconds"]}


def ddp_worker(spec_path):
    """One rank under torch.distributed.run (``chip_smoke.py --ddp-worker
    <spec.json>``): joins the group, runs the spec's parts from its own
    working directory and saves their results to <workdir>/rank<r>.pt."""
    with open(spec_path) as f:
        spec = json.load(f)
    backend = init_distributed()
    try:
        set_precision_policy()
        torch.use_deterministic_algorithms(True, warn_only=True)
        rank = process_index()
        workdir = os.path.join(spec["workdir"], f"rank{rank}")
        os.makedirs(workdir, exist_ok=True)
        os.chdir(workdir)  # the train runner's board writes to ./runs
        out = {"backend": backend, "card": torch.cuda.current_device()}
        batch = DDP_BATCH // process_count()
        if spec.get("steps"):
            cfg = CONFIG(ddp_config(spec["workdir"], "steps", batch), mode="train")
            try:
                mount_external_config(cfg)
                items = ddp_clips()
                out["steps"] = ddp_steps(cfg, items, timed=DDP_TIMED, profile=True)
                if spec.get("steps64"):
                    # torchrun gives each of several ranks one thread
                    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // process_count()))
                    t0 = time.perf_counter()
                    out["steps64"] = float64_steps(cfg, items)
                    out["steps64"]["seconds"] = time.perf_counter() - t0
            finally:
                cfg.close()
        if spec.get("train_run"):
            cfg = CONFIG(ddp_config(spec["workdir"], "train_run", batch), mode="train")
            try:
                out["train_run"] = ddp_train_run(cfg, scene_datasets(seed=3, n_train=16, n_val=8))
            finally:
                cfg.close()
        if spec.get("test_run"):
            config = test_config(os.path.join(spec["workdir"], "test_run"), remove_far_box=False)
            config.update(finetune=True, weight=[spec["test_weights"]])
            cfg = CONFIG(config, mode="test")
            try:
                out["test_run"] = ddp_test_run(cfg, scene_datasets(seed=5, n_train=0, n_val=8)["val"])
            finally:
                cfg.close()
        torch.save(out, os.path.join(spec["workdir"], f"rank{rank}.pt"))
    finally:
        shutdown()


def launch_ranks(nproc, spec, workdir, timeout=600):
    """``python -m torch.distributed.run --nproc_per_node nproc chip_smoke.py
    --ddp-worker`` on localhost: each rank's results, the ranks' log lines of
    the group and the launch's wall seconds.  The launch gets an OS
    process group of its own, killed whole if it outlasts ``timeout``."""
    os.makedirs(workdir, exist_ok=True)
    spec = dict(spec, workdir=workdir)
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc), "--master_addr",
           "localhost", "--master_port", str(port), os.path.abspath(__file__), "--ddp-worker", spec_path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: {nproc} ranks did not finish within {timeout} s")
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{nproc} ranks exited with {proc.returncode}:\n{stderr[-6000:]}")
    groups = [line for line in (stdout + stderr).splitlines() if line.startswith("process group:")]
    results = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(nproc)]
    return results, groups, seconds


def ddp_phase(workdir, smi):
    """(a) world 1 on NCCL against the same steps in this process, bit for
    bit; (b) world 2 on gloo, both ranks on the one card, 4 + 4 against the
    steps at 8, and the train runner under the two ranks; (c) the test runner
    under two gloo ranks against one process; step times in this call."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = CONFIG(ddp_config(workdir, "single", DDP_BATCH), mode="train")
        try:
            mount_external_config(cfg)
            items = ddp_clips()
            single = ddp_steps(cfg, items, timed=DDP_TIMED)
            perm = ddp_steps(cfg, items, perm=[3, 6, 0, 5, 2, 7, 4, 1])
            t0 = time.perf_counter()
            single64 = float64_steps(cfg, items)
            seconds64 = time.perf_counter() - t0
        finally:
            cfg.close()
        test_cfg = CONFIG(test_config(os.path.join(workdir, "single_test"), remove_far_box=False), mode="test")
        try:
            mount_external_config(test_cfg)
            weights = metre_box_weights(test_cfg, os.path.join(workdir, "ddp_test_weights.pth"))
            test_cfg.config.update(finetune=True, weight=[weights])
            test_dataset = scene_datasets(seed=5, n_train=0, n_val=8)["val"]
            single_metrics = test_runner.run(test_cfg, dataset=test_dataset)
            single_losses = test_cfg.test_summary["mean_losses"]
        finally:
            test_cfg.close()
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    per_step = {"stgcn_train_fwd": 6 * DDP_STEPS, "stgcn_train_bwd": 6 * DDP_STEPS, "fps": DDP_STEPS}
    check(single["launches"] == per_step, f"single-process steps: launches {single['launches']} != {per_step}")

    # (a) world 1, NCCL: bit-equal to the same steps in this process
    (one,), groups, seconds_a = launch_ranks(1, {"steps": True}, os.path.join(workdir, "world1"))
    print(f"(a) world 1 ({seconds_a:.1f} s with start-up): {'; '.join(groups)}")
    check(one["backend"] == "nccl", f"world 1 on one card ran on {one['backend']}, not nccl")
    a = one["steps"]
    check(a["launches"] == per_step, f"(a) launches {a['launches']} != {per_step}")
    for i in range(DDP_STEPS):
        check(a["losses"][i] == single["losses"][i], f"(a) step {i + 1} losses differ: {a['losses'][i]} vs "
              f"{single['losses'][i]}")
        same, gap = tree_gap(a["state"][i], single["state"][i])
        check(same, f"(a) state after step {i + 1} differs from one process's by up to {gap}")
    same, gap = tree_gap(a["grads"], single["grads"])
    check(same, f"(a) step-1 gradients differ from one process's by up to {gap}")
    print(f"(a) world 1 on NCCL vs one process, deterministic algorithms: losses, step-1 gradients, "
          f"parameters and running statistics after each of {DDP_STEPS} steps bit-equal; "
          f"launches {a['launches']}")

    # (b) + (c) world 2, gloo, both ranks on card 0
    spec = {"steps": True, "steps64": True, "train_run": True, "test_run": True, "test_weights": weights}
    ranks, groups, seconds_b = launch_ranks(2, spec, os.path.join(workdir, "world2"))
    print(f"(b, c) world 2 ({seconds_b:.1f} s with start-up): {'; '.join(groups)}")
    check([r["backend"] for r in ranks] == ["gloo", "gloo"] and [r["card"] for r in ranks] == [0, 0],
          f"world 2 on one card: backends {[r['backend'] for r in ranks]}, cards {[r['card'] for r in ranks]}")
    b = [r["steps"] for r in ranks]
    for r, got in enumerate(b):
        check(got["launches"] == per_step, f"(b) rank {r} launches {got['launches']} != {per_step}")
    for i in range(DDP_STEPS):
        same, gap = tree_gap(b[0]["state"][i], b[1]["state"][i])
        check(same, f"(b) the two ranks' states after step {i + 1} differ by up to {gap}")
    # step 1, from the same parameters: losses, gradients (ROADMAP §3's f32
    # train band, a CPU float64 step the referee), running statistics
    grads64 = single64["grads"]
    for k, v in single64["picks"].items():
        check(torch.equal(single["picks"][k], v), f"(b) the float64 referee's {k} differ from the card's")
    # each leaf's referee band: its own error in two one-process runs
    ref_err = {k: max(relative_gap(single["grads"][k], v), relative_gap(perm["grads"][k], v))
               for k, v in grads64.items()}
    gaps = {k: relative_gap(b[0]["grads"][k], v) for k, v in single["grads"].items()}
    errs = {k: relative_gap(b[0]["grads"][k], v) for k, v in grads64.items()}
    for k, v in gaps.items():
        check(v <= 1e-3 or errs[k] <= 3 * ref_err[k],
              f"(b) step-1 gradient {k}: {v} of max|g| from one process's, {errs[k]} from float64 against one "
              f"process's {ref_err[k]}")
    by_referee = sorted((errs[k] / ref_err[k], k) for k, v in gaps.items() if v > 1e-3)
    loss_gap = {k: abs(b[0]["losses"][0][k] - v) / max(abs(v), 1e-7) for k, v in single["losses"][0].items()}
    for k, v in loss_gap.items():
        check(v <= 1e-4, f"(b) step-1 loss {k} differs by {v} relative")
    stats = [k for k in single["state"][0] if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        check(torch.allclose(b[0]["state"][0][k], single["state"][0][k], atol=1e-4, rtol=1e-4),
              f"(b) running statistic {k} after step 1")
    # after step 1, f32 runs that round differently part (AdamW's first
    # updates are ~lr times the sign of each gradient entry, and an entry
    # within rounding of 0 takes either sign; ROADMAP §3): the card's later
    # state is printed beside a batch-order run's, and the update through
    # DDP is held in float64 on the CPU
    last = DDP_STEPS - 1
    param_gap = max((b[0]["state"][last][k] - v).abs().max().item() for k, v in single["state"][last].items()
                    if k not in stats and v.is_floating_point())
    perm_param_gap = max((perm["state"][last][k] - v).abs().max().item() for k, v in single["state"][last].items()
                         if k not in stats and v.is_floating_point())
    rel_loss = lambda a, b_: max(abs(a[k] - v) / max(abs(v), 1e-7) for k, v in b_.items())  # noqa: E731
    last_gap, perm_last = rel_loss(b[0]["losses"][last], single["losses"][last]), rel_loss(perm["losses"][last],
                                                                                       single["losses"][last])
    stat_gap = max(relative_gap(b[0]["state"][last][k], single["state"][last][k]) for k in stats)
    perm_stat = max(relative_gap(perm["state"][last][k], single["state"][last][k]) for k in stats)
    print(f"(b) world 2 on gloo (4 + 4) vs one process at 8, step 1: losses max rel gap {max(loss_gap.values()):.2e}; "
          f"gradients max gap {max(gaps.values()):.2e} of max|g| ({len(gaps) - len(by_referee)} of {len(gaps)} "
          f"within 1e-3; the largest ratios of another's error against float64 to its one-process error: "
          f"{', '.join(f'{r:.2f} {k}' for r, k in by_referee[-5:]) or 'none'}), max error against float64 "
          f"{max(errs.values()):.2e} (one process {max(ref_err.values()):.2e}; the float64 CPU steps {seconds64:.1f} s; "
          f"their seeds and proposals equal the card's); running statistics within 1e-4.  After step {DDP_STEPS}, "
          f"not held: parameters max |gap| {param_gap:.2e} (a batch-order run {perm_param_gap:.2e}), losses max rel "
          f"gap {last_gap:.2e} (batch order {perm_last:.2e}), running statistics {stat_gap:.2e} of max (batch order "
          f"{perm_stat:.2e}); both ranks' states bit-equal; launches per rank {b[0]['launches']}")

    # (b) the same steps in float64 on the CPU under the two ranks
    w64 = [r["steps64"] for r in ranks]
    for i in range(DDP_STEPS):
        same, gap = tree_gap(w64[0]["state"][i], w64[1]["state"][i])
        check(same, f"(b) float64: the two ranks' states after step {i + 1} differ by up to {gap}")
    grad64_gap = max(relative_gap(w64[0]["grads"][k], v) for k, v in grads64.items())
    check(grad64_gap <= 1e-8, f"(b) float64 step-1 gradients {grad64_gap} of max|g| from one process's")
    loss64_gap = max(abs(w64[0]["losses"][i][k] - v) / max(abs(v), 1.0)
                     for i in range(DDP_STEPS) for k, v in single64["losses"][i].items())
    check(loss64_gap <= 1e-6, f"(b) float64 losses differ by {loss64_gap} relative")
    state64_gap = []
    for i in range(DDP_STEPS):
        for k, v in single64["state"][i].items():
            if v.is_floating_point():
                gap = relative_gap(w64[0]["state"][i][k], v)
                check(gap <= 1e-5, f"(b) float64 {k} after step {i + 1}: {gap} of its max from one process's")
                state64_gap.append(gap)
    print(f"(b) the same {DDP_STEPS} steps in float64 on the CPU, 2 gloo ranks of 4 ({w64[0]['seconds']:.1f} s) vs "
          f"one process at 8 ({seconds64:.1f} s): step-1 gradients max gap {grad64_gap:.2e} of max|g|, losses "
          f"{loss64_gap:.2e} relative, parameters and running statistics after each step {max(state64_gap):.2e} "
          f"of their max; both ranks' states bit-equal")

    # (b) the train runner under the two ranks
    runs = [r["train_run"] for r in ranks]
    expect = {"stgcn_train_fwd": 6 * 2, "stgcn_train_bwd": 6 * 2, "stgcn_epilogue": 6 * 1, "fps": 2 + 1}
    for r, run in enumerate(runs):
        check(run["launches"] == expect, f"(b) train run rank {r} launches {run['launches']} != {expect}")
        for phase in ("train", "val"):
            check(all(np.isfinite(v) for v in run["history"][0][phase].values()), f"(b) rank {r} {phase} losses")
    check(runs[0]["save_path"] == runs[1]["save_path"], "(b) the ranks used different run dirs")
    check(runs[0]["history"] == runs[1]["history"], "(b) the ranks logged different mean losses")
    same, gap = tree_gap(runs[0]["state"], runs[1]["state"])
    check(same, f"(b) after the train runner's epoch the two ranks' states differ by up to {gap}")
    run_root = os.path.dirname(runs[0]["save_path"])
    check(os.listdir(run_root) == [os.path.basename(runs[0]["save_path"])], f"(b) run dirs {os.listdir(run_root)}")
    check(runs[0]["run_dir"] == ["log.txt", "model_best.pth", "model_final.pth", "visualization"],
          f"(b) run dir holds {runs[0]['run_dir']}")
    check("runs" not in runs[1]["cwd"], "(b) rank 1 wrote a TensorBoard board")
    print(f"(b) train runner, 2 ranks of 4, 1 epoch (2 train steps, 1 val step): launches per rank "
          f"{runs[0]['launches']}; both ranks' final states bit-equal; one run dir, written by rank 0: {runs[0]['run_dir']}; mean train total "
          f"{runs[0]['history'][0]['train']['total']:.5f}, val total {runs[0]['history'][0]['val']['total']:.5f}")

    # (c) the test runner under the two ranks: the merged metrics and losses
    tests = [r["test_run"] for r in ranks]
    expect = {"stgcn_sparse": 6 * 4, "stgcn_epilogue": 6 * 4, "fps": 4}
    for r, run in enumerate(tests):
        check(run["launches"] == expect, f"(c) test run rank {r} launches {run['launches']} != {expect}")
        for t, want in single_metrics.items():
            check(list(run["metrics"][t]) == list(want), f"(c) rank {r} AP@{t}: other keys")
            gap = max(abs(run["metrics"][t][k] - v) for k, v in want.items())
            check(gap <= 1e-6, f"(c) rank {r} AP@{t} differs from one process's by {gap}")
        gap = max(abs(run["mean_losses"][k] - v) / max(abs(v), 1.0) for k, v in single_losses.items())
        check(gap <= 1e-6, f"(c) rank {r} merged mean losses differ by {gap}")
    check(tests[0]["save_path"] == tests[1]["save_path"], "(c) the ranks used different run dirs")
    configs = [os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(workdir, "world2", "test_run")) for f in fs
               if f == "out_config.yaml"]
    check(len(configs) == 1, f"(c) out_config.yaml written {len(configs)} times")
    batch_ms = [s * 1e3 for s in tests[0]["batch_seconds"]]
    print(f"(c) test runner, 2 ranks x 4 scenes (sparse_eval, metre-sized boxes): AP@0.25 mAP "
          f"{tests[0]['metrics'][0.25]['mAP']:.6f} AR {tests[0]['metrics'][0.25]['AR']:.6f}, equal to one process's "
          f"within 1e-6, merged mean losses too; one out_config.yaml; launches per rank {tests[0]['launches']}; "
          f"rank 0 per-batch time {', '.join(f'{t:.3f}' for t in batch_ms)} ms")

    # step times, in this call
    med = lambda t: float(np.median(t))  # noqa: E731
    print(f"[{smi}] B=8 train step (CUDA events, median of {DDP_TIMED}, deterministic algorithms): one process "
          f"{med(single['step_ms']):.3f} ms; (a) world 1 NCCL {med(a['step_ms']):.3f} ms; (b) world 2 gloo on one "
          f"card, 4 a rank: rank 0 {med(b[0]['step_ms']):.3f} ms, rank 1 {med(b[1]['step_ms']):.3f} ms")
    for name, got in (("(a) world 1 NCCL", a), ("(b) world 2 gloo rank 0", b[0])):
        host_ms, dev_ms, rows = got["collectives"]
        print(f"[{smi}] {name}, profiler over 2 steps ({got['profiled_ms']:.3f} ms a step under the profiler): "
              f"collectives {host_ms:.3f} ms a step of host time, {host_ms / med(got['step_ms']):.3f} of the "
              f"unprofiled {med(got['step_ms']):.3f} ms step; {dev_ms:.3f} ms of device time")
        for key, ms, count in rows:
            print(f"  {ms:9.3f} ms  x{count:<5.1f} {key}")
    return {"single_ms": med(single["step_ms"]), "a_ms": med(a["step_ms"]), "b_ms": med(b[0]["step_ms"])}


# data pipeline phase: recordings to pictures (12 in the docstring)
PRIOR_SPLIT = os.path.join("datasets", "virtualhome_22_classes", "splits", "script_level")
PIPELINE_FRAMES = 900  # a real clip's length; the loader resamples it to 768


def pipeline_graph():
    """A recorded-scene-graph stand-in: one 8x3x8 m room (floor, two walls),
    four detectable raw classes with one interaction each (sofa: sit, fridge:
    put the apple in, tv: switch, desk: put the apple on), a grabbable
    apple, a door and its jamb, and a bench outside the room."""
    def node(nid, cls, category, center, size, properties=(), states=()):
        return {"id": nid, "class_name": cls, "category": category, "properties": list(properties),
                "states": list(states), "bounding_box": {"center": list(center), "size": list(size)},
                "obj_transform": {"rotation": [1.0, 0.0, 0.0, 0.0]}}

    nodes = [
        node(1, "livingroom", "Rooms", [0, 1.5, 0], [8, 3, 8]),
        node(2, "floor", "Floors", [0, -0.05, 0], [8, 0.1, 8]),
        node(3, "wall", "Walls", [-4, 1.5, 0], [0.1, 3, 8]),
        node(4, "wall", "Walls", [4, 1.5, 0], [0.1, 3, 8]),
        node(10, "sofa", "Furniture", [2, 0.4, 2], [2.0, 0.8, 0.9], ["SITTABLE"]),
        node(11, "fridge", "Appliances", [-2.5, 1.0, 1.5], [0.9, 2.0, 0.9], ["CAN_OPEN", "CONTAINERS"], ["CLOSED"]),
        node(12, "tv", "Electronics", [3, 1.0, -3], [1.2, 0.7, 0.2], ["HAS_SWITCH"], ["OFF"]),
        node(13, "desk", "Furniture", [-2, 0.4, -2], [1.4, 0.8, 0.7], ["SURFACES"]),
        node(20, "apple", "Props", [0.5, 0.9, -1], [0.1, 0.1, 0.1], ["GRABBABLE"]),
        node(30, "door", "Doors", [0, 1.0, -3.9], [1.0, 2.0, 1.4]),
        node(31, "doorjamb", "Decor", [0, 1.0, -3.95], [1.0, 2.1, 0.2]),
        node(40, "bench", "Furniture", [100, 0.4, 100], [1.5, 0.5, 0.5], ["SITTABLE"]),
    ]
    edges = [{"from_id": i, "to_id": 1, "relation_type": "INSIDE"} for i in (10, 11, 12, 13, 20, 40)]
    return {"nodes": nodes, "edges": edges}


class StandInSimulator:
    """The UnityCommunication surface that stage 2 drives (the role of
    tests/test_programs.py's FakeSim): render_script writes a
    ``pd_script.txt`` of PIPELINE_FRAMES frames of 56 joints, a walk from the
    door past every object the script names, in its order."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.body = np.stack([rng.uniform(-0.25, 0.25, 56), np.linspace(-0.9, 0.8, 56),
                              rng.uniform(-0.15, 0.15, 56)], axis=1)  # joint offsets from the hips
        self.noise = rng.randn(PIPELINE_FRAMES, 56, 3) * 0.01
        self.centers = {}

    def reset(self, scene_id):
        self.scene = scene_id

    def expand_scene(self, graph):
        self.centers = {n["id"]: np.asarray(n["bounding_box"]["center"], dtype=np.float64) for n in graph["nodes"]}
        return (True,)

    def add_character(self, name, initial_room=None):
        self.character = name

    def render_script(self, script, output_folder=None, **kw):
        ids = [int(i) for line in script for i in re.findall(r"\((\d+)\)", line)]
        stops = [np.array([0.0, 0.9, -3.5])] + [self.centers[i] * [1, 0, 1] + [0, 0.9, 0] for i in ids]
        stops = np.stack(stops)
        arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(stops, axis=0), axis=1))])
        s = np.linspace(0.0, arc[-1], PIPELINE_FRAMES)
        hips = np.stack([np.interp(s, arc, stops[:, d]) for d in range(3)], axis=1)
        joints = hips[:, None, :] + self.body[None] + self.noise
        out = os.path.join(output_folder, "script", "0")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "pd_script.txt"), "w") as f:
            for i, frame in enumerate(joints):
                f.write(f"{i} " + " ".join(f"{x:.5f}" for x in frame.ravel()) + "\n")
        return True, None


def pipeline_datagen(root):
    """Stages 1-3 in memory: {sample name: build_samples sample}, 8 a
    recording, and the stage-1 output."""
    from pose2room_tpu_torch.config.dataset_config import CLASS_LABELS_RAW
    from pose2room_tpu_torch.datagen import generate_room_programs, render_recordings
    from pose2room_tpu_torch.datagen.samples import build_samples, find_recordings, load_recording

    graph = pipeline_graph()
    stage1 = generate_room_programs(graph, 0, CLASS_LABELS_RAW, out_dir=os.path.join(root, "script_bbox"),
                                    scene_id=0, n_seq=3)
    names = sorted(n["class_name"] for n in stage1["nodes_for_det"])
    check(names == ["desk", "fridge", "sofa", "tv"], f"stage 1 detection targets {names}")
    check(len(stage1["scripts"]) == 3, f"stage 1 wrote {len(stage1['scripts'])} scripts, not 3")
    stats = render_recordings(StandInSimulator, os.path.join(root, "script_bbox"), os.path.join(root, "recording"),
                              {"0": graph}, characters=("Chars/Male1",), log=lambda msg: print(f"  stage 2: {msg}"))
    check(len(stats["recorded"]) == 3 and not stats["failed"] and not stats["skipped"], f"stage 2: {stats}")
    samples = {}
    recordings = find_recordings(os.path.join(root, "recording"))
    for sk_file in recordings:
        name, joints, room_bbox, nodes = load_recording(os.path.join(root, "recording"), sk_file)
        check(joints.shape == (PIPELINE_FRAMES, 53, 3), f"{sk_file}: joints {joints.shape}")
        for sample in build_samples(joints, room_bbox, nodes):
            samples[f"{name}_{sample['aug_idx']}"] = sample
    check(len(samples) == 24, f"{len(recordings)} recordings gave {len(samples)} samples, not 3 x 8")
    for name, s in samples.items():
        F = s["skeleton_joints"].shape[0]
        check(s["skeleton_joints"].shape == (F, 53, 3) and s["skeleton_joint_votes"].shape == (F, 53, 10),
              f"{name}: joints {s['skeleton_joints'].shape}, votes {s['skeleton_joint_votes'].shape}")
        check(s["skeleton_joints"].dtype == s["skeleton_joint_votes"].dtype == np.float32, f"{name}: not float32")
        ids = [int(n["class_id"][0]) for n in s["object_nodes"]]
        check(len(ids) == 4 and all(0 <= i < 22 for i in ids), f"{name}: class ids {ids}")
        check((s["skeleton_joint_votes"][..., 0] > 0).any(), f"{name}: no vote mask set")
    return samples


def pipeline_files(root, samples):
    """With h5py: generate_samples and scripts/torch_split_samples.py write
    the files; they must read back as the in-memory samples, and the
    DatasetConfig of the split must read the written prior.  Returns
    {"train", "val"} of sample names."""
    from pose2room_tpu_torch.config.dataset_config import DatasetConfig
    from pose2room_tpu_torch.data.dataset import P2RNetDataset, load_sample
    from pose2room_tpu_torch.datagen import generate_samples
    from pose2room_tpu_torch.datagen.samples import stored_sample

    written = generate_samples(os.path.join(root, "recording"), os.path.join(root, "samples"), n_workers=8)
    check(len(written) == 24, f"generate_samples wrote {len(written)} files")
    for path in written:
        name = os.path.splitext(os.path.basename(path))[0]
        (j, v, inst), (wj, wv, winst) = load_sample(path), stored_sample(samples[name])
        check(np.array_equal(j, wj) and np.array_equal(v, wv), f"{path}: joints or votes differ from memory")
        check(len(inst) == len(winst) and all(a["class_id"] == b["class_id"] and all(
            np.array_equal(a[k], b[k]) for k in ("centroid", "R_mat", "size")) for a, b in zip(inst, winst)),
            f"{path}: instances differ from memory")
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_split_samples.py"), "--samples",
                          os.path.join(root, "samples"), "--out", os.path.dirname(PRIOR_SPLIT)],
                         cwd=root, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"torch_split_samples.py: {out.stderr[-2000:]}")
    print(f"  scripts/torch_split_samples.py: {out.stdout.strip()}")
    with open(os.path.join(root, PRIOR_SPLIT, "avg_data.json")) as f:
        prior = json.load(f)["obj_size_cls_avg"]
    config = DatasetConfig(split=PRIOR_SPLIT)
    classes = sorted({int(n["class_id"][0]) for s in samples.values() for n in s["object_nodes"]})
    check(sorted(map(int, prior)) == classes, f"prior classes {sorted(prior)}, the samples' {classes}")
    check(all(config.mean_size_arr[int(c)].tolist() == v for c, v in prior.items()),
          "DatasetConfig(split=) did not read the written avg_data.json")
    split = {}
    for mode in ("train", "val"):
        with open(os.path.join(root, PRIOR_SPLIT, f"{mode}.json")) as f:
            split[mode] = [os.path.splitext(os.path.basename(p))[0] for p in json.load(f)]
    from_files = P2RNetDataset(os.path.join(root, PRIOR_SPLIT, "val.json"), num_frames=T)
    in_memory = SceneDataset([stored_sample(samples[n]) for n in split["val"]], num_frames=T)
    for i in range(len(in_memory)):
        a, b = from_files[i], in_memory[i]
        check(all(np.array_equal(a[k], b[k]) for k in a if k != "sample_idx"),
              f"P2RNetDataset item {i} differs from the in-memory sample's")
    print(f"  {len(written)} HDF5 samples read back equal to the in-memory ones (and the val items through "
          f"P2RNetDataset); split {len(split['train'])} train / "
          f"{len(split['val'])} val; DatasetConfig(split=) read avg_data.json ({len(prior)} classes)")
    return split


def pipeline_split_in_memory(root, samples):
    """Without h5py: generate_splits' rule on the names the files would have."""
    from pose2room_tpu_torch.datagen import generate_splits

    paths = [os.path.join(root, "samples", f"{name}.hdf5") for name in samples]
    split = generate_splits(paths, os.path.join(root, PRIOR_SPLIT))
    return {mode: [os.path.splitext(os.path.basename(p))[0] for p in split[mode]] for mode in ("train", "val")}


def pipeline_train(root, samples, split, device, has_h5py):
    """One epoch of the train runner at p2rnet_train.yaml's width on the
    generated samples; returns (its run dir, seconds, its P2RNetConfig)."""
    from pose2room_tpu_torch.datagen.samples import stored_sample

    config = train_config(root)
    config["data"]["split"] = PRIOR_SPLIT
    cfg = CONFIG(config, mode="train")
    try:
        mount_external_config(cfg)
        datasets = None
        if not has_h5py:
            datasets = {"train": SceneDataset([stored_sample(samples[n]) for n in split["train"]], num_frames=T,
                                              augment=True),
                        "val": SceneDataset([stored_sample(samples[n]) for n in split["val"]], num_frames=T)}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model, history = train_runner.run(cfg, device=device, datasets=datasets)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n_train = -(-len(split["train"]) // 8)
        n_val = -(-len(split["val"]) // 8)
        expect = {"stgcn_train_fwd": 6 * n_train, "stgcn_train_bwd": 6 * n_train, "stgcn_epilogue": 6 * n_val,
                  "fps": n_train + n_val}
        check(launches == expect, f"pipeline train run launch counts {launches} != {expect} (6 train_fwd + 6 "
              "train_bwd + 1 fps per train step, 6 epilogue + 1 fps per val step)")
        for phase in ("train", "val"):
            means = history[0][phase]
            check(all(np.isfinite(v) for v in means.values()), f"pipeline {phase} losses not finite: {means}")
        check(os.path.isfile(os.path.join(cfg.save_path, "model_final.pth")), "model_final.pth not written")
        print(f"  train run: {n_train} train steps of <= 8, {n_val} val step(s), {seconds:.2f} s; launches {launches}; "
              f"mean val losses " + json.dumps({k: round(v, 5) for k, v in history[0]["val"].items()}))
        del model
        return cfg.save_path, seconds, P2RNetConfig.from_cfg(cfg)
    finally:
        cfg.close()


def pipeline_eval_nn_loss(run_dir, model_cfg, samples, names, device):
    """eval_nn_loss on one val batch, on the card and on the CPU: the same
    trained weights, batch and MDN noise; the assignments exactly equal,
    each term within 1e-4 relative."""
    from pose2room_tpu_torch.datagen.samples import stored_sample
    from pose2room_tpu_torch.models.loss import eval_nn_assignment, eval_nn_loss

    state = torch.load(os.path.join(run_dir, "model_final.pth"), map_location="cpu", weights_only=True)["net"]
    dataset = SceneDataset([stored_sample(samples[n]) for n in names[:8]], num_frames=T)
    batch = collate([dataset[i] for i in range(len(dataset))])
    results = []
    for dev in (device, "cpu"):
        model = P2RNet(model_cfg, device=dev)
        model.load_state_dict(state)
        model.eval()
        inputs = batch_to_device(batch, dev)
        with torch.no_grad():
            eps = model.mdn_eps(len(dataset), torch.Generator().manual_seed(3))
            end_points = model(inputs["input_joints"], eps=eps)
            results.append((eval_nn_loss(end_points, inputs), eval_nn_assignment(end_points, inputs)[1].cpu()))
    (got, got_a), (want, want_a) = results
    check(torch.equal(got_a, want_a), "eval_nn_loss: card and CPU assign other GT boxes")
    gaps = {k: abs(got[k].item() - v.item()) / max(abs(v.item()), 1e-6) for k, v in want.items()}
    check(all(g <= 1e-4 for g in gaps.values()), f"eval_nn_loss card vs CPU relative gaps {gaps}")
    print(f"  eval_nn_loss on a val batch of {len(dataset)}: card "
          + json.dumps({k: round(v.item(), 6) for k, v in got.items()})
          + f"; assignments equal, max relative gap to the CPU {max(gaps.values()):.2e}")


def pipeline_test(root, samples, split, weights, device, has_h5py):
    """The sparse_eval test runner, finetuned from the train run's
    model_final.pth, on the held-out samples at batch 1.  Returns (the dump
    dir of its first batch, seconds)."""
    from pose2room_tpu_torch.datagen.samples import stored_sample

    config = test_config(root)
    config.update(finetune=True, weight=[weights])
    config["data"]["split"] = PRIOR_SPLIT
    config["generation"] = {"dump_results": True, "dump_threshold": 0.05}
    cfg = CONFIG(config, mode="test")
    try:
        dataset = None if has_h5py else SceneDataset([stored_sample(samples[n]) for n in split["val"]], num_frames=T)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = test_runner.run(cfg, device=device, dataset=dataset)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n = len(split["val"])
        expect = {"stgcn_sparse": 6 * n, "stgcn_epilogue": 6 * n, "fps": n}
        check(launches == expect, f"pipeline test run launch counts {launches} != {expect} "
              "(6 stgcn_sparse + 6 epilogue + 1 fps per batch of 1)")
        dumps = sorted(glob.glob(os.path.join(cfg.config["log"]["vis_path"], "test_*")))
        check(len(dumps) == n, f"{len(dumps)} dump dirs for {n} test batches")
        for t, m in metrics.items():
            check(all(np.isfinite(v) for v in m.values()), f"pipeline AP@{t}: a metric is not finite")
            per_class = {k: round(v, 4) for k, v in m.items() if k.endswith("Average Precision")}
            check(per_class, f"pipeline AP@{t}: no per-class AP")
            print(f"  AP@{t}: mAP {m['mAP']:.6f} AR {m['AR']:.6f}; per class " + json.dumps(per_class))
        print(f"  test run, {n} batches of 1 (sparse_eval, finetuned from model_final.pth): {seconds:.2f} s; "
              f"launches {launches}; {len(dumps)} dump dirs")
        first = os.path.join(cfg.config["log"]["vis_path"], f"test_0_{split['val'][0] if has_h5py else 'scene_0000'}")
        check(first in dumps, f"no dump dir {first}")
        return first, seconds
    finally:
        cfg.close()


def pipeline_three_nn(device):
    """three_nn at B=8, 1024 unknowns, 256 known points (ten repeated):
    indices exactly equal on the card and the CPU, distances within 1e-5,
    also with TF32 on around the call."""
    from pose2room_tpu_torch.ops.interpolate import three_nn

    g = torch.Generator().manual_seed(11)
    unknown = torch.rand(8, 1024, 3, generator=g) * 8 - 4
    known = torch.rand(8, 256, 3, generator=g) * 8 - 4
    known[:, 100:110] = known[:, 10:20]
    want_d, want_i = three_nn(unknown, known)
    before = torch.backends.cuda.matmul.allow_tf32
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got_d, got_i = three_nn(unknown.to(device), known.to(device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        check(torch.equal(got_i.cpu(), want_i), f"three_nn (TF32 {tf32}): card and CPU indices differ")
        gap = (got_d.cpu() - want_d).abs().max().item()
        check(gap <= 1e-5, f"three_nn (TF32 {tf32}): distances differ by {gap}")
        print(f"  three_nn B=8, 1024 x 256 (TF32 {'on' if tf32 else 'off'}): indices equal, max |dist gap| {gap:.2e}")


def pipeline_render(root, dump_dir, sample_name, has_h5py):
    """The render CLIs as subprocesses; each PNG must pass 10 kB."""
    runs = []
    args = [dump_dir, "--out", os.path.join(root, "results.png")]
    if has_h5py:
        args += ["--sample", os.path.join(root, "samples", f"{sample_name}.hdf5"), "--skeleton-every", "100"]
    runs.append(("torch_render_results.py", args, args[2]))
    if has_h5py:
        out = os.path.join(root, "sample.png")
        runs.append(("torch_render_sample.py", [os.path.join(root, "samples", f"{sample_name}.hdf5"), "--out", out],
                     out))
    else:
        print("  h5py is not installed: scripts/torch_render_sample.py (which reads a sample file) not run")
    for script, args, png in runs:
        out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), *args], cwd=root,
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"{script}: {out.stderr[-2000:]}")
        size = os.path.getsize(png)
        check(size > 10_000, f"{script}: {png} is {size} bytes")
        print(f"  scripts/{script}: {os.path.basename(png)} {size} bytes")


def pipeline_phase(workdir, smi, device):
    """The data pipeline phase (12 in the docstring)."""
    import importlib.util

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "pipeline")
    os.makedirs(root)
    os.chdir(root)  # DatasetConfig reads the prior under ./datasets, the board writes ./runs
    try:
        has_h5py = importlib.util.find_spec("h5py") is not None
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        t0 = time.perf_counter()
        samples = pipeline_datagen(root)
        if has_h5py:
            split = pipeline_files(root, samples)
        else:
            print("  h5py is not installed: the samples stay in memory, split by generate_splits' rule")
            split = pipeline_split_in_memory(root, samples)
        datagen_s = time.perf_counter() - t0
        print(f"  datagen: 3 recordings -> {len(samples)} samples ({len(split['train'])} train / "
              f"{len(split['val'])} held out) in {datagen_s:.2f} s")
        run_dir, train_s, model_cfg = pipeline_train(root, samples, split, device, has_h5py)
        pipeline_eval_nn_loss(run_dir, model_cfg, samples, split["val"], device)
        dump_dir, test_s = pipeline_test(root, samples, split, os.path.join(run_dir, "model_final.pth"), device,
                                         has_h5py)
        pipeline_three_nn(device)
        render_s = None
        if has_mpl:
            t0 = time.perf_counter()
            pipeline_render(root, dump_dir, split["val"][0], has_h5py)
            render_s = time.perf_counter() - t0
        else:
            print("  matplotlib is not installed: the render CLIs not run")
        render = "not run" if render_s is None else f"{render_s:.2f} s"
        print(f"[{smi}] data pipeline phase, host seconds: datagen {datagen_s:.2f}, train epoch {train_s:.2f}, "
              f"test run {test_s:.2f}, render {render}; phase wall time {time.perf_counter() - t_phase:.2f} s")
    finally:
        os.chdir(workdir)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    set_precision_policy()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    probe = start_probe_build()
    seconds, reports = kernels.timed_build()
    probe = probe()
    print(f"built {len(kernels.SOURCES)} kernel libraries in {seconds:.2f} s (the latency probe beside them)")
    for name, log in reports.items():
        for kernel, regs, frame, stores, loads in ptxas_usage(log):
            print(f"  {name}.cu {kernel}: {regs} registers, {frame} bytes stack frame, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads")
            check(name != "fps" or frame == stores == loads == 0, f"fps.cu {kernel}: stack frame or spills")

    t0 = time.perf_counter()
    rows = kernel_phase(dev, smi, fps_latency_floor(probe))
    rows.update(train_kernel_phase(dev, smi))
    rows.update(sparse_kernel_phase(dev, smi))
    print(f"kernel phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows.update(bf16_kernel_phase(dev, smi))
    rows.update(bf16_train_kernel_phase(dev, smi))
    print(f"bf16 kernel phase {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        os.chdir(workdir)  # the train runs' TensorBoard boards write to ./runs
        t0 = time.perf_counter()
        launches = serving_phase(workdir, smi)
        print(f"serving phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_launches, _, _ = train_phase(workdir, smi)
        print(f"train phase {time.perf_counter() - t0:.1f} s")
        print("train options phase:")
        options_phase(workdir, smi)
        t0 = time.perf_counter()
        test_launches = test_phase(workdir, smi)
        print(f"test phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        multi_mode_phase(workdir, smi)
        print(f"multi-mode and mesh test phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf16_launches = bf16_serving_phase(workdir, smi)
        print(f"bf16 serving phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf16_test_launches = bf16_test_phase(workdir, smi)
        print(f"bf16 test phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bf16_train_launches = bf16_train_phase(workdir, smi)
        print(f"bf16 train phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ddp_phase(workdir, smi)
        print(f"data-parallel phase {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        print("data pipeline phase:")
        pipeline_phase(workdir, smi, "cuda")
        print(f"data pipeline phase {time.perf_counter() - t0:.1f} s")
        os.chdir(REPO)

    line = {"kernels": [
        {"name": "stgcn_epilogue", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_epilogue.cu",
         "replaces": "pose2room_tpu/ops/stgcn_fused.py:83", "launches": launches["stgcn_epilogue"],
         **rows[("stgcn_epilogue", 1, True)]},
        {"name": "fps", "route": "cuda", "source": "pose2room_tpu_torch/csrc/fps.cu",
         "replaces": "pose2room_tpu/ops/sampling.py:57", "launches": launches["fps"],
         **rows[("fps", 1)]},
        {"name": "stgcn_train_fwd", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_train_fwd.cu",
         "replaces": "pose2room_tpu/ops/stgcn_train.py:103", "launches": train_launches["stgcn_train_fwd"],
         **rows[("stgcn_train_fwd", 8)]},
        {"name": "stgcn_train_bwd", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_train_bwd.cu",
         "replaces": "pose2room_tpu/ops/stgcn_train.py:227", "launches": train_launches["stgcn_train_bwd"],
         **rows[("stgcn_train_bwd", 8)]},
        {"name": "stgcn_sparse", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_sparse.cu",
         "replaces": "pose2room_tpu/ops/stgcn_sparse.py:115", "launches": test_launches["stgcn_sparse"],
         **rows[("stgcn_sparse", "annealed", 1)]},
        {"name": "stgcn_epilogue_bf16", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_epilogue.cu",
         "replaces": "pose2room_tpu/ops/stgcn_fused.py:83", "launches": bf16_launches["stgcn_epilogue_bf16"],
         **rows[("stgcn_epilogue_bf16", 1, True)]},
        {"name": "stgcn_sparse_bf16", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_sparse.cu",
         "replaces": "pose2room_tpu/ops/stgcn_sparse.py:115", "launches": bf16_test_launches["stgcn_sparse_bf16"],
         **rows[("stgcn_sparse_bf16", 1)]},
        {"name": "stgcn_train_fwd_bf16", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_train_fwd.cu",
         "replaces": "pose2room_tpu/ops/stgcn_train.py:103",
         "launches": bf16_train_launches["stgcn_train_fwd_bf16"], **rows[("stgcn_train_fwd_bf16", 8)]},
        {"name": "stgcn_train_bwd_bf16", "route": "cuda", "source": "pose2room_tpu_torch/csrc/stgcn_train_bwd.cu",
         "replaces": "pose2room_tpu/ops/stgcn_train.py:227",
         "launches": bf16_train_launches["stgcn_train_bwd_bf16"], **rows[("stgcn_train_bwd_bf16", 8)]},
    ]}
    print(json.dumps(line))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(sys.argv[2])
    else:
        main()
