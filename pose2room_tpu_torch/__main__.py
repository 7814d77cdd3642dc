"""CLI of the PyTorch port:
``python -m pose2room_tpu_torch --config <yaml> --mode {train,test,demo} [--demo_path <dir>]``.

Same flags as the JAX package's main.py: ``--mode train`` (training with val
phases and checkpoints), ``--mode test`` (AP evaluation of the test split)
and ``--mode demo`` (serving).  Each runs on the CUDA card, or on the CPU
with ``--device cpu``.

Data parallel, one process a card (NCCL; gloo with ``--device cpu`` or
when ranks share a card):

    python -m torch.distributed.run --nproc_per_node N -m pose2room_tpu_torch \
        --config <yaml> --mode {train,test}

``train.batch_size`` is then each process's batch (the reference's 4-GPU
recipe is ``--nproc_per_node 4`` at 8); the test set is sharded and its
metrics merged.  Without torchrun's environment it is one process, as
before.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser("Pose2Room, PyTorch port.")
    parser.add_argument(
        "--config", type=str, default="configs/config_files/p2rnet_test.yaml",
        help="configure file for training or testing.",
    )
    parser.add_argument("--mode", type=str, default="demo", choices=("train", "test", "demo"),
                        help="train, test or demo.")
    parser.add_argument("--demo_path", type=str, default="demo", help="demo input path.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card ('cpu' to run on the host).")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from pose2room_tpu_torch.config.loader import CONFIG, read_to_dict
    from pose2room_tpu_torch.device import resolve_device
    from pose2room_tpu_torch.parallel import in_group, init_distributed, shutdown
    from pose2room_tpu_torch.runners import demo, test, train

    joined = not in_group()
    # before anything is built: the rank's card, and one run dir for all ranks
    init_distributed(args.device)
    cfg = None
    try:
        device = resolve_device(args.device)
        cfg = CONFIG(read_to_dict(args.config), mode=args.mode)
        if args.mode == "demo":
            cfg.update_config(demo_path=args.demo_path)
        cfg.log_string("Loading configurations.")
        cfg.log_string(cfg.config)
        cfg.write_config()
        if args.mode == "train":
            return train.run(cfg, device=device)
        if args.mode == "test":
            return test.run(cfg, device=device)
        return demo.run(cfg, device=device)
    finally:
        if cfg is not None:
            cfg.close()
        if joined:
            shutdown()

if __name__ == "__main__":
    main()
