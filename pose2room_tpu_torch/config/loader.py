"""YAML config loading, run-dir and logging owner (slim port of
pose2room_tpu/config/loader.py, reference configs/config_utils.py:10-160).

Same YAML surface and per-run layout ``<log.path>/<mode>/<ISO-timestamp>/``
with a ``log.txt`` file logger and an ``out_config.yaml`` snapshot.

In a data-parallel run (``parallel.init_distributed`` before the CONFIG is
built; under torchrun's environment without it the CONFIG raises) every rank holds rank 0's run dir, broadcast to the others, and only
rank 0 (``is_main_process``) makes directories, logs and writes files.  The
JAX package stamps each process's path with its own clock (JAX
config/loader.py:66-67), so its processes can disagree on the run dir and on
what derives from it, such as the multi-mode run salt; here they cannot.
"""

import logging
import os
from datetime import datetime

import yaml

from pose2room_tpu_torch.config.dataset_config import DatasetConfig
from pose2room_tpu_torch.parallel.collectives import broadcast_object, process_index, require_joined


def read_to_dict(input_data):
    """Load a YAML path into a dict (passes dicts through unchanged)."""
    if isinstance(input_data, dict):
        return input_data
    if isinstance(input_data, (str, os.PathLike)) and os.path.isfile(input_data):
        with open(input_data, "r") as f:
            return yaml.safe_load(f)
    raise IOError(f"Cannot read config input: {input_data!r}")


def update_recursive(dict1, dict2):
    """Deep-merge dict2 into dict1 in place."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else v
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


class CONFIG:
    """Owns the merged config dict, the per-run save path and the logger."""

    def __init__(self, config, mode=None):
        self.config = config
        self.config["mode"] = mode or self.config.get("mode", "demo")
        require_joined()
        self.is_main_process = process_index() == 0
        root = self.config.get("log", {}).get("path", "out/p2rnet")
        stamp = datetime.now().isoformat().replace(":", "-")
        save_path = os.path.join(root, self.config["mode"], stamp)
        vis_sub = self.config.get("log", {}).get("vis_path", "visualization")
        if self.is_main_process:
            os.makedirs(os.path.join(save_path, vis_sub), exist_ok=True)
        # after rank 0 made it: every rank reads and resumes from one run dir
        self.save_path = broadcast_object(save_path)
        self.config.setdefault("log", {})["vis_path"] = os.path.join(self.save_path, vis_sub)

        self._logger = logging.getLogger(f"p2r_torch.{id(self)}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        stream = logging.StreamHandler()
        stream.setFormatter(logging.Formatter("%(message)s"))
        self._logger.addHandler(stream)
        if self.is_main_process:
            fh = logging.FileHandler(os.path.join(self.save_path, "log.txt"))
            fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            self._logger.addHandler(fh)

    def log_string(self, content):
        if self.is_main_process:
            self._logger.info(str(content))

    def close(self):
        for handler in list(self._logger.handlers):
            handler.close()
            self._logger.removeHandler(handler)

    def update_config(self, *args, **kwargs):
        cfg1 = dict(kwargs)
        for item in args:
            cfg1.update(read_to_dict(item))
        update_recursive(self.config, cfg1)

    def write_config(self):
        if not self.is_main_process:
            return
        with open(os.path.join(self.save_path, "out_config.yaml"), "w") as f:
            yaml.dump(self.config, f, default_flow_style=False)


def mount_external_config(cfg):
    """Attach the DatasetConfig and the eval knob dict (config_utils.py:140-160)."""
    dataset_config = DatasetConfig(cfg.config.get("data", {}).get("dataset", "virtualhome"))
    cfg.dataset_config = dataset_config
    test_cfg = cfg.config.get("test", {})
    cfg.eval_config = {
        "dataset_config": dataset_config,
        "remove_far_box": test_cfg.get("remove_far_box", True),
        "use_3d_nms": test_cfg.get("use_3d_nms", True),
        "nms_iou": test_cfg.get("nms_iou", 0.1),
        "use_old_type_nms": test_cfg.get("use_old_type_nms", False),
        "cls_nms": test_cfg.get("use_cls_nms", False),
        "per_class_proposal": test_cfg.get("per_class_proposal", True),
        "conf_thresh": test_cfg.get("conf_thresh", 0.05),
        "multi_mode": test_cfg.get("multi_mode", False),
        "sample_cls": test_cfg.get("sample_cls", False),
        # read by the test runner only
        "ap_iou_thresholds": test_cfg.get("ap_iou_thresholds", [0.25, 0.5]),
        "batch_size": test_cfg.get("batch_size", 1),
        "dump_results": cfg.config.get("generation", {}).get("dump_results", False),
    }
    return cfg
