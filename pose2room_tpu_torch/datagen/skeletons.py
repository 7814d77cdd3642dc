"""Stage-2 skeleton recording: replay interaction scripts, robustly.

Port of pose2room_tpu/datagen/skeletons.py (reference
utils/virtualhome/2_generate_skeletons.py):
walk the stage-1 ``script_bbox/<scene>/script_<room>.json`` tree, replay each
program for every character with pose recording on, and survive a flaky
simulator — per-script timeout (SIGALRM), kill/restart of the simulator on
hang, and a persistent ``failed_script_log.txt`` blacklist so reruns skip
known-bad scripts (2_generate_skeletons.py:18-28, 54-60, 85-104).

The simulator itself is pluggable (the Unity binary is not distributable): a
``make_simulator()`` factory returns a session object with the
UnityCommunication surface used here —

    reset(scene_id)
    expand_scene(graph) -> (success, ...)
    add_character(name, initial_room=...)
    render_script(script, recording=True, save_pose_data=True,
                  output_folder=..., frame_rate=..., **kw) -> (success, msg)
    close()   # optional; called before a restart

so tests drive the full robustness loop with a fake, and a real
UnityCommunication (plus a process-kill/relaunch factory) slots in unchanged.
"""

import json
import os
import signal
from contextlib import contextmanager
from glob import glob

from pose2room_tpu_torch.datagen.programs import CHARACTER_NAMES

FRAME_RATE = 5          # reference dataset_config.py:33
SCRIPT_TIMEOUT_S = 20   # reference 2_generate_skeletons.py:66


class ScriptTimeout(Exception):
    pass


@contextmanager
def time_limit(seconds):
    """SIGALRM-based wall-clock bound (reference 2_generate_skeletons.py:19-28).
    seconds <= 0 disables the limit."""
    if seconds is None or seconds <= 0:
        yield
        return

    def handler(signum, frame):
        raise ScriptTimeout(f"script exceeded {seconds}s")

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class FailureLog:
    """Persistent blacklist of (scene, room, script, character) marks."""

    def __init__(self, path):
        self.path = str(path)

    @staticmethod
    def mark(scene_id, room_id, script_idx, char_idx):
        return f"{scene_id} {room_id} {script_idx} {char_idx}\n"

    def __contains__(self, mark):
        if not os.path.isfile(self.path):
            return False
        with open(self.path) as f:
            return mark in f.readlines()

    def add(self, mark):
        with open(self.path, "a") as f:
            f.write(mark)


def _room_graph_setup(sim, scene_id, graph):
    # scene_id arrives as the stage-1 directory basename (a string); a real
    # UnityCommunication.reset expects an integer environment index
    sim.reset(int(scene_id) if isinstance(scene_id, str) and scene_id.isdigit()
              else scene_id)
    ok = sim.expand_scene(graph)
    assert ok[0] if isinstance(ok, (tuple, list)) else ok


def record_script(sim, scene_id, graph, room_type, character, script,
                  output_path, frame_rate=FRAME_RATE, im_size=(640, 480)):
    """Replay one script with pose recording on; returns render success."""
    _room_graph_setup(sim, scene_id, graph)
    sim.add_character(character, initial_room=room_type)
    success, _ = sim.render_script(
        script,
        image_width=im_size[0],
        image_height=im_size[1],
        recording=True,
        frame_rate=frame_rate,
        image_synthesis=[],
        camera_mode=["PERSON_FROM_BACK"],
        save_pose_data=True,
        output_folder=str(os.path.abspath(output_path)),
        skip_animation=False,
    )
    return success


def render_recordings(
    make_simulator,
    script_bbox_root,
    recording_root,
    scene_graphs,
    *,
    characters=CHARACTER_NAMES,
    timeout_s=SCRIPT_TIMEOUT_S,
    failed_log_path=None,
    frame_rate=FRAME_RATE,
    log=print,
):
    """Stage-2 main loop over every stage-1 script file.

    Args:
        make_simulator: zero-arg factory; called once up front and again after
            every timeout (the reference kills and relaunches Unity,
            2_generate_skeletons.py:96-104).
        script_bbox_root: stage-1 output tree (``<scene>/script_<room>.json``).
        recording_root: output tree; each recording lands at
            ``<scene>/<room>/<script>/<character>/`` (the simulator writes
            ``script/0/pd_script.txt`` underneath, which stage 3 consumes).
        scene_graphs: {scene_id(str or int): graph dict} — the recorded scene
            graphs to replay into the simulator (doors are expected already
            opened by stage 1's recording of them).
    Returns:
        {"recorded": [...], "skipped": [...], "failed": [...], "restarts": n}
    """
    failed_log = FailureLog(
        failed_log_path
        or os.path.join(str(recording_root), "failed_script_log.txt")
    )
    sim = make_simulator()
    stats = {"recorded": [], "skipped": [], "failed": [], "restarts": 0}

    script_files = sorted(
        glob(os.path.join(str(script_bbox_root), "*", "script_*.json"))
    )
    for script_file in script_files:
        scene_id = os.path.basename(os.path.dirname(script_file))
        room_id = os.path.splitext(os.path.basename(script_file))[0].split("_")[-1]
        graph = scene_graphs[scene_id] if scene_id in scene_graphs else (
            scene_graphs[int(scene_id)]
        )
        with open(
            os.path.join(os.path.dirname(script_file),
                         f"room_bbox_{room_id}.json")
        ) as f:
            room_type = json.load(f)["room_type"]
        with open(script_file) as f:
            data = json.load(f)

        for script_idx, script in enumerate(data["scripts"]):
            out_script_dir = os.path.join(
                str(recording_root), scene_id, room_id, str(script_idx)
            )
            os.makedirs(out_script_dir, exist_ok=True)
            with open(os.path.join(out_script_dir, "instance_ids.json"), "w") as f:
                json.dump(data["instance_ids"][script_idx], f)

            for char_idx, character in enumerate(characters):
                out_path = os.path.join(
                    out_script_dir, character.split("/")[-1]
                )
                done_file = os.path.join(
                    out_path, "script", "0", "pd_script.txt"
                )
                if os.path.isfile(done_file):
                    stats["skipped"].append(done_file)
                    continue
                mark = failed_log.mark(scene_id, room_id, script_idx, char_idx)
                if mark in failed_log:
                    stats["skipped"].append(done_file)
                    continue
                os.makedirs(out_path, exist_ok=True)
                try:
                    with time_limit(timeout_s):
                        ok = record_script(
                            sim, scene_id, graph, room_type, character,
                            script, out_path, frame_rate,
                        )
                    if not ok:
                        log(f"render failed: {out_path}")
                        failed_log.add(mark)
                        stats["failed"].append(done_file)
                        continue
                    stats["recorded"].append(done_file)
                except ScriptTimeout:
                    log(f"timeout: {out_path}; restarting simulator")
                    failed_log.add(mark)
                    stats["failed"].append(done_file)
                    close = getattr(sim, "close", None)
                    if close is not None:
                        close()
                    sim = make_simulator()
                    stats["restarts"] += 1
    return stats
