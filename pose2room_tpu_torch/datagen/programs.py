"""Stage-1 program synthesis: VirtualHome scene graph -> interaction scripts.

Port of pose2room_tpu/datagen/programs.py, numpy (scipy's lsq_linear in
``balance_instance_probs``): reference
utils/virtualhome/1_generate_programs.py:29-131 plus the scene-graph half of
utils/virtualhome/vhome_utils.py, run OFFLINE: the Unity simulator binary is not distributable, so everything
operates on a recorded scene-graph JSON (the exact dict
``comm.environment_graph()`` returns — {'nodes': [...], 'edges': [...]}).
The one genuinely Unity-bound step — probing whether a candidate command
really executes in the simulator (vhome_utils.py:504-608 issues
``render_script(skip_execution=True)`` per candidate) — is a pluggable
``probe(command_script) -> bool`` callable; the default accepts everything,
and a live-simulator probe can be dropped in without touching this module.

Pipeline (generate_room_programs):
  scene graph -> open doors -> select room -> collect in-room nodes/edges ->
  refine room bbox from layout geometry -> keep detectable classes ->
  find grabbable props / interactable commands (probe) -> fix door bboxes ->
  balance per-instance selection probabilities -> emit command scripts +
  bbox JSONs in the exact stage-1 output format consumed by stage 3
  (datagen/samples.py).
"""

import itertools
import json
import math
import os
from copy import deepcopy

import numpy as np

from pose2room_tpu_torch.datagen.samples import check_in_box

# interactions the dataset targets (reference configs/dataset_config.py:41)
OBJECT_PROPS = ("CAN_OPEN", "HAS_SWITCH", "SITTABLE", "SURFACES")
# classes never grabbable in Unity despite the GRABBABLE property
NON_GRABBABLE_CLASSES = ("bananas", "wallphone")
# big-object categories excluded from grab candidates
NON_GRABBABLE_CATEGORIES = ("Decor", "Furniture")
N_SEQ_PER_ROOM = 100   # reference dataset_config.py:60
N_INST_PER_ROOM = 10   # reference dataset_config.py:61
CHARACTER_NAMES = (    # reference dataset_config.py:62
    "Chars/Male1", "Chars/Female2", "Chars/Female4", "Chars/Male10", "Chars/Male2",
)

_CMD = {
    "Walk": "<char0> [Walk] <{0}> ({1})",
    "Find": "<char0> [Find] <{0}> ({1})",
    "Grab": "<char0> [Grab] <{0}> ({1})",
    "Open": "<char0> [Open] <{0}> ({1})",
    "Close": "<char0> [Close] <{0}> ({1})",
    "SwitchOn": "<char0> [SwitchOn] <{0}> ({1})",
    "SwitchOff": "<char0> [SwitchOff] <{0}> ({1})",
    "Sit": "<char0> [Sit] <{0}> ({1})",
    "StandUp": "<char0> [StandUp]",
    "Put": "<char0> [Put] <{0}> ({1}) <{2}> ({3})",
    "PutIn": "<char0> [PutIn] <{0}> ({1}) <{2}> ({3})",
    "PutBack": "<char0> [PutBack] <{0}> ({1}) <{2}> ({3})",
}


def _c(verb, node, *more):
    args = [node["class_name"], node["id"]]
    for n in more:
        args += [n["class_name"], n["id"]]
    return _CMD[verb].format(*args)


# ---------------------------------------------------------------------------
# Scene-graph geometry
# ---------------------------------------------------------------------------

def quat_rotation_matrix(q):
    """Rotation matrix from a (w, x, y, z) quaternion (normalized)."""
    w, x, y, z = (float(v) for v in q)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ])


def box_prop(node):
    """(centroid, size, R_mat) of a scene-graph node's oriented bbox.

    Reference semantics (vhome_utils.py:239-253): Unity rotation quaternion ->
    negated rotation matrix with the third row rebuilt by cross product,
    world-axis-aligned size via |R @ size|, plus the fixup for bboxes whose
    up-axis was labelled along x.
    """
    R = -quat_rotation_matrix(node["obj_transform"]["rotation"])
    R[2] = np.cross(R[0], R[1])
    size = np.abs(R.dot(np.asarray(node["bounding_box"]["size"], dtype=np.float64)))
    centroid = np.asarray(node["bounding_box"]["center"], dtype=np.float64)
    if int(np.argmax(np.abs(R[:, 1]))) == 0:
        R = np.array([R[2], -R[0], -R[1]])
        size = np.array([size[2], size[0], size[1]])
    return centroid, size, R


def _bbox_of(node):
    centroid, size, R = box_prop(node)
    return {"centroid": centroid, "size": size, "R_mat": R}


def set_door_states(nodes, state):
    """Force every door's state (reference opens all doors to remove
    ambiguous wall openings, vhome_utils.py:133-143)."""
    for node in nodes:
        if node["class_name"] == "door":
            node["states"] = [state]
    return nodes


def room_nodes_of(graph):
    return [n for n in graph["nodes"] if n.get("category") == "Rooms"]


def nodes_in_room(nodes, edges, room_node):
    """All nodes whose centroid lies in the room bbox + their internal edges;
    door->room INSIDE edges are added when missing (vhome_utils.py:60-100)."""
    room_bbox = _bbox_of(room_node)
    kept = [n for n in nodes if bool(check_in_box(box_prop(n)[0], room_bbox))]
    kept_ids = {n["id"] for n in kept}
    kept_edges = [
        e for e in edges if e["from_id"] in kept_ids and e["to_id"] in kept_ids
    ]
    for n in kept:
        if n["class_name"] != "door":
            continue
        if not any(
            e["from_id"] == n["id"] and e["to_id"] == room_node["id"]
            for e in kept_edges
        ):
            kept_edges.append(
                {"from_id": n["id"], "to_id": room_node["id"],
                 "relation_type": "INSIDE"}
            )
    return kept, kept_edges


def refine_room_bbox(room_node, in_room):
    """Tight room bbox from the layout geometry (walls/ceiling/floor corner
    extents projected into the room frame, vhome_utils.py:145-159)."""
    _, _, R = box_prop(room_node)
    corners = []
    for n in in_room:
        if n.get("category") not in ("Walls", "Ceiling", "Floor", "Floors"):
            continue
        c, s, Rn = box_prop(n)
        vec = np.diag(s / 2.0).dot(Rn)
        for sx, sy, sz in itertools.product((-1, 1), repeat=3):
            corners.append(c + sx * vec[0] + sy * vec[1] + sz * vec[2])
    coeffs = np.asarray(corners).dot(R.T)
    centroid = ((coeffs.max(0) + coeffs.min(0)) / 2.0).dot(R)
    size = np.abs((coeffs.max(0) - coeffs.min(0)).dot(R))
    return {"centroid": centroid, "size": size, "R_mat": R}


def clean_nodes_in_room(in_room, in_edges, room_node):
    """Re-select nodes against the refined room bbox; doors always survive
    (vhome_utils.py:161-183)."""
    room_bbox = refine_room_bbox(room_node, in_room)
    kept, dropped = [], set()
    for n in in_room:
        if bool(check_in_box(box_prop(n)[0], room_bbox)) or n.get("category") == "Doors":
            kept.append(n)
        else:
            dropped.add(n["id"])
    edges = [
        e for e in in_edges
        if e["from_id"] not in dropped and e["to_id"] not in dropped
    ]
    return kept, edges, room_bbox


def filter_nodes(nodes, edges, labels, level="class", mode="include"):
    """Keep/drop nodes by class_name or category (vhome_utils.py:185-218)."""
    key = {"class": "class_name", "category": "category"}[level]
    want = (lambda n: n.get(key) in labels) if mode == "include" else (
        lambda n: n.get(key) not in labels
    )
    kept = [n for n in nodes if want(n)]
    kept_ids = {n["id"] for n in kept}
    dropped = {n["id"] for n in nodes} - kept_ids
    return kept, [
        e for e in edges
        if e["from_id"] not in dropped and e["to_id"] not in dropped
    ]


def correct_door_bbox(det_nodes, in_room):
    """Doors inherit the nearest doorjamb's bbox (a door's own bbox sweeps
    its opening arc; the jamb is the static frame, vhome_utils.py:220-237)."""
    jambs = [n for n in in_room if n["class_name"] == "doorjamb"]
    if not jambs:
        return deepcopy(det_nodes)
    jamb_centers = np.array([n["bounding_box"]["center"] for n in jambs])
    out = deepcopy(det_nodes)
    for n in out:
        if n["class_name"] != "door":
            continue
        d = np.linalg.norm(
            jamb_centers - np.asarray(n["bounding_box"]["center"]), axis=1
        )
        j = jambs[int(np.argmin(d))]
        n["bounding_box"] = j["bounding_box"]
        n["obj_transform"] = j["obj_transform"]
    return out


def to_det_format(nodes):
    """Attach centroid/size/R_mat and drop the raw transform keys
    (vhome_utils.py:398-409) — the format bbox_<room>.json stores and
    stage 3 consumes."""
    out = []
    for n in nodes:
        centroid, size, R = box_prop(n)
        d = {k: v for k, v in n.items()
             if k not in ("obj_transform", "bounding_box")}
        d.update(centroid=centroid, size=size, R_mat=R)
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# Interaction scripts
# ---------------------------------------------------------------------------

def sit_script(node):
    return [_c("Find", node), _c("Sit", node), _CMD["StandUp"]]


def switch_script(node):
    # reference quirk (vhome_utils.py:419-423): the on-state test compares a
    # LIST against a list of strings, so it never matches — effectively
    # always on-then-off; reproduced faithfully.
    return [_c("Walk", node), _c("Find", node),
            _c("SwitchOn", node), _c("SwitchOff", node)]


def open_close_script(node):
    base = [_c("Walk", node), _c("Find", node)]
    if "CLOSED" in node.get("states", []):
        return base + [_c("Open", node), _c("Close", node)]
    return base + [_c("Close", node), _c("Open", node)]


def put_in_script(node, grabbables, rng):
    g = grabbables[int(rng.randint(len(grabbables)))]
    grab = [_c("Walk", g), _c("Find", g), _c("Grab", g)]
    if "CLOSED" in node.get("states", []):
        return grab + [_c("Walk", node), _c("Find", node), _c("Open", node),
                       _c("PutIn", g, node), _c("Close", node)]
    return grab + [_c("Walk", node), _c("Find", node),
                   _c("PutIn", g, node), _c("Close", node), _c("Open", node)]


def surface_script(node, grabbables, rng):
    g = grabbables[int(rng.randint(len(grabbables)))]
    return [_c("Walk", g), _c("Find", g), _c("Grab", g),
            _c("Find", node), _c("Put", g, node),
            _c("Grab", g), _c("PutBack", g, node)]


def find_grabbable_nodes(in_room, in_edges, det_ids, probe):
    """Small props a character can pick up to interact with target objects
    (vhome_utils.py:520-551): GRABBABLE property, not a detection target, not
    furniture/decor, not a known-broken class, not inside a closed container;
    finally verified by the (pluggable) simulator probe."""
    out = []
    for n in in_room:
        if n.get("category") in NON_GRABBABLE_CATEGORIES:
            continue
        if n["class_name"] in NON_GRABBABLE_CLASSES:
            continue
        if "GRABBABLE" not in n.get("properties", []) or n["id"] in det_ids:
            continue
        container_ids = [
            e["to_id"] for e in in_edges
            if e["from_id"] == n["id"] and e["relation_type"] == "INSIDE"
        ]
        container_states = sum(
            (m.get("states", []) for m in in_room
             if m["id"] in container_ids and m.get("category") != "Rooms"),
            [],
        )
        if "CLOSED" in container_states:
            continue
        if probe([_c("Walk", n), _c("Find", n), _c("Grab", n)]):
            out.append(n)
    return out


def interactable_commands(det, grabbables, probe, rng,
                          object_props=OBJECT_PROPS):
    """Per-target interaction scripts, one per supported property
    (vhome_utils.py:560-608).  Returns (kept_nodes, commands_per_node); nodes
    with no probe-approved interaction are dropped, and kept nodes carry only
    their interactable properties."""
    kept, cmds = [], []
    for node in det:
        props = set(node.get("properties", [])) & set(object_props)
        # a kitchencabinet with a door cannot take a PUT without opening it
        if node["class_name"] == "kitchencabinet" and {
            "SURFACES", "CAN_OPEN", "CONTAINERS"
        }.issubset(set(node.get("properties", []))):
            props -= {"SURFACES"}
        ok_props, ok_cmds = [], []
        for prop in sorted(props):
            if prop == "SITTABLE":
                script = sit_script(node)
            elif prop == "HAS_SWITCH":
                script = switch_script(node)
            elif prop == "CAN_OPEN":
                if "CONTAINERS" in node.get("properties", []):
                    if not grabbables:
                        continue
                    script = put_in_script(node, grabbables, rng)
                else:
                    script = open_close_script(node)
            elif prop == "SURFACES":
                if not grabbables:
                    continue
                script = surface_script(node, grabbables, rng)
            else:
                raise NotImplementedError(prop)
            if probe(script):
                ok_props.append(prop)
                ok_cmds.append(script)
        if ok_props:
            n = deepcopy(node)
            n["properties"] = ok_props
            kept.append(n)
            cmds.append(ok_cmds)
    return kept, cmds


def balance_instance_probs(nodes):
    """Per-instance selection probabilities that balance interaction types
    AND object classes: bounded least squares on the indicator matrix
    [interaction-type x instance; class x instance] against all-ones
    (vhome_utils.py:617-655)."""
    from scipy.optimize import lsq_linear

    types = sorted(set(sum((n["properties"] for n in nodes), [])))
    classes = sorted(set(n["class_name"] for n in nodes))
    A = np.zeros((len(types) + len(classes), len(nodes)))
    for i, n in enumerate(nodes):
        for p in n["properties"]:
            A[types.index(p), i] = 1
        A[len(types) + classes.index(n["class_name"]), i] = 1
    b = np.ones(A.shape[0])
    res = lsq_linear(A, b, bounds=(0.1 * np.ones(len(nodes)), np.ones(len(nodes))))
    p = res.x
    return p / p.sum()


def synthesize_programs(det, cmds, rng, n_seq=N_SEQ_PER_ROOM,
                        n_inst=N_INST_PER_ROOM):
    """Instance sequences + full command scripts (vhome_utils.py:635-688).

    Draws up to ``n_seq`` distinct instance orderings (probability-balanced
    subsets of ``n_inst`` when the room has more objects; exhaustive
    permutations/combinations when factorial(N) is small), then expands every
    per-node command alternative via the cartesian product.
    Returns (command_scripts, instance_sequences).
    """
    n = len(det)
    max_n_seq = min(n_seq, math.factorial(n))
    if max_n_seq == n_seq:
        probs = balance_instance_probs(det)
        seqs = []
        for _ in range(max_n_seq):
            if n > n_inst:
                ids = rng.choice(n, n_inst, replace=False, p=probs)
            else:
                ids = rng.permutation(n)
            seqs.append(tuple(int(i) for i in ids))
    elif n > n_inst:
        seqs = list(itertools.combinations(range(n), n_inst))
    else:
        seqs = list(itertools.permutations(range(n)))
    seqs = list(set(seqs))

    scripts, inst_seqs = [], []
    for seq in seqs:
        for combo in itertools.product(*[cmds[i] for i in seq]):
            scripts.append(sum(combo, []))
            inst_seqs.append(list(seq))
    return scripts, inst_seqs


# ---------------------------------------------------------------------------
# Orchestration (reference 1_generate_programs.py:29-131)
# ---------------------------------------------------------------------------

def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


def generate_room_programs(graph, room_id, class_labels_raw, *,
                           probe=None, seed=2, out_dir=None, scene_id=0,
                           n_seq=N_SEQ_PER_ROOM, n_inst=N_INST_PER_ROOM):
    """Full stage-1 pass over one room of a recorded scene graph.

    Args:
        graph: {'nodes': [...], 'edges': [...]} as returned by Unity's
            ``environment_graph()`` (or a recorded JSON of it).
        room_id: index into the scene's room nodes.
        class_labels_raw: detectable raw class names
            (Dataset_Config.class_labels_raw).
        probe: optional ``probe(script) -> bool`` backed by a live simulator;
            default accepts every candidate (offline mode).
        out_dir: when set, writes ``script_<room>.json``, ``bbox_<room>.json``
            and ``room_bbox_<room>.json`` under ``out_dir/<scene_id>/`` in the
            exact stage-1 output layout stage 2/3 consume.
    Returns:
        dict with scripts, instance_ids, nodes_for_det, room_bbox, room_type;
        None when the room has no interactable detection targets.
    """
    if probe is None:
        probe = lambda script: True
    rng = np.random.RandomState(seed)

    nodes = deepcopy(graph["nodes"])
    edges = deepcopy(graph["edges"])
    ids = [n["id"] for n in nodes]
    assert len(set(ids)) == len(ids), "scene graph has duplicate node ids"

    set_door_states(nodes, "OPEN")
    rooms = room_nodes_of({"nodes": nodes})
    if room_id >= len(rooms):
        raise IndexError("Room id exceeds the maximal room count.")
    room_node = rooms[room_id]

    in_room, in_edges = nodes_in_room(nodes, edges, room_node)
    in_room, in_edges, room_bbox = clean_nodes_in_room(
        in_room, in_edges, room_node
    )

    det, det_edges = filter_nodes(
        in_room, in_edges, class_labels_raw, level="class", mode="include"
    )
    if not det:
        return None

    grabbables = find_grabbable_nodes(
        in_room, in_edges, {n["id"] for n in det}, probe
    )
    det, cmds = interactable_commands(det, grabbables, probe, rng)
    if not det:
        return None

    det = correct_door_bbox(det, in_room)
    det = to_det_format(det)

    scripts, inst_seqs = synthesize_programs(det, cmds, rng, n_seq, n_inst)
    result = {
        "scripts": scripts,
        "instance_ids": inst_seqs,
        "nodes_for_det": det,
        "room_bbox": room_bbox,
        "room_type": room_node["class_name"],
    }

    if out_dir is not None:
        scene_dir = os.path.join(str(out_dir), str(scene_id))
        os.makedirs(scene_dir, exist_ok=True)
        with open(os.path.join(scene_dir, f"script_{room_id}.json"), "w") as f:
            json.dump(
                {"scripts": scripts, "instance_ids": _jsonable(inst_seqs)}, f
            )
        with open(os.path.join(scene_dir, f"bbox_{room_id}.json"), "w") as f:
            json.dump(_jsonable(det), f)
        with open(
            os.path.join(scene_dir, f"room_bbox_{room_id}.json"), "w"
        ) as f:
            json.dump(
                {"room_bbox": _jsonable(room_bbox),
                 "room_type": room_node["class_name"]}, f,
            )
    return result
