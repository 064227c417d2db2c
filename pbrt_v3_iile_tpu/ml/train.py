"""IISPTNet training: Adam 6e-5, L1 loss, batch 32, epoch/time budget.

Replaces ml/main_train.py end-to-end (ref: main_train.py:21-156): the
PyTorch single-GPU loop becomes a data-parallel jitted step over the
device mesh with a gradient all-reduce (SURVEY P8); checkpoints are a
pickled or npz parameter tree instead of a torch state_dict.
"""

from __future__ import annotations

import pickle
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..models import iisptnet
from ..parallel import mesh as meshlib
from ..parallel import sharded
from . import dataset as datasetlib

LEARNING_RATE = 6e-5   # (ref: main_train.py:21)
BATCH_SIZE = 32        # (ref: main_train.py:24)
MAX_EPOCHS = 3         # (ref: main_train.py:22)
TIME_BUDGET_S = 3600.0  # (ref: main_train.py MAX_TRAIN_SECONDS 60 min)


def init_training(key, hemi_size: int = 32, mesh=None):
    net, variables = iisptnet.init_params(key, hemi_size)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    optimizer = optax.adam(LEARNING_RATE)
    opt_state = optimizer.init(params)
    if mesh is None:
        mesh = meshlib.make_mesh()
    step = sharded.make_train_step(net, optimizer, mesh)
    return dict(net=net, params=params, batch_stats=batch_stats,
                optimizer=optimizer, opt_state=opt_state, step=step,
                mesh=mesh)


def train(raw_examples, state, key, max_epochs: int = MAX_EPOCHS,
          time_budget_s: float = TIME_BUDGET_S, batch_size: int = BATCH_SIZE,
          log_every: int = 10, log=print):
    """Train on raw example dicts; returns updated state + loss history."""
    t0 = time.time()
    params = state["params"]
    batch_stats = state["batch_stats"]
    opt_state = state["opt_state"]
    step = state["step"]
    losses = []
    it = 0
    for epoch in range(max_epochs):
        for x, y in datasetlib.batches_from_raw(
                raw_examples, batch_size, jax.random.fold_in(key, epoch)):
            params, batch_stats, opt_state, loss = step(
                params, batch_stats, opt_state, x, y)
            losses.append(float(loss))
            it += 1
            if log and it % log_every == 0:
                log(f"epoch {epoch} it {it} loss {losses[-1]:.5f}")
            if time.time() - t0 > time_budget_s:
                break
        if time.time() - t0 > time_budget_s:
            break
    state = dict(state, params=params, batch_stats=batch_stats,
                 opt_state=opt_state)
    return state, losses


def save_checkpoint(path: str, state):
    """Model checkpoint (replaces iispt_model.tch, ref main_train.py:153)."""
    blob = {
        "params": jax.tree.map(np.asarray, state["params"]),
        "batch_stats": jax.tree.map(np.asarray, state["batch_stats"]),
    }
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def load_checkpoint(path: str):
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return {
        "params": jax.tree.map(jnp.asarray, blob["params"]),
        "batch_stats": jax.tree.map(jnp.asarray, blob["batch_stats"]),
    }


def inference_variables(state_or_blob):
    return {"params": state_or_blob["params"],
            "batch_stats": state_or_blob["batch_stats"]}


# ---------------------------------------------------------------------------
# Committed pretrained artifact (the iispt_model.tch role, ref:
# ml/config.py:1): a flat .npz of tree-path -> float16 arrays — compact,
# pickle-free, loadable with numpy alone.
# ---------------------------------------------------------------------------

def _flatten_tree(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_tree(flat):
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(np.asarray(v, np.float32))
    return tree


def save_pretrained(path: str, state_or_blob, dtype=np.float16):
    """Save inference weights as a committed-friendly flat npz."""
    flat = {}
    for top in ("params", "batch_stats"):
        flat.update(_flatten_tree({top: state_or_blob[top]}))
    np.savez_compressed(path, **{k: v.astype(dtype)
                                 for k, v in flat.items()})


def load_pretrained(path: str):
    """Load a save_pretrained artifact -> inference variables dict."""
    z = np.load(path)
    tree = _unflatten_tree({k: z[k] for k in z.files})
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def default_pretrained_path() -> str:
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pretrained", "iispt_pretrained.npz")
