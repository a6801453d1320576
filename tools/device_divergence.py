#!/usr/bin/env python3
"""Where the card's and the CPU's runs of one model part, and through
which torch op: the plain step (the engine's one-event step, torch ops)
from one state with one block's uniforms on both devices, event by
event, every leaf compared bit for bit after each event. At an event
whose results differ from equal states, the event runs again on both
devices with every torch op recorded, and the first op that gives other
bits from the same input bits is named, with its inputs and outputs at
the first element that differs. The card's state is then set to the
CPU's, so each event is judged from equal states.

    python3 tools/device_divergence.py       # two-class-chaos, its defended arm, two-class
    python3 tools/device_divergence.py --models superpose --replicas 256 --seed 5

The models are tests/test_torch_multisource_models.py's MULTI_MODELS, at
the replicas and seed of test_torch_gpu.py's comparison of the card's run
with the CPU's (256, seed 5) and its event budget. Prints a line a
divergence and a summary a model, and writes
chiprun_out/device_divergence.json. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from happysim_tpu_torch import model as tmodel, rng  # noqa: E402
from happysim_tpu_torch.engine import _Compiled, _default_max_events, _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step  # noqa: E402
from test_torch_multisource_models import MULTI_MODELS  # noqa: E402

CARD = "cuda"


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU, floats viewed as integers of their width."""
    t = t.detach().cpu()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def same(a, b) -> bool:
    """Bit for bit, a device matching any other."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    if isinstance(a, torch.device) and isinstance(b, torch.device):
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):
        return a is b


# Ops that only ask or name where a tensor lives (a device's attribute or
# constructor), which the two devices' runs take in different numbers.
PLACEMENT = frozenset({"device", "getset_descriptor.__get__"})


class Recorder(TorchFunctionMode):
    """Every torch op of the block it is entered around but PLACEMENT's:
    (name, inputs, outputs), tensors copied to the CPU."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in = [x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x
                   for x in tree_flatten((args, kwargs))[0]]
        out = func(*args, **kwargs)
        flat_out = [x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x
                    for x in tree_flatten(out)[0]]
        name = getattr(func, "__qualname__", getattr(func, "__name__", repr(func)))
        if name not in PLACEMENT:
            self.ops.append((name, flat_in, flat_out))
        return out


def values_at(flat: list, index: int, numel: int) -> list:
    """Each tensor's value at flat ``index`` where it has ``numel``
    elements, else itself if a scalar, else its shape."""
    out = []
    for x in flat:
        if isinstance(x, torch.Tensor):
            if x.numel() == numel:
                v = x.reshape(-1)[index]
                mask = (1 << 8 * x.element_size()) - 1
                out.append(f"{v.item()!r} ({bits(v).item() & mask:#x})" if x.is_floating_point()
                           else v.item())
            elif x.numel() == 1:
                out.append(x.item())
            else:
                out.append(f"tensor{tuple(x.shape)}")
        elif isinstance(x, (int, float, bool)) or x is None:
            out.append(x)
        else:
            out.append(type(x).__name__)
    return out


def first_op(cpu_ops: list, card_ops: list) -> dict:
    """The first op whose inputs agree bit for bit and whose outputs do
    not, on the two recordings of one event."""
    for i, ((name, cin, cout), (name2, gin, gout)) in enumerate(zip(cpu_ops, card_ops)):
        if name != name2 or len(cin) != len(gin):
            return {"op_index": i, "op": name, "note": f"the card ran {name2} here"}
        if not all(same(a, b) for a, b in zip(cin, gin)):
            continue
        for k, (a, b) in enumerate(zip(cout, gout)):
            if same(a, b):
                continue
            if isinstance(a, torch.Tensor) and a.shape == b.shape:
                where = (bits(a) != bits(b)).reshape(-1).nonzero()
                index = int(where[0]) if len(where) else 0
                return {
                    "op_index": i, "op": name, "output": k, "elements": int(len(where)),
                    "element": index, "inputs_at": values_at(cin, index, a.numel()),
                    "cpu_out": values_at([a], index, a.numel())[0],
                    "card_out": values_at([b], index, b.numel())[0],
                }
            return {"op_index": i, "op": name, "output": k, "cpu_out": repr(a), "card_out": repr(b)}
    return {"op": None, "note": f"no op differs from equal inputs ({len(cpu_ops)} ops)"}


def setup(model, device, replicas: int, seed: int) -> tuple:
    compiled = _Compiled(model)
    params = {k: torch.from_numpy(v).to(device)
              for k, v in _resolve_params(model, compiled, replicas, None).items()}
    keys = rng.split(rng.PRNGKey(seed, device=device), replicas)
    return compiled, keys, params, compiled.init_state(keys, params)


def divergences(name: str, replicas: int, seed: int) -> dict:
    model = MULTI_MODELS[name](tmodel)
    cuda = torch.device(CARD)
    c_cpu, k_cpu, p_cpu, s_cpu = setup(model, torch.device("cpu"), replicas, seed)
    c_card, k_card, p_card, s_card = setup(model, cuda, replicas, seed)
    init = sorted(leaf for leaf in s_cpu if not same(s_cpu[leaf], s_card[leaf]))
    if init:
        with Recorder() as rc:
            setup(model, torch.device("cpu"), replicas, seed)
        with Recorder() as rg:
            setup(model, cuda, replicas, seed)
        print(f"{name}: the initial states differ on {init}: {first_op(rc.ops, rg.ops)}")
        s_card = {k: v.to(cuda) for k, v in s_cpu.items()}
    step_cpu, step_card = c_cpu.make_step(), c_card.make_step()
    n_chunks = -(-_default_max_events(model, None) // c_cpu.macro)
    found, events = [], 0
    for block in range(n_chunks):
        if bool(c_cpu.replica_halted(s_cpu).all()):
            break
        u_cpu = event_step.block_uniforms(c_cpu, k_cpu, block)
        u_card = event_step.block_uniforms(c_card, k_card, block)
        if not same(u_cpu, u_card):
            print(f"{name}: block {block}'s uniforms differ")
            found.append({"block": block, "uniforms_differ": True})
        u_card = u_cpu.to(cuda)
        for k in range(u_cpu.shape[1]):
            pre = {leaf: v.clone() for leaf, v in s_cpu.items()}
            step_cpu(s_cpu, p_cpu, u_cpu[:, k, :])
            step_card(s_card, p_card, u_card[:, k, :])
            events += 1
            leaves = sorted(leaf for leaf in s_cpu if not same(s_cpu[leaf], s_card[leaf]))
            if not leaves:
                continue
            replicas_of = {}
            for leaf in leaves:
                diff = bits(s_cpu[leaf]) != bits(s_card[leaf])
                replicas_of[leaf] = sorted({int(r) for r in diff.reshape(diff.shape[0], -1).any(1).nonzero()})
            s_a = {leaf: v.clone() for leaf, v in pre.items()}
            s_b = {leaf: v.to(cuda) for leaf, v in pre.items()}
            with Recorder() as rc:
                step_cpu(s_a, p_cpu, u_cpu[:, k, :])
            with Recorder() as rg:
                step_card(s_b, p_card, u_card[:, k, :])
            op = first_op(rc.ops, rg.ops)
            entry = {"block": block, "event": k, "leaves": replicas_of, **op}
            found.append(entry)
            print(f"{name}: block {block} event {k}: leaves {replicas_of}; first op {op}", flush=True)
            s_card = {leaf: v.to(cuda) for leaf, v in s_cpu.items()}
    ops = Counter(e.get("op") for e in found if "op" in e)
    leaf_count = Counter(leaf for e in found for leaf in e.get("leaves", {}))
    print(f"{name}: {len(found)} divergences in {events} events x {replicas} replicas; by op "
          f"{dict(ops)}; by leaf {dict(leaf_count)}")
    return {"model": name, "replicas": replicas, "seed": seed, "events": events,
            "initial_state_differs_on": init, "divergences": found, "by_op": dict(ops),
            "by_leaf": dict(leaf_count)}


def main() -> int:
    if not torch.cuda.is_available():
        print("device_divergence: torch finds no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--models", default="two-class-chaos,two-class-defended,two-class")
    parser.add_argument("--replicas", type=int, default=256)
    parser.add_argument("--seed", type=int, default=5)
    options = parser.parse_args()
    out = [divergences(name, options.replicas, options.seed) for name in options.models.split(",")]
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/device_divergence.json").write_text(
        json.dumps({"card": torch.cuda.get_device_name(0), "models": out}, indent=1, default=str)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
