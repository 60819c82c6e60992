"""``BENCHMARK.json`` and the files it names. A cell pairs a configuration
(``configs/<name>.json``) with a traffic mix (``traffic/<name>.json``),
whose ``stage`` names its driver (``drivers/<stage>.py``); the
configuration's ``architecture`` names the module of its model family
(``architectures/<architecture>.py``, SD's UNet where it names none); each
metric is read by ``metrics/<name>.py`` and each cell's output limits are in
``limits/<cell>.json``. Everything is found by name, so a new cell, mix,
stage, architecture or metric is a new file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
DEFAULT_ARCHITECTURE = "sd"
DEFAULT_DENOISER_GROUP = "unet"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    arch: ModuleType  # the configuration's architecture module

    @property
    def stage(self) -> str:
        return self.traffic["stage"]

    @property
    def denoiser_group(self) -> str:
        """The configuration's group of the denoiser's weights: the
        architecture module's ``DENOISER_GROUP``, "unet" where it names none."""
        return getattr(self.arch, "DENOISER_GROUP", DEFAULT_DENOISER_GROUP)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = HERE) -> dict:
    """``BENCHMARK.json`` at the root of the checkout that holds ``root``."""
    return load_json(root.parent / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = HERE) -> Cell:
    bench = benchmark(root)
    match = [w for w in bench["workloads"] if w["name"] == name]
    if len(match) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = match[0]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    limits_path = root / "limits" / f"{name}.json"
    config = load_json(root / "configs" / f"{w['config']}.json")
    return Cell(
        name=name, chips=w["chips"], config=config,
        traffic=load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path)["limits"] if limits_path.exists() else {},
        end_to_end=e2e, per_layer=per_layer,
        arch=architecture(config.get("architecture", DEFAULT_ARCHITECTURE), root),
    )


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(stage: str, root: Path = HERE) -> ModuleType:
    return _module(root / "drivers" / f"{stage}.py")


def architecture(name: str, root: Path = HERE) -> ModuleType:
    """The module of a model family, which gives the harness and the stage
    drivers everything that depends on the architecture:

    - ``specs(config)``: (the UNet's spec, the ControlNet's or None) of a
      configuration file; a spec has ``cross_attention_dim``, the prompt
      embeddings' width;
    - ``reference_model(kind, group, state_dict=None)``: the plain
      reference's "unet" or "controlnet" of the configuration's group, on the
      meta device (the weights are drawn for its parameters) or holding
      ``state_dict`` in fp32; called as ``reference/steps.py`` says;
    - ``step_ops(stage, unet_spec, controlnet_spec, traffic)``: the
      yardstick's operations of one step of the stage;
    - ``program_model(kind, spec, state_dict)``: the program's model holding
      the state dict;
    - ``model_inputs(spec, prompts, seed, device, dtype)``: (keyword arguments
      for the program's calls, for the reference's) beyond the ``prompts``
      prompt embeddings, made from the seed, one row per prompt;
    - ``inject_sites(spec)``: the PnP sites under the reference's names;
    - optionally ``DENOISER_GROUP``: the configuration's group that holds
      the denoiser's config.json ("transformer" for a DiT; "unet" where the
      module names none), handed to ``reference_model("unet", ...)``.

    The configuration's ``scheduler`` is the harness's, not the module's:
    both sides run its family on it, rectified flow for a
    ``FlowMatchEulerDiscreteScheduler`` (a static ``shift`` over any
    training timesteps; the model outputs the velocity) and DDIM for every
    other class (scaled-linear betas with any start, end, training
    timesteps, ``steps_offset`` and ``set_alpha_to_one``;
    ``prediction_type`` epsilon or v_prediction; ``timestep_spacing``
    leading). ``reference/schedule.py`` lists the keys followed and
    refuses the rest by name."""
    path = root / "architectures" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"architecture {name!r}: no module {path}")
    return _module(path)


def reader(metric: str, root: Path = HERE) -> ModuleType:
    """The module whose ``read(measures)`` gives ``metric``."""
    return _module(root / "metrics" / f"{metric}.py")
