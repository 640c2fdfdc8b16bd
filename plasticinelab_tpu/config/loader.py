"""Task config loading: reference-schema YAML -> SceneSpec.

Replicates the reference's yacs semantics without yacs:
- defaults tree from default_config.py, deep-merged with the task YAML
- VARIANTS overlay with elementwise list merge for PRIMITIVES/SHAPES
  (plb/envs/env.py:62-86, plb/envs/utils.py:3-30)
- arithmetic-string values like "0.2/2" or "(127<<16)" are evaluated
  (the reference passes them through Python eval in shape_maker.py:23
  and yacs literal parsing)
- the goal path's version digit is rewritten per variant (env.py:80-82)
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional

from .spec import (
    EnvSpec,
    LossSpec,
    PrimitiveSpec,
    RendererSpec,
    SceneSpec,
    ShapeSpec,
    SimulatorSpec,
)

__all__ = ["load_scene", "load_scene_dict", "resolve_variant", "scene_from_dict"]


def _ev(v: Any) -> Any:
    """Evaluate arithmetic strings like '(0.5, 0.1)' or '0.2/2' or '127<<16'."""
    if isinstance(v, str):
        try:
            return eval(v, {"__builtins__": {}}, {})
        except Exception:
            return v
    if isinstance(v, list):
        return [_ev(x) for x in v]
    return v


def _merge_dict(a: Dict, b: Optional[Dict]) -> Dict:
    """Deep merge b over a (reference envs/utils.py:3-17 semantics)."""
    if b is None:
        return a
    a = copy.deepcopy(a)
    for key, val in b.items():
        if key in a and isinstance(a[key], dict) and isinstance(val, dict):
            a[key] = _merge_dict(a[key], val)
        else:
            a[key] = val
    return a


def _merge_lists(a: List[Dict], b: List[Dict]) -> List[Dict]:
    """Elementwise dict merge (reference envs/utils.py:20-30)."""
    out = []
    for i, x in enumerate(a):
        out.append(_merge_dict(x, b[i]) if i < len(b) else x)
    return out


_DEFAULT_TREE: Dict[str, Any] = {
    "SIMULATOR": {},
    "PRIMITIVES": [],
    "SHAPES": [],
    "RENDERER": {},
    "ENV": {"loss": {"weight": {}}},
    "VARIANTS": [],
}


def load_scene_dict(path: str) -> Dict[str, Any]:
    """Load a task YAML file into the (unresolved) config dict."""
    import yaml  # only reference-schema YAML needs it; shipped specs are JSON

    with open(path) as f:
        raw = yaml.safe_load(f)
    return _merge_dict(_DEFAULT_TREE, raw or {})


def resolve_variant(cfg: Dict[str, Any], version: int) -> Dict[str, Any]:
    """Apply VARIANTS[version-1] and rewrite the goal path's version digit."""
    assert version >= 1
    cfg = copy.deepcopy(cfg)
    variants = cfg.get("VARIANTS") or []
    if variants:
        overlay = copy.deepcopy(variants[version - 1])
        if "PRIMITIVES" in overlay:
            cfg["PRIMITIVES"] = _merge_lists(cfg["PRIMITIVES"], overlay.pop("PRIMITIVES"))
        if "SHAPES" in overlay:
            cfg["SHAPES"] = _merge_lists(cfg["SHAPES"], overlay.pop("SHAPES"))
        cfg = _merge_dict(cfg, overlay)
    cfg["VARIANTS"] = []
    # rewrite ...-v{version}.npy (reference env.py:80-82 replaces name[-5])
    tp = cfg.get("ENV", {}).get("loss", {}).get("target_path", "") or ""
    if tp:
        name = list(tp)
        name[-5] = str(version)
        cfg["ENV"]["loss"]["target_path"] = "".join(name)
    return cfg


def _prim_from_dict(d: Dict[str, Any]) -> PrimitiveSpec:
    d = {k: _ev(v) for k, v in d.items()}
    action = d.pop("action", None) or {}
    kw: Dict[str, Any] = {}
    for fld in (
        "shape", "init_pos", "init_rot", "color", "lower_bound", "upper_bound",
        "friction", "radius", "h", "r", "size", "tx", "ty", "minimal_gap", "init_gap",
    ):
        if fld in d:
            v = d[fld]
            kw[fld] = tuple(v) if isinstance(v, (list, tuple)) else v
    if action:
        kw["action_dim"] = int(_ev(action.get("dim", 0)))
        scale = _ev(action.get("scale", ()))
        if isinstance(scale, (int, float)):
            scale = (scale,)
        kw["action_scale"] = tuple(scale)
    return PrimitiveSpec(**kw)


def _shape_from_dict(d: Dict[str, Any]) -> ShapeSpec:
    d = {k: _ev(v) for k, v in d.items()}
    kw: Dict[str, Any] = {"shape": d["shape"]}
    for fld in ("init_pos", "width", "radius", "n_particles", "color", "init_rot"):
        if fld in d:
            v = d[fld]
            kw[fld] = tuple(v) if isinstance(v, (list, tuple)) else v
    return ShapeSpec(**kw)


def scene_from_dict(cfg: Dict[str, Any]) -> SceneSpec:
    """Build a SceneSpec from a resolved (variant-applied) config dict."""
    sim_d = {k: _ev(v) for k, v in (cfg.get("SIMULATOR") or {}).items()}
    sim_kw = {}
    for fld in (
        "dim", "quality", "yield_stress", "dtype", "max_steps", "n_particles",
        "E", "nu", "ground_friction", "gravity",
    ):
        if fld in sim_d:
            v = sim_d[fld]
            sim_kw[fld] = tuple(v) if isinstance(v, (list, tuple)) else v
    # reference requires float64; our default is float32 unless the task
    # YAML explicitly asks otherwise.
    sim_kw.setdefault("dtype", "float32")

    ren_d = {k: _ev(v) for k, v in (cfg.get("RENDERER") or {}).items()}
    ren_kw = {}
    for fld in (
        "spp", "max_ray_depth", "image_res", "voxel_res", "target_res", "dx",
        "sdf_threshold", "bake_size", "use_roulette", "light_direction",
        "camera_pos", "camera_rot", "use_directional_light", "max_num_particles",
    ):
        if fld in ren_d:
            v = ren_d[fld]
            ren_kw[fld] = tuple(v) if isinstance(v, (list, tuple)) else v

    env_d = cfg.get("ENV") or {}
    loss_d = env_d.get("loss") or {}
    weight_d = loss_d.get("weight") or {}
    loss = LossSpec(
        soft_contact=bool(loss_d.get("soft_contact", False)),
        weight_sdf=float(weight_d.get("sdf", 10.0)),
        weight_density=float(weight_d.get("density", 10.0)),
        weight_contact=float(weight_d.get("contact", 1.0)),
        target_path=str(loss_d.get("target_path", "") or ""),
    )
    env = EnvSpec(loss=loss, n_observed_particles=int(env_d.get("n_observed_particles", 200)))

    return SceneSpec(
        simulator=SimulatorSpec(**sim_kw),
        primitives=tuple(_prim_from_dict(p) for p in (cfg.get("PRIMITIVES") or [])),
        shapes=tuple(_shape_from_dict(s) for s in (cfg.get("SHAPES") or [])),
        renderer=RendererSpec(**ren_kw),
        env=env,
    )


def load_scene(path: str, version: int = 1) -> SceneSpec:
    """Load a task config (.yml reference schema or resolved .json) -> SceneSpec."""
    if path.endswith(".json"):
        with open(path) as f:
            return scene_from_dict(json.load(f))
    cfg = load_scene_dict(path)
    cfg = resolve_variant(cfg, version)
    return scene_from_dict(cfg)


def scene_to_json(scene_cfg: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(scene_cfg, f, indent=1, sort_keys=True)
