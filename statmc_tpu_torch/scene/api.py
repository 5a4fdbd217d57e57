# Copied from statmc_tpu/scene/api.py (numpy host code; imports rewritten, behaviour unchanged).
"""Graphics-state machine: statements -> SceneDescription.

Functional equivalent of the reference's pbrtapi state machine
(src/core/api.cpp): CTM stack, attribute stack, named
materials/textures, area-light attachment, object instancing, and the
StatMC ExtraParams override channel (api.cpp:190,1433-1441).

The output is a flat, host-side SceneDescription; device SoA tables are
built from it in scene/build.py.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core import math as cm
from .params import ParamSet
from .parser import Statement, parse_statements


@dataclass
class TextureDesc:
    name: str
    tex_class: str  # "imagemap", "constant", "checkerboard", "scale", ...
    value_type: str  # "spectrum" | "float"
    params: ParamSet
    cwd: str = "."


@dataclass
class MaterialDesc:
    mat_type: str
    params: ParamSet
    name: str | None = None  # for named materials


@dataclass
class ShapeDesc:
    shape_type: str
    params: ParamSet
    object_to_world: np.ndarray
    reverse_orientation: bool
    material: MaterialDesc | None
    area_light: Optional[ParamSet]  # "diffuse" params if emissive
    cwd: str = "."
    # MediumInterface in effect at the Shape (api.cpp:1119-1124): named
    # media on each side of the surface ("" / None = vacuum).
    medium_in: str | None = None
    medium_out: str | None = None


@dataclass
class LightDesc:
    light_type: str
    params: ParamSet
    light_to_world: np.ndarray
    cwd: str = "."


@dataclass
class MediumDesc:
    """One MakeNamedMedium record (api.cpp:1101-1117): the params plus
    the CTM at declaration (medium-to-world)."""
    name: str
    params: ParamSet
    medium_to_world: np.ndarray


@dataclass
class SceneDescription:
    integrator_name: str = "path"
    integrator_params: ParamSet = field(default_factory=ParamSet)
    extra_params: ParamSet = field(default_factory=ParamSet)
    sampler_name: str = "random"
    sampler_params: ParamSet = field(default_factory=ParamSet)
    film_params: ParamSet = field(default_factory=ParamSet)
    filter_name: str = "box"
    filter_params: ParamSet = field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = field(default_factory=ParamSet)
    camera_to_world: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    accelerator_name: str = "bvh"
    shapes: list[ShapeDesc] = field(default_factory=list)
    lights: list[LightDesc] = field(default_factory=list)
    textures: dict[str, TextureDesc] = field(default_factory=dict)
    named_materials: dict[str, MaterialDesc] = field(default_factory=dict)
    named_media: dict[str, MediumDesc] = field(default_factory=dict)
    # Camera medium: the outside medium of the MediumInterface in effect
    # at the Camera directive (api.cpp:801-812 passes
    # mediumInterface.outside into every camera constructor).
    camera_medium: str | None = None
    cwd: str = "."


@dataclass
class _GraphicsState:
    material: MaterialDesc = field(
        default_factory=lambda: MaterialDesc("matte", ParamSet())
    )
    area_light: Optional[ParamSet] = None
    reverse_orientation: bool = False
    medium_in: str | None = None
    medium_out: str | None = None


def parse_scene(path: str) -> SceneDescription:
    desc = SceneDescription(cwd=os.path.dirname(os.path.abspath(path)))
    ctm = np.eye(4, dtype=np.float32)
    ctm_stack: list[np.ndarray] = []
    gs = _GraphicsState()
    gs_stack: list[_GraphicsState] = []
    in_world = False
    coord_systems: dict[str, np.ndarray] = {}
    objects: dict[str, list[ShapeDesc]] = {}
    current_object: str | None = None

    def apply(m: np.ndarray) -> None:
        nonlocal ctm
        ctm = (ctm.astype(np.float64) @ m.astype(np.float64)).astype(np.float32)

    for st in parse_statements(path):
        d = st.directive
        if d == "WorldBegin":
            in_world = True
            ctm = np.eye(4, dtype=np.float32)
        elif d == "WorldEnd":
            in_world = False
        elif d == "AttributeBegin":
            gs_stack.append(copy.deepcopy(gs))
            ctm_stack.append(ctm.copy())
        elif d == "AttributeEnd":
            gs = gs_stack.pop()
            ctm = ctm_stack.pop()
        elif d == "TransformBegin":
            ctm_stack.append(ctm.copy())
        elif d == "TransformEnd":
            ctm = ctm_stack.pop()
        elif d == "Identity":
            ctm = np.eye(4, dtype=np.float32)
        elif d == "Transform":
            # pbrt matrices are column-major in file order.
            ctm = np.array(st.floats, dtype=np.float32).reshape(4, 4).T
        elif d == "ConcatTransform":
            apply(np.array(st.floats, dtype=np.float32).reshape(4, 4).T)
        elif d == "Translate":
            apply(cm.translate(st.floats))
        elif d == "Scale":
            apply(cm.scale_mat(st.floats))
        elif d == "Rotate":
            apply(cm.rotate(st.floats[0], st.floats[1:4]))
        elif d == "LookAt":
            w2c = np.linalg.inv(
                cm.look_at(st.floats[0:3], st.floats[3:6], st.floats[6:9]).astype(
                    np.float64
                )
            ).astype(np.float32)
            apply(w2c)
        elif d == "CoordinateSystem":
            coord_systems[st.name] = ctm.copy()
        elif d == "CoordSysTransform":
            ctm = coord_systems.get(st.name, ctm).copy()
        elif d == "ReverseOrientation":
            gs.reverse_orientation = not gs.reverse_orientation
        elif d == "Integrator":
            desc.integrator_name = st.name
            desc.integrator_params = st.params
        elif d == "ExtraParams":
            # StatMC: scene-level overrides of included integrator params
            # (api.cpp:1433-1441; read at statpath.cpp:966,988).
            for k, (t, v) in st.params.items():
                desc.extra_params.add(f"{t} {k}", v)
        elif d == "Sampler":
            desc.sampler_name = st.name
            desc.sampler_params = st.params
        elif d == "PixelFilter":
            desc.filter_name = st.name
            desc.filter_params = st.params
        elif d == "Film":
            desc.film_params = st.params
        elif d == "Camera":
            desc.camera_name = st.name
            desc.camera_params = st.params
            # CTM at Camera is world-to-camera; invert for camera-to-world.
            desc.camera_to_world = np.linalg.inv(
                ctm.astype(np.float64)
            ).astype(np.float32)
        elif d == "Accelerator":
            desc.accelerator_name = st.name
        elif d == "Texture":
            # names: [name, value_type, tex_class]
            names = [st.name] + st.extra_names
            desc.textures[names[0]] = TextureDesc(
                names[0], names[2], names[1], st.params, st.cwd
            )
        elif d == "Material":
            gs.material = MaterialDesc(st.name or "none", st.params)
        elif d == "MakeNamedMaterial":
            mtype = st.params.find_one("type", "matte")
            md = MaterialDesc(mtype, st.params, name=st.name)
            desc.named_materials[st.name] = md
        elif d == "NamedMaterial":
            mat = desc.named_materials.get(st.name)
            if mat is None:
                raise ValueError(f"NamedMaterial {st.name!r} not defined")
            gs.material = mat
        elif d == "AreaLightSource":
            gs.area_light = st.params
        elif d == "LightSource":
            desc.lights.append(LightDesc(st.name, st.params, ctm.copy(), st.cwd))
        elif d == "Shape":
            sd = ShapeDesc(
                st.name, st.params, ctm.copy(), gs.reverse_orientation,
                gs.material, gs.area_light, st.cwd,
                medium_in=gs.medium_in, medium_out=gs.medium_out,
            )
            if current_object is not None:
                objects[current_object].append(sd)
            else:
                desc.shapes.append(sd)
        elif d == "ObjectBegin":
            current_object = st.name
            objects[current_object] = []
            gs_stack.append(copy.deepcopy(gs))
            ctm_stack.append(ctm.copy())
        elif d == "ObjectEnd":
            current_object = None
            gs = gs_stack.pop()
            ctm = ctm_stack.pop()
        elif d == "ObjectInstance":
            for proto in objects.get(st.name, []):
                inst = copy.copy(proto)
                inst.object_to_world = (
                    ctm.astype(np.float64)
                    @ proto.object_to_world.astype(np.float64)
                ).astype(np.float32)
                desc.shapes.append(inst)
        elif d == "MakeNamedMedium":
            # api.cpp:1101-1117: record params + the CTM (medium-to-world).
            desc.named_media[st.name] = MediumDesc(
                st.name, st.params, ctm.copy()
            )
        elif d == "MediumInterface":
            # api.cpp:1119-1124: inside/outside names ("" = vacuum).
            names = [st.name or ""] + list(st.extra_names)
            inside = names[0]
            outside = names[1] if len(names) > 1 else ""
            gs.medium_in = inside or None
            gs.medium_out = outside or None
        else:
            pass
    # Camera rays start in the OUTSIDE medium of the graphics state as
    # it stands at WorldEnd: MakeCamera runs inside pbrtWorldEnd and
    # reads graphicsState.CreateMediumInterface().outside
    # (api.cpp:797-812,1690); pbrtWorldBegin does NOT reset the
    # graphics state, so a pre-world MediumInterface carries through.
    desc.camera_medium = gs.medium_out
    return desc
