"""URDF asset loader — body definitions as data, not code.

Reference counterpart: the reference loads its bodies from URDF files
(`models/{ground,cart,pole}.urdf`) via Bullet's URDF parser, so users tune
masses/geometry by editing XML (SURVEY.md §2a URDF-assets row; reference
mount empty this session).

Here URDF remains the asset format but the destination is
`CartPoleParams`: `params_from_urdf` reads the same three files (bundled
defaults in ../models_urdf/) and returns the frozen config the compiled
dynamics consumes — geometry edits reach the fused kernel as compile-time
constants. Only the fields this topology uses are read (masses, box/
cylinder geometry, ground friction); anything else is ignored, matching
how the reference's fixed scene used its URDFs.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from .params import CartPoleParams

DEFAULT_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models_urdf")


def _first(root, path, attr=None, default=None, cast=float):
    el = root.find(path)
    if el is None:
        return default
    if attr is None:
        return el
    v = el.get(attr)
    return default if v is None else cast(v)


def load_body(path: str) -> dict:
    """Extract mass + primitive geometry from one URDF file."""
    root = ET.parse(path).getroot()
    out = {"name": root.get("name")}
    out["mass"] = _first(root, ".//inertial/mass", "value", 0.0)
    box = root.find(".//collision/geometry/box")
    if box is not None:
        out["box_size"] = tuple(float(x) for x in box.get("size").split())
    cyl = root.find(".//collision/geometry/cylinder")
    if cyl is not None:
        out["cylinder_length"] = float(cyl.get("length"))
        out["cylinder_radius"] = float(cyl.get("radius"))
    contact = root.find(".//collision/contact_coefficients")
    if contact is not None and contact.get("mu") is not None:
        out["friction"] = float(contact.get("mu"))
    return out


def params_from_urdf(asset_dir: str = DEFAULT_ASSET_DIR,
                     **overrides) -> CartPoleParams:
    """CartPoleParams from {ground,cart,pole}.urdf in `asset_dir`.

    Mapping: cart mass + box half-height -> cart_mass/cart_rest_z; pole
    mass + cylinder length -> pole_mass/pole_length; ground mu ->
    ground_friction. Keyword overrides win over file values.
    """
    cart = load_body(os.path.join(asset_dir, "cart.urdf"))
    pole = load_body(os.path.join(asset_dir, "pole.urdf"))
    ground = load_body(os.path.join(asset_dir, "ground.urdf"))
    kw = dict(
        cart_mass=cart["mass"],
        cart_rest_z=cart["box_size"][2] / 2.0,
        pivot_height=cart["box_size"][2] / 2.0,
        pole_mass=pole["mass"],
        pole_length=pole["cylinder_length"],
        ground_friction=ground.get("friction", 0.0),
    )
    kw.update(overrides)
    return CartPoleParams(**kw)
