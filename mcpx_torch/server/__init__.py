"""``ControlPlane`` and the aiohttp app's ``build_app``. The app is resolved
at first use: a machine without aiohttp (the GPU machine has none) imports
this package and ``server.control`` all the same."""

from mcpx_torch.server.control import ControlPlane

__all__ = ["ControlPlane", "build_app"]


def __getattr__(name: str):
    if name == "build_app":
        from mcpx_torch.server.app import build_app

        return build_app
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
