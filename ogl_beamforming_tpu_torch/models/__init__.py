"""Model presets."""
from . import presets  # noqa: F401
