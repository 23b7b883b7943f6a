"""Model zoo of the port: the dense decoder family."""

from repro_torch.models.api import Model, build_model  # noqa: F401
