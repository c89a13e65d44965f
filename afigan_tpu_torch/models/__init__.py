from .build import build_guide_model, build_model

__all__ = ["build_guide_model", "build_model"]
