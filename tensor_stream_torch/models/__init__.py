"""The port's models: VideoViT and its weight converter from flax."""
from .convert import vit_state_dict_from_flax
from .video_vit import VideoViT

__all__ = ["VideoViT", "vit_state_dict_from_flax"]
