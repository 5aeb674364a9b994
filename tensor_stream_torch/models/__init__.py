"""The port's models: VideoViT with its training step, its weight
converter from flax, and the streaming step with its ring KV cache."""
from .convert import vit_state_dict_from_flax
from .streaming import (clone_cache, init_stream_cache, stream_cache_from_jax,
                        stream_step)
from .video_vit import VideoViT, init_vit, make_vit_train_step, vit_loss

__all__ = ["VideoViT", "clone_cache", "init_stream_cache", "init_vit",
           "make_vit_train_step", "stream_cache_from_jax", "stream_step",
           "vit_loss", "vit_state_dict_from_flax"]
