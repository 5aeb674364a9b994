"""The port's models: VideoViT with its training step and the streaming
step with its ring KV cache; TransformerNet; the causal VideoVAE; the
latent-diffusion VideoDiT with DDIM sampling and classifier-free guidance;
the Switch-MoE VideoMoE; int8 weight quantization; each model's weight
converter from flax. Every train step replays as a CUDA graph on the card
(``_train.py``)."""
from .convert import (dit_state_dict_from_flax, moe_state_dict_from_flax,
                      pp_params_from_flax,
                      transformer_net_state_dict_from_flax,
                      vae_state_dict_from_flax, vit_state_dict_from_flax)
from .latent_diffusion import (DiffusionSchedule, VideoDiT, ddim_sample,
                               diffusion_loss,
                               make_conditional_diffusion_train_step,
                               make_ddim_sampler, make_diffusion_train_step)
from .moe import VideoMoE, make_moe_train_step, moe_loss, moe_param_specs
from .quantize import (dequantize_weights, quantization_error,
                       quantize_weights, quantized_bytes)
from .streaming import (clone_cache, init_stream_cache, stream_cache_from_jax,
                        stream_step)
from .transformer_net import TransformerNet, gram_matrix, style_transfer_loss
from .video_vae import VideoVAE, make_vae_train_step, vae_loss
from .video_vit import (VideoViT, init_vit, make_act_sharding,
                        make_vit_train_step, vit_loss, vit_param_specs)

__all__ = [
    "DiffusionSchedule", "TransformerNet", "VideoDiT", "VideoMoE",
    "VideoVAE", "VideoViT", "clone_cache", "ddim_sample",
    "dequantize_weights", "diffusion_loss", "dit_state_dict_from_flax",
    "gram_matrix", "init_stream_cache", "init_vit",
    "make_conditional_diffusion_train_step", "make_ddim_sampler",
    "make_diffusion_train_step", "make_moe_train_step", "make_vae_train_step",
    "make_act_sharding", "make_vit_train_step", "moe_loss",
    "moe_param_specs", "moe_state_dict_from_flax", "pp_params_from_flax",
    "quantization_error", "quantize_weights", "quantized_bytes",
    "stream_cache_from_jax", "stream_step", "style_transfer_loss",
    "transformer_net_state_dict_from_flax", "vae_loss",
    "vae_state_dict_from_flax", "vit_loss", "vit_param_specs",
    "vit_state_dict_from_flax"]
