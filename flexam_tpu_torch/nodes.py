"""Graph-node front-end (ComfyUI-compatible node surface).

Port of `flexam_tpu/nodes.py` (behavioural reference: `comfyui/
wan2_2_fun_flexam/nodes.py` (model loader :220-357 with 5 GPU-memory
modes, V2V sampler :455-687), `comfyui/comfyui_nodes.py` (FunAttention
:102-125, FunRiflex :36-51, FunCompile :53-100), `comfyui/annotator/
nodes.py` (annotators and tracking visualizers :116-863)).

The classes follow the ComfyUI node protocol (INPUT_TYPES / RETURN_TYPES /
FUNCTION / CATEGORY + NODE_CLASS_MAPPINGS, the same keys, inputs, defaults
and display names as JAX's), so a ComfyUI install takes them with

    from flexam_tpu_torch.nodes import (NODE_CLASS_MAPPINGS,
                                        NODE_DISPLAY_NAME_MAPPINGS)

and every method is a plain function over numpy arrays that runs
standalone. The models run on CUDA: `LoadFlexAMModel.loadmodel` and the
model annotators take a `device` keyword (not a widget), "cuda" unless the
caller passes "cpu"; the sampler runs on its pipeline's device. OpenCV's
steps (`VideoToCanny`, the KJNodes heatmap, the pose drawing and
DWPose's crops, the flow tracker's Farneback) are the port's own rebuilds
(`utils/cv.py`, `perception/farneback.py`), equal to OpenCV's or within a
bound that their tests state; DWPose's two ONNX graphs run through
`perception/onnx_graph.py` on the annotator's `device`.

Deliberate divergences from JAX's nodes:
  * `LoadFlexAMModel(random_init=...)` draws every model in the DiT's
    dtype (JAX draws the VAE and umT5 in float32), as the demo does; the
    offload modes are kept as strings only (ROADMAP A15);
  * `FunCompile` passes the models through, as JAX's: no torch.compile.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from flexam_tpu_torch.data.bucket_sampler import (ASPECT_RATIO_512,
                                                  get_closest_ratio)


def _tree_to(tree, device):
    """A copy of a parameter tree on `device`."""
    from flexam_tpu_torch.io.convert import map_leaves
    return map_leaves(tree, lambda key, t, in_block: t.to(device, copy=True))


class LoadFlexAMModel:
    """`LoadWan2_2FunModel_FlexAM` (`wan2_2_fun_flexam/nodes.py:220-357`).

    GPU_memory_mode: model_full_load keeps bf16 weights resident;
    *_qfloat8 stores the DiT weights as float8 (`utils/fp8.py`); the
    cpu-offload and sequential modes are accepted and kept as the
    pipeline's `gpu_memory_mode` string, with no offload (ROADMAP A15)."""

    @classmethod
    def INPUT_TYPES(cls):
        # the reference node's exact input surface
        # (`wan2_2_fun_flexam/nodes.py:222-257`)
        return {"required": {
            "model": ("STRING", {"default": "Wan2.2-Fun-5B-FLEXAM"}),
            "model_type": (["Inpaint", "Control"],),
            "GPU_memory_mode": ([
                "model_full_load", "model_full_load_and_qfloat8",
                "model_cpu_offload", "model_cpu_offload_and_qfloat8",
                "sequential_cpu_offload"],),
            "config": ("STRING",
                       {"default": "wan2.2/wan_civitai_5b_FlexAM.yaml"}),
            "precision": (["fp16", "bf16"], {"default": "bf16"}),
        }, "optional": {
            "model_2": ("STRING", {"default": ""}),
        }}

    RETURN_TYPES = ("FunModels",)        # the reference's link type
    RETURN_NAMES = ("funmodels",)
    FUNCTION = "loadmodel"
    CATEGORY = "FlexAM-TPU"

    def loadmodel(self, model, GPU_memory_mode="model_full_load",
                  model_type="Inpaint", random_init=None, model_2=None,
                  config=None, precision="bf16", device="cuda"):
        """`model_2` adds the high-noise expert of the timestep-MoE switch
        (`wan2_2_fun_flexam/nodes.py:266-274`); `config` is a LoadConfig
        output (FlexAMConfig) or the widget's yaml path, and shapes what is
        built; `precision` is accepted for graph parity (compute is bf16 on
        the card). `random_init` "tiny" draws float32 weights of
        `tiny_test_config()`, anything else bf16 at `WAN22_5B_FLEXAM`, each
        from a `torch.Generator` on `device`."""
        import torch

        from flexam_tpu_torch.config import WAN22_5B_FLEXAM, tiny_test_config
        from flexam_tpu_torch.device import resolve_device
        from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                               FlexAMModels)

        if isinstance(config, str):
            config = LoadConfig().process(config)[0] if config else None
        if model_2 == "":
            model_2 = None
        dev = resolve_device(device)
        tiny = random_init == "tiny"
        if tiny:
            cfg = config if config is not None else tiny_test_config()
        else:
            cfg = config if config is not None else WAN22_5B_FLEXAM
        # float32 for tiny (the CPU parity runs); bf16 otherwise, and for a
        # checkpoint on the card (float32 as JAX loads it, then the demo's
        # bf16 cast of the block matrices)
        dtype = torch.float32 if tiny else torch.bfloat16
        load_cast = None if dev.type == "cpu" else torch.bfloat16
        if random_init is not None or not os.path.isdir(str(model)):
            from flexam_tpu_torch.models.dit import init_dit_params
            from flexam_tpu_torch.models.t5 import init_t5_params
            from flexam_tpu_torch.models.vae import init_vae_params
            models = FlexAMModels(
                cfg=cfg,
                dit_params=init_dit_params(cfg.dit, seed=0, dtype=dtype,
                                           device=dev),
                vae_params=init_vae_params(cfg.vae, seed=1, dtype=dtype,
                                           device=dev),
                t5_params=init_t5_params(cfg.t5, seed=2, dtype=dtype,
                                         device=dev))
        else:
            from flexam_tpu_torch.io.checkpoints import (load_dit_checkpoint,
                                                         load_t5_checkpoint,
                                                         load_vae_checkpoint)
            dtype = load_cast or torch.float32
            models = FlexAMModels(
                cfg=cfg,
                dit_params=load_dit_checkpoint(
                    str(model), cfg.dit, dtype=torch.float32, device=dev,
                    matrix_dtype=load_cast),
                vae_params=load_vae_checkpoint(
                    os.path.join(model, "Wan2.2_VAE.pth"), cfg.vae,
                    device=dev),
                t5_params=load_t5_checkpoint(
                    os.path.join(model, "models_t5_umt5-xxl-enc-bf16.pth"),
                    cfg.t5, device=dev),
                t5_from_checkpoint=True)
        if model_2 is not None:
            if os.path.isdir(str(model_2)):
                from flexam_tpu_torch.io.checkpoints import \
                    load_dit_checkpoint
                models.dit2_params = load_dit_checkpoint(
                    str(model_2), models.cfg.dit, dtype=torch.float32,
                    device=dev, matrix_dtype=load_cast)
            else:
                from flexam_tpu_torch.models.dit import init_dit_params
                models.dit2_params = init_dit_params(
                    models.cfg.dit, seed=3, dtype=dtype, device=dev)
        if "qfloat8" in GPU_memory_mode:
            from flexam_tpu_torch.utils.fp8 import convert_weights_to_fp8
            models.dit_params = convert_weights_to_fp8(models.dit_params)
            if models.dit2_params is not None:
                models.dit2_params = convert_weights_to_fp8(
                    models.dit2_params)
        tokenizer = None
        if models.t5_from_checkpoint:
            # a checkpoint's umT5 needs its tokenizer (hashed prompt ids
            # through trained embeddings would ignore the prompt); the
            # reference layout ships it under google/umt5-xxl
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(
                os.path.join(str(model), "google", "umt5-xxl"))
        # the pipeline computes in the DiT weights' dtype (float8 storage
        # in bf16); a checkpoint on the card in bf16, as the demo's
        pipe = FlexAMGenerationPipeline(
            models, tokenizer=tokenizer, device=dev,
            compute_dtype=(load_cast if models.t5_from_checkpoint
                           else None))
        # the offload modes are kept for graph parity (no offload here)
        pipe.gpu_memory_mode = GPU_memory_mode
        return (pipe,)


class FlexAMV2VSampler:
    """`Wan2_2FunV2VSampler_FlexAM.process` (`wan2_2_fun_flexam/nodes.py
    :455-687`): aspect-bucket resolution snap, TeaCache / cfg-skip /
    RIFLEx wiring, fg/bg mask pipelines, LoRA hot-merge with a host-side
    weight cache (`:595-649`), generation on the pipeline's device."""

    GENERATE_TYPES = ("motion_transfer", "fg_generation", "bg_generation")

    @classmethod
    def INPUT_TYPES(cls):
        # the reference node's exact input surface
        # (`wan2_2_fun_flexam/nodes.py:368-454`); extra repo-native knobs
        # (density, enable_riflex, loras) ride the optional section
        return {"required": {
            "funmodels": ("FunModels",),
            "prompt": ("STRING_PROMPT",),
            "negative_prompt": ("STRING_PROMPT",),
            "video_length": ("INT",
                             {"default": 49, "min": 1, "max": 161,
                              "step": 4}),
            "base_resolution": ([512, 640, 768, 896, 960, 1024],
                                {"default": 640}),
            "seed": ("INT", {"default": 43, "min": 0,
                             "max": 0xffffffffffffffff}),
            "steps": ("INT", {"default": 50, "min": 1, "max": 200}),
            "cfg": ("FLOAT", {"default": 6.0, "min": 1.0, "max": 20.0}),
            "denoise_strength": ("FLOAT", {"default": 1.0, "min": 0.05,
                                           "max": 1.0}),
            "scheduler": (["Flow", "Flow_Unipc", "Flow_DPM++"],
                          {"default": "Flow"}),
            "shift": ("INT", {"default": 5, "min": 1, "max": 100}),
            "boundary": ("FLOAT", {"default": 0.900, "min": 0.0,
                                   "max": 1.0}),
            "teacache_threshold": ("FLOAT", {"default": 0.10, "min": 0.0,
                                             "max": 1.0}),
            "enable_teacache": ([False, True], {"default": True}),
            "num_skip_start_steps": ("INT", {"default": 5, "min": 0,
                                             "max": 50}),
            "teacache_offload": ([False, True], {"default": True}),
            "cfg_skip_ratio": ("FLOAT", {"default": 0.0, "min": 0.0,
                                         "max": 1.0}),
            "generate_type": (list(cls.GENERATE_TYPES),
                              {"default": "motion_transfer"}),
            "dilation_pixels": ("INT", {"default": 200, "min": 0,
                                        "max": 1000}),
        }, "optional": {
            "original_video": ("IMAGE",),
            "depth_video": ("IMAGE",),
            "control_video": ("IMAGE",),
            "cos_video0": ("IMAGE",),
            "cos_video1": ("IMAGE",),
            "cos_video2": ("IMAGE",),
            "cos_video3": ("IMAGE",),
            "mask_video": ("IMAGE",),
            "start_image": ("IMAGE",),
            "end_image": ("IMAGE",),
            "ref_image": ("IMAGE",),
            "camera_conditions": ("STRING", {"forceInput": True}),
            "riflex_k": ("RIFLEXT_ARGS",),
            "density": ("FLOAT", {"default": 15.0}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("images",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    SCHEDULER_MAP = {"Flow": "flow_match_euler", "Flow_Unipc": "flow_unipc",
                     "Flow_DPM++": "flow_dpm"}

    def snap_resolution(self, height, width, base_resolution=512):
        """Aspect-bucket snap (`:474-503`): the closest ASPECT_RATIO_512
        bucket scaled by base_resolution / 512, floored to a /16 grid."""
        (bh, bw), _ = get_closest_ratio(height, width, ASPECT_RATIO_512)
        scale = base_resolution / 512.0
        return (int(bh * scale) // 16 * 16, int(bw * scale) // 16 * 16)

    # host-side pristine-weight cache for the LoRA hot-swap
    # (`wan2_2_fun_flexam/nodes.py:595-649`: transformer_cpu_cache +
    # lora_path_before); class-level like the reference's module globals
    _lora_cache: Dict[int, dict] = {}
    _lora_before: Dict[int, str] = {}

    def _apply_loras(self, pipe, loras, strengths, lora_cache):
        """Merge LoRA safetensors (read by `io/checkpoints.
        read_safetensors`) into the DiT weights. With lora_cache the
        pristine weights are kept in host memory and restored before each
        different merge (the reference's CPU state-dict cache); without it,
        the caller unmerges after the run."""
        from flexam_tpu_torch.io.checkpoints import read_safetensors
        from flexam_tpu_torch.utils.lora import merge_lora
        key = id(pipe)
        if lora_cache:
            if key not in self._lora_cache:
                print("Save transformer weights to host memory")
                self._lora_cache[key] = _tree_to(pipe.models.dit_params,
                                                 "cpu")
            now = str(list(loras) + list(strengths))
            if self._lora_before.get(key) != now:
                print("Merge Lora with Cache")
                self._lora_before[key] = now
                pipe.set_dit_params(_tree_to(self._lora_cache[key],
                                             pipe.device))
                for path, w in zip(loras, strengths):
                    pipe.set_dit_params(merge_lora(
                        pipe.models.dit_params, read_safetensors(path), w))
            return []
        if key in self._lora_cache:     # cache -> no-cache transition
            pipe.set_dit_params(_tree_to(self._lora_cache.pop(key),
                                         pipe.device))
            self._lora_before.pop(key, None)
        merged = []
        for path, w in zip(loras, strengths):
            pipe.set_dit_params(merge_lora(
                pipe.models.dit_params, read_safetensors(path), w))
            merged.append((path, w))
        return merged

    def process(self, flexam_model=None, prompt="", validation_video=None,
                control_video=None, depth_video=None, cos_videos=None,
                ref_image=None, mask_video=None, video_length=49,
                base_resolution=512, steps=50, cfg=6.0, seed=43,
                scheduler="Flow", generate_type="motion_transfer",
                density=15.0, enable_teacache=False,
                teacache_threshold=0.10, teacache_skip_start=5,
                cfg_skip_ratio=0.0, enable_riflex=False, riflex_k=None,
                negative_prompt=None, loras=(), strength_model=(),
                lora_cache=False,
                # reference graph-protocol aliases / knobs
                # (`wan2_2_fun_flexam/nodes.py:368-454`)
                funmodels=None, original_video=None, cos_video0=None,
                cos_video1=None, cos_video2=None, cos_video3=None,
                start_image=None, end_image=None, denoise_strength=1.0,
                shift=None, boundary=None, num_skip_start_steps=None,
                teacache_offload=None, dilation_pixels=200,
                camera_conditions=None):
        pipe = funmodels if funmodels is not None else flexam_model
        if validation_video is None:
            validation_video = original_video

        def _pipe_video(x):
            """The pipeline layout ([1,C,T,H,W]) or the ComfyUI IMAGE
            convention ([T,H,W,C], C in {1,3})."""
            if x is None:
                return None
            x = np.asarray(x, np.float32)
            if x.ndim == 4 and x.shape[-1] in (1, 3):
                x = x.transpose(3, 0, 1, 2)[None]
            return x

        validation_video = _pipe_video(validation_video)
        control_video = _pipe_video(control_video)
        depth_video = _pipe_video(depth_video)
        mask_video = _pipe_video(mask_video)
        if cos_videos is None and cos_video0 is not None:
            cos_videos = [c for c in (cos_video0, cos_video1,
                                      cos_video2, cos_video3)
                          if c is not None]
        if cos_videos is not None:
            cos_videos = [_pipe_video(c) for c in cos_videos]
        if num_skip_start_steps is not None:
            teacache_skip_start = num_skip_start_steps
        # teacache_offload: graph parity only (the TeaCache residual stays
        # on the device)
        if denoise_strength != 1.0:
            print("WARNING: denoise_strength is accepted for graph "
                  "parity but ignored (the reference declares it and "
                  "never consumes it either; generation runs at "
                  "strength 1.0)")
        camera_video = None
        if camera_conditions:
            # trajectory JSON -> Plucker camera video for the Control-Camera
            # adapter; the camera alone drives the generation
            # (`wan2_2_fun_flexam/nodes.py:577-583`)
            from flexam_tpu_torch.conditioning.camera import \
                camera_inputs_from_trajectory
            if not getattr(pipe.cfg.dit, "add_control_adapter", False):
                raise ValueError(
                    "camera_conditions needs a Control-Camera model "
                    "(the selected config has add_control_adapter: "
                    "false) — load a Camera-variant config/checkpoint "
                    "or drive the camera through track editing "
                    "(--camera_motion)")
            if validation_video is not None:
                ch, cw = self.snap_resolution(
                    *validation_video.shape[-2:], base_resolution)
            else:
                ch, cw = self.snap_resolution(512, 896, base_resolution)
            camera_video, validation_video, mask_video = \
                camera_inputs_from_trajectory(camera_conditions,
                                              video_length, ch, cw)
            control_video = depth_video = cos_videos = None
        if validation_video is None and start_image is not None:
            # i2v-style seed: first frame(s) known, the rest generated
            # (`get_image_to_video_latent`, utils.py:303-397)
            from flexam_tpu_torch.long_video import window_inputs_from_seed
            img = np.asarray(start_image, np.float32)
            if img.ndim == 3:
                img = img[None]                       # [1, H, W, 3]
            seed_v = img.transpose(3, 0, 1, 2)[None]  # [1, 3, k, H, W]
            h0, w0 = seed_v.shape[-2:]
            validation_video, mask = window_inputs_from_seed(
                seed_v, video_length, h0, w0)
            if end_image is not None:
                e = np.asarray(end_image, np.float32)
                if e.ndim == 3:
                    e = e[None]
                validation_video[:, :, -e.shape[0]:] = \
                    e.transpose(3, 0, 1, 2)[None]
                mask[:, :, -e.shape[0]:] = 0.0
            if mask_video is None:
                mask_video = mask
        if (riflex_k is not None and int(riflex_k) > 0
                and not enable_riflex):
            # a linked RIFLEXT_ARGS input (FunRiflex) enables RIFLEx; 0 is
            # disabled, the reference convention
            enable_riflex, riflex_k = True, int(riflex_k)
        elif not riflex_k:
            riflex_k = 6
        merged_loras = []
        if loras:
            strengths = (list(strength_model)
                         or [1.0] * len(loras))[:len(loras)]
            merged_loras = self._apply_loras(pipe, loras, strengths,
                                             lora_cache)
        v = np.asarray(validation_video, np.float32)
        h, w = v.shape[-2:]
        th, tw = self.snap_resolution(h, w, base_resolution)

        def _snap(x):
            """`jax.image.resize` bilinear (antialiased when it shrinks) of
            any [..., H, W] stream to the snapped bucket (the reference
            runs every stream through get_video_to_video_latent at
            (height, width), `wan2_2_fun_flexam/nodes.py:586-592`), on
            the pipeline's device."""
            if x is None:
                return None
            x = np.asarray(x, np.float32)
            if x.shape[-2:] == (th, tw):
                return x
            import torch

            from flexam_tpu_torch.core.resize import resize
            t = torch.from_numpy(np.ascontiguousarray(x)).to(pipe.device)
            return resize(t, x.shape[:-2] + (th, tw),
                          "bilinear").cpu().numpy()

        if (th, tw) != (h, w):
            v = _snap(v)
        control_video = _snap(control_video)
        depth_video = _snap(depth_video)
        mask_video = _snap(mask_video)
        camera_video = _snap(camera_video)
        if cos_videos is not None:
            cos_videos = [_snap(c) for c in cos_videos]
        if ref_image is not None:
            r = np.asarray(ref_image, np.float32)
            if r.ndim == 4 and r.shape[-1] == 3:
                # ComfyUI IMAGE [1, H, W, 3] -> pipeline [1, 3, 1, H, W]
                r = r[0].transpose(2, 0, 1)[None, :, None]
            ref_image = _snap(r)

        if enable_riflex:
            lat_frames = (video_length - 1) // \
                pipe.cfg.vae.temporal_compression_ratio + 1
            pipe.enable_riflex(k=riflex_k, L_test=lat_frames)

        # mask pipelines (`:537-572`)
        if generate_type == "fg_generation" and mask_video is not None:
            from flexam_tpu_torch.utils.masks import generate_mask_fg_tracking
            m = generate_mask_fg_tracking(np.asarray(mask_video),
                                          dilation_pixels=dilation_pixels,
                                          device=pipe.device)
            mask_video = m.astype(np.float32).transpose(1, 0, 2, 3)[None]
        elif generate_type == "bg_generation" and mask_video is not None:
            from flexam_tpu_torch.utils.masks import generate_mask_bg_tracking
            m = generate_mask_bg_tracking(np.asarray(mask_video))
            mask_video = m.astype(np.float32).transpose(1, 0, 2, 3)[None]

        out = pipe.generate(
            video=v, prompt=prompt, mask_video=mask_video,
            control_video=control_video, depth_video=depth_video,
            cos_videos=cos_videos, ref_image=ref_image,
            camera_video=camera_video,
            negative_prompt=negative_prompt,
            num_inference_steps=steps, guidance_scale=cfg, seed=seed,
            density=1.0 / density,      # `:656-677` hardcodes 1/15
            scheduler_type=self.SCHEDULER_MAP[scheduler],
            shift=float(shift) if shift is not None else None,
            boundary=boundary,
            cfg_skip_ratio=cfg_skip_ratio,
            teacache_thresh=teacache_threshold if enable_teacache else 0.0,
            teacache_skip_start=teacache_skip_start)
        if enable_riflex:
            pipe.disable_riflex()
        if merged_loras:
            from flexam_tpu_torch.io.checkpoints import read_safetensors
            from flexam_tpu_torch.utils.lora import unmerge_lora
            for path, w in reversed(merged_loras):
                pipe.set_dit_params(unmerge_lora(
                    pipe.models.dit_params, read_safetensors(path), w))
        return (out,)


class FunAttention:
    """`FunAttention` (`comfyui_nodes.py:102-125`): the attention backend
    switch, FLEXAM_ATTENTION (the reference's VIDEOX_ATTENTION_TYPE). A
    funmodels pass-through like the reference's, so it can sit on the
    model link; the reference names (flash / sage / torch) map onto the
    port's kernels beside the native names."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "attention_type": (["flash", "sage", "torch", "pallas",
                                "pallas_int8", "sparse", "xla"],
                               {"default": "flash"}),
        }, "optional": {"funmodels": ("FunModels",)}}

    RETURN_TYPES = ("FunModels",)
    RETURN_NAMES = ("funmodels",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    # `core/attention.py` takes the reference spellings directly; this
    # table only documents the kernel each maps to
    REFERENCE_NAMES = {"flash": "pallas", "sage": "pallas_int8",
                       "torch": "xla"}

    def process(self, attention_type, funmodels=None):
        os.environ["FLEXAM_ATTENTION"] = self.REFERENCE_NAMES.get(
            attention_type, attention_type)
        from flexam_tpu_torch.core.attention import _backend_choice
        _backend_choice.cache_clear()
        return (funmodels,)


# the reference's sampler / annotator generate-type names map onto the
# demo's (`wan2_2_fun_flexam/nodes.py:426`)
_GENERATE_TYPE_ALIASES = {"motion_transfer": "full_edit",
                          "fg_generation": "foreground_edit",
                          "bg_generation": "background_edit"}


def _viz_geometry(input_video, height, width):
    """Visualizer geometry: explicit height / width, else from the
    reference's `input_video` link ([T,H,W,3] or [1,3,T,H,W])."""
    if height is not None and width is not None:
        return height, width
    v = np.asarray(input_video)
    if v.ndim == 5:
        return v.shape[-2], v.shape[-1]
    return v.shape[1], v.shape[2]


class VideoToTrackingVisualizeAll:
    """`VideoToTrackingVisualizeAll` (`annotator/nodes.py:863-977`): the
    tracks rasterized into all six control videos in one node, with the
    reference's output arity and names."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_video": ("IMAGE",),
            "pred_tracks": ("TRACKING_DATA",),
            "pred_visibility": ("TRACKING_DATA",),
            "point_size": ("INT", {"default": 4, "min": 1, "max": 20}),
            "cos_level": ("INT", {"default": 4, "min": 1, "max": 8}),
            "generate_type": (["motion_transfer", "fg_generation",
                               "bg_generation"],
                              {"default": "motion_transfer"}),
        }, "optional": {"mask_video": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",) * 6
    RETURN_NAMES = ("tracking_video", "depth_video", "cos_level_0",
                    "cos_level_1", "cos_level_2", "cos_level_3")
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, pred_tracks, pred_visibility, height=None,
                width=None, input_video=None, point_size=None,
                point_wise=4, cos_level=4, generate_type="full_edit",
                mask_video=None):
        from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                                   rasterize_cos_videos,
                                                   rasterize_depth_video,
                                                   rasterize_tracking_video)
        height, width = _viz_geometry(input_video, height, width)
        ps = point_wise if point_size is None else point_size
        generate_type = _GENERATE_TYPE_ALIASES.get(generate_type,
                                                   generate_type)
        tracking = rasterize_tracking_video(
            pred_tracks, pred_visibility, height, width,
            point_wise=ps, mask_video=mask_video,
            generate_type=generate_type)
        enc = cosine_positional_encoding(pred_tracks, height, width,
                                         L=cos_level)
        cos = rasterize_cos_videos(enc, pred_tracks, pred_visibility,
                                   height, width, mask_video=mask_video,
                                   generate_type=generate_type)
        depth = rasterize_depth_video(
            pred_tracks, pred_visibility, height, width,
            point_wise=ps, mask_video=mask_video,
            generate_type=generate_type)
        # a fixed 6-slot output like the reference's (first 4 cos levels)
        return (tracking, depth, *[cos[k] for k in sorted(cos)][:4])


class VideoToTrackingVisualize:
    """`VideoToTrackingVisualize` (`annotator/nodes.py:436-558`): the
    tracking control video alone."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_video": ("IMAGE",),
            "pred_tracks": ("TRACKING_DATA",),
            "pred_visibility": ("TRACKING_DATA",),
            "point_size": ("INT", {"default": 4, "min": 1, "max": 20}),
        }, "optional": {"mask_video": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, pred_tracks, pred_visibility, height=None,
                width=None, input_video=None, point_size=4,
                generate_type="full_edit", mask_video=None):
        from flexam_tpu_torch.conditioning import rasterize_tracking_video
        height, width = _viz_geometry(input_video, height, width)
        generate_type = _GENERATE_TYPE_ALIASES.get(generate_type,
                                                   generate_type)
        return (rasterize_tracking_video(
            pred_tracks, pred_visibility, height, width,
            point_wise=point_size, mask_video=mask_video,
            generate_type=generate_type),)


class VideoToCosVisualize:
    """`VideoToCosVisualize` (`annotator/nodes.py:560-761`): the L
    cosine-PE control videos."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_video": ("IMAGE",),
            "pred_tracks": ("TRACKING_DATA",),
            "pred_visibility": ("TRACKING_DATA",),
            "point_size": ("INT", {"default": 4, "min": 1, "max": 20}),
            "cos_level": ("INT", {"default": 4, "min": 1, "max": 8}),
        }, "optional": {"mask_video": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = ("cos_level_0", "cos_level_1", "cos_level_2",
                    "cos_level_3")
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, pred_tracks, pred_visibility, height=None,
                width=None, input_video=None, point_size=4, cos_level=4,
                generate_type="full_edit", mask_video=None):
        from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                                   rasterize_cos_videos)
        height, width = _viz_geometry(input_video, height, width)
        generate_type = _GENERATE_TYPE_ALIASES.get(generate_type,
                                                   generate_type)
        enc = cosine_positional_encoding(pred_tracks, height, width,
                                         L=cos_level)
        cos = rasterize_cos_videos(enc, pred_tracks, pred_visibility,
                                   height, width, mask_video=mask_video,
                                   generate_type=generate_type)
        return tuple(cos[k] for k in sorted(cos))


class VideoTodepthVisualize:
    """`VideoTodepthVisualize` (`annotator/nodes.py:763-861`): the
    Spectral-colormap depth control video."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_video": ("IMAGE",),
            "pred_tracks": ("TRACKING_DATA",),
            "pred_visibility": ("TRACKING_DATA",),
            "point_size": ("INT", {"default": 4, "min": 1, "max": 20}),
        }, "optional": {"mask_video": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, pred_tracks, pred_visibility, height=None,
                width=None, input_video=None, point_size=4,
                generate_type="full_edit", mask_video=None):
        from flexam_tpu_torch.conditioning import rasterize_depth_video
        height, width = _viz_geometry(input_video, height, width)
        generate_type = _GENERATE_TYPE_ALIASES.get(generate_type,
                                                   generate_type)
        return (rasterize_depth_video(
            pred_tracks, pred_visibility, height, width,
            point_wise=point_size, mask_video=mask_video,
            generate_type=generate_type),)


class VideoToCanny:
    """`VideoToCanny` (`annotator/nodes.py:116-152`): per-frame Canny
    edges (OpenCV's RGB2GRAY and Canny, `utils/cv.py`), as 3-channel
    video. Input [1,3,T,H,W] or [T,H,W,3] float in [0,1]."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_video": ("IMAGE",),
            "low_threshold": ("INT", {"default": 100, "min": 0,
                                      "max": 255}),
            "high_threshold": ("INT", {"default": 200, "min": 0,
                                       "max": 255}),
            "video_length": ("INT", {"default": 81, "min": 1, "max": 81,
                                     "step": 4}),
        }}

    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, input_video, low_threshold=100, high_threshold=200,
                video_length=81):
        from flexam_tpu_torch.utils.cv import canny_u8, rgb_to_gray_cv
        v = np.asarray(input_video, np.float32)
        if v.ndim == 5:                      # [1,3,T,H,W] -> [T,H,W,3]
            v = v[0].transpose(1, 2, 3, 0)
        frames = (v[:video_length] * 255).astype(np.uint8)
        edges = np.stack([canny_u8(rgb_to_gray_cv(f), low_threshold,
                                   high_threshold) for f in frames])
        out = np.repeat(edges[..., None], 3, -1).astype(np.float32) / 255.0
        return (out.transpose(3, 0, 1, 2)[None],)


# External-model annotators. The reference runs Depth-Anything-V2 /
# DWPose-ONNX / DELTA+UniDepth here (`annotator/nodes.py:153-434`). The
# same node names sit on an injectable backend registry: register a
# callable or pass a fixture .npz path; without either, VideoToDepth runs
# the depth registry and VideoToTrackingPredict the trackers.

ANNOTATOR_BACKENDS: Dict[str, object] = {}


def register_annotator_backend(name: str, fn) -> None:
    """fn(video [T,H,W,3] float01, **kw) -> model output (see each node)."""
    ANNOTATOR_BACKENDS[name] = fn


class _ExternalAnnotator:
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"
    BACKEND = ""

    @classmethod
    def INPUT_TYPES(cls):
        # the shared reference annotator surface (`annotator/nodes.py:
        # 153-160,234-241`); fixture is the repo's file-based backend
        return {"required": {
            "input_video": ("IMAGE",),
            "video_length": ("INT", {"default": 81, "min": 1, "max": 81,
                                     "step": 4}),
        }, "optional": {"fixture": ("STRING", {"default": ""})}}

    def _video(self, input_video, video_length):
        v = np.asarray(input_video, np.float32)
        if v.ndim == 5:
            v = v[0].transpose(1, 2, 3, 0)
        return v[:video_length]

    def _run(self, video, fixture=None, **kw):
        if self.BACKEND in ANNOTATOR_BACKENDS:
            return ANNOTATOR_BACKENDS[self.BACKEND](video, **kw)
        if fixture is not None:
            return dict(np.load(fixture))
        raise RuntimeError(
            f"{type(self).__name__} needs an external model: "
            f"register_annotator_backend({self.BACKEND!r}, fn) or pass "
            f"fixture=<npz path> (reference consumes external CUDA "
            f"checkpoints here; its submodule dirs are empty too)")


def depth_to_visualization(depth: np.ndarray) -> np.ndarray:
    """Metric / relative depth [T, H, W] -> the reference node's output
    video: per-frame 2nd / 85th-percentile normalization, inverted (near
    is bright), 3-channel float 0..1 (`annotator/nodes.py:180-190`)."""
    out = np.zeros((*depth.shape, 3), np.float32)
    for i, d in enumerate(np.asarray(depth, np.float32)):
        vmin = np.percentile(d, 2)
        vmax = np.percentile(d, 85)
        d = (d - vmin) / max(vmax - vmin, 1e-9)
        d = np.clip(1.0 - d, 0.0, 1.0)
        out[i] = d[..., None]
    return out


class VideoToDepth(_ExternalAnnotator):
    """`VideoToDepth` (`annotator/nodes.py:153-233`): per-frame depth as a
    control video. A registered 'depth' annotator backend or a fixture
    (key 'depth': [T,H,W,3] 0..1, or metric [T,H,W]) first; else the
    depth registry on `device` (UniDepth, Depth-Anything-V2 or ZoeDepth by
    FLEXAM_UNIDEPTH_CKPT / FLEXAM_DAV2_CKPT / FLEXAM_ZOE_CKPT) and the
    reference's percentile normalization."""
    BACKEND = "depth"

    def process(self, input_video, video_length=81, fixture=None,
                device="cuda"):
        fixture = fixture or None          # ComfyUI passes "" when unset
        v = self._video(input_video, video_length)
        if self.BACKEND not in ANNOTATOR_BACKENDS and fixture is None:
            from flexam_tpu_torch.perception.depth import estimate_depth
            return (depth_to_visualization(estimate_depth(v, device=device))
                    .transpose(3, 0, 1, 2)[None],)
        out = self._run(v, fixture)
        d = np.asarray(out["depth"] if isinstance(out, dict) else out,
                       np.float32)
        if d.ndim == 3:                        # metric [T,H,W] -> video
            d = depth_to_visualization(d)
        return (d.transpose(3, 0, 1, 2)[None],)


class VideoToPose(_ExternalAnnotator):
    """`VideoToPose` (`annotator/nodes.py:234-295`): the DWPose skeleton
    render. Takes (a) a backend or fixture with a rendered 'pose' video
    [T,H,W,3] 0..1, or (b) raw RTMPose keypoints ('keypoints' [T,P,133,2]
    + 'scores' [T,P,133]) drawn by `perception/pose_render.py`, or, with
    neither and FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE set, (c) the native
    DWPose (`perception/dwpose.py`), its two ONNX graphs on `device`."""
    BACKEND = "pose"

    def process(self, input_video, video_length=81, fixture=None,
                device="cuda"):
        fixture = fixture or None          # ComfyUI passes "" when unset
        v = self._video(input_video, video_length)
        if (self.BACKEND not in ANNOTATOR_BACKENDS and fixture is None
                and os.environ.get("FLEXAM_DWPOSE_DET")
                and os.environ.get("FLEXAM_DWPOSE_POSE")):
            # the full native DWPose: YOLOX + RTMPose
            from flexam_tpu_torch.perception.dwpose import dwpose_video
            p = dwpose_video(v, device=device)
            return (p.transpose(3, 0, 1, 2)[None],)
        out = self._run(v, fixture)
        if isinstance(out, dict) and "keypoints" in out:
            from flexam_tpu_torch.perception.pose_render import \
                render_pose_video
            t, h, w = v.shape[:3]
            p = render_pose_video(np.asarray(out["keypoints"]),
                                  np.asarray(out["scores"]), h, w)[:t]
            return (p.transpose(3, 0, 1, 2)[None],)
        p = np.asarray(out["pose"] if isinstance(out, dict) else out,
                       np.float32)
        return (p.transpose(3, 0, 1, 2)[None],)


class VideoToTrackingPredict(_ExternalAnnotator):
    """`VideoToTrackingPredict` (`annotator/nodes.py:296-434`): DELTA
    DenseTrack3D + depth dense 3D tracks when `find_delta_checkpoint()`
    finds a file, a backend or fixture (keys 'tracks' [T,N,3] +
    'visibility' [T,N]), else JAX's baseline, the Farneback flow tracker
    (`perception/tracking.py track_video_flow`). The models and the
    tracker run on `device`."""
    BACKEND = "tracking"
    RETURN_TYPES = ("TRACKING_DATA", "TRACKING_DATA")
    RETURN_NAMES = ("pred_tracks", "pred_visibility")

    @classmethod
    def INPUT_TYPES(cls):
        # `annotator/nodes.py:300-305`: input_video + density
        return {"required": {
            "input_video": ("IMAGE",),
            "density": ("INT", {"default": 10, "min": 1, "max": 100}),
        }, "optional": {
            "video_length": ("INT", {"default": 81, "min": 1, "max": 81,
                                     "step": 4}),
            "fixture": ("STRING", {"default": ""}),
        }}

    def process(self, input_video, density=10, video_length=81,
                fixture=None, device="cuda"):
        fixture = fixture or None          # ComfyUI passes "" when unset
        v = self._video(input_video, video_length)
        if self.BACKEND not in ANNOTATOR_BACKENDS and fixture is None:
            from flexam_tpu_torch.perception import (find_delta_checkpoint,
                                                     track_video_delta,
                                                     track_video_flow)
            ckpt = find_delta_checkpoint()
            if ckpt:      # the learned path, as `annotator/nodes.py:325-362`
                return track_video_delta(v, density=density, ckpt=ckpt,
                                         device=device)
            print("VideoToTrackingPredict: built-in optical-flow baseline "
                  "(drop densetrack3d.pth in ./checkpoints or register a "
                  "backend for learned tracking)")
            tracks, vis = track_video_flow(v, density=density,
                                           device=device)
            return tracks, vis
        out = self._run(v, fixture, density=density)
        return (np.asarray(out["tracks"], np.float32),
                np.asarray(out["visibility"]).astype(bool))


class FunTextBox:
    """`FunTextBox` (`comfyui_nodes.py:19-34`)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "prompt": ("STRING", {"multiline": True, "default": ""})}}

    RETURN_TYPES = ("STRING_PROMPT",)
    RETURN_NAMES = ("prompt",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, prompt):
        return (prompt,)


class FunRiflex:
    """`FunRiflex` (`comfyui_nodes.py:36-51`): riflex_k pass-through for
    the sampler's RIFLEx rope rescale."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "riflex_k": ("INT", {"default": 6, "min": 0, "max": 10086})}}

    RETURN_TYPES = ("RIFLEXT_ARGS",)
    RETURN_NAMES = ("riflex_k",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, riflex_k):
        return (riflex_k,)


class FunCompile:
    """`FunCompile` (`comfyui_nodes.py:53-100`): the reference wraps each
    transformer block in torch.compile. The port's hot loop is its own
    CUDA kernels (B1-B4), so, as JAX's node, this passes the models
    through and compiles nothing."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "cache_size_limit": ("INT", {"default": 64}),
            "funmodels": ("FunModels",)}}

    RETURN_TYPES = ("FunModels",)
    RETURN_NAMES = ("funmodels",)
    FUNCTION = "compile"
    CATEGORY = "FlexAM-TPU"

    def compile(self, cache_size_limit, funmodels):
        print("Add Compile (the hand-written kernels run as they are; "
              "nothing is compiled)")
        return (funmodels,)


class LoadConfig:
    """`LoadConfig` (`comfyui_nodes.py:127-169`): a reference YAML as a
    FlexAMConfig."""

    CONFIGS = [
        "wan2.2/wan_civitai_t2v.yaml",
        "wan2.2/wan_civitai_i2v.yaml",
        "wan2.2/wan_civitai_s2v.yaml",
        "wan2.2/wan_civitai_5b.yaml",
        "wan2.2/wan_civitai_5b_FlexAM.yaml",
        "wan2.1/wan_fun_1_3b.yaml",
        "wan2.1/wan_fun_14b.yaml",
    ]

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "config": (cls.CONFIGS,
                       {"default": "wan2.2/wan_civitai_5b_FlexAM.yaml"})}}

    RETURN_TYPES = ("FunConfig",)
    RETURN_NAMES = ("config",)
    FUNCTION = "process"
    CATEGORY = "FlexAM-TPU"

    def process(self, config, config_dir=None):
        """Looks in JAX's order: the explicit config_dir, then
        FLEXAM_CONFIG_DIR, then the configs bundled with the package
        (`flexam_tpu_torch/configs/`, byte copies of JAX's), then a
        reference checkout if one exists."""
        from flexam_tpu_torch.config import FlexAMConfig
        candidates = []
        if config_dir is not None:
            candidates.append(config_dir)
        if os.environ.get("FLEXAM_CONFIG_DIR"):
            candidates.append(os.environ["FLEXAM_CONFIG_DIR"])
        candidates.append(os.path.join(os.path.dirname(__file__),
                                       "configs"))
        candidates.append(os.path.join("/root/reference", "config"))
        for d in candidates:
            path = os.path.join(d, config)
            if os.path.exists(path):
                return (FlexAMConfig.from_reference_yaml(path),)
        raise FileNotFoundError(
            f"config {config!r} not found in any of {candidates}")


class CreateTrajectoryBasedOnKJNodes:
    """`CreateTrajectoryBasedOnKJNodes` (`comfyui_nodes.py:171-225`):
    gaussian-heatmap trajectory images from coordinate strings."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "coordinates": ("STRING", {"forceInput": True}),
            "masks": ("MASK", {"forceInput": True}),
        }}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "createtrajectory"
    CATEGORY = "FlexAM-TPU"

    @staticmethod
    def _heatmap(size=200, sigma=40.0):
        """`gen_gaussian_heatmap` (`comfyui_nodes.py:155-169`), vectorized;
        the disc is OpenCV's filled circle (`utils/cv.fill_circle`)."""
        from flexam_tpu_torch.utils.cv import fill_circle
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        g = np.exp(-0.5 * (((yy - size / 2) ** 2
                            + (xx - size / 2) ** 2) / sigma ** 2))
        mask = fill_circle(np.zeros((size, size), np.float32),
                           (size // 2, size // 2), size // 2 - 1, 1)
        g = g * mask
        return (g / g.max() * 255).astype(np.uint8)

    def createtrajectory(self, coordinates, masks):
        import json

        from flexam_tpu_torch.utils.media import resize_frames_u8
        if not isinstance(coordinates, str) and len(coordinates) < 10:
            coords_list = [json.loads(c.replace("'", '"'))
                           for c in coordinates]
        else:
            coords_list = [json.loads(coordinates.replace("'", '"'))]
        masks = np.asarray(masks)
        _, fh, fw = masks.shape
        heatmap = self._heatmap()
        circle = int(50 * ((fh * fw) / (1280 * 720)) ** 0.5)

        images_list = []
        for coords in coords_list:
            frames = []
            for c in coords:
                img = np.zeros((fh, fw, 3), np.float32)
                cc = [c[k] for k in c]
                y1 = max(cc[1] - circle, 0)
                y2 = min(cc[1] + circle, fh - 1)
                x1 = max(cc[0] - circle, 0)
                x2 = min(cc[0] + circle, fw - 1)
                if x2 - x1 > 3 and y2 - y1 > 3:
                    need = resize_frames_u8(heatmap[None, :, :, None],
                                            (y2 - y1, x2 - x1))[0]
                    img[y1:y2, x1:x2] = np.maximum(need, img[y1:y2, x1:x2])
                frames.append(img[None] / 255.0)
            images_list.append(np.concatenate(frames, axis=0))
        return (np.max(np.stack(images_list), axis=0),)


class ImageMaximumNode:
    """`ImageMaximumNode` (`comfyui_nodes.py:227-255`): elementwise max of
    two [T,H,W,C] videos, the second resized (`jax.image.resize`'s
    bilinear, `core/resize.py`) and truncated to the first."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"video_1": ("IMAGE",),
                             "video_2": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "imagemaximum"
    CATEGORY = "FlexAM-TPU"

    def imagemaximum(self, video_1, video_2):
        v1 = np.asarray(video_1, np.float32)
        v2 = np.asarray(video_2, np.float32)
        if v1.shape[1:3] != v2.shape[1:3]:
            import torch

            from flexam_tpu_torch.core.resize import resize
            t2 = v2.shape[0]
            v2 = resize(torch.from_numpy(np.ascontiguousarray(v2)),
                        (t2,) + v1.shape[1:3] + (v2.shape[-1],),
                        "bilinear").numpy()
        n = min(len(v1), len(v2))
        return (np.maximum(v1[:n], v2[:n]),)


class ImageCollectNode:
    """`ImageCollectNode` (`comfyui_nodes.py:257-276`)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"image_1": ("IMAGE",)},
                "optional": {"image_2": ("IMAGE",)}}

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    FUNCTION = "imagecollect"
    CATEGORY = "FlexAM-TPU"

    def imagecollect(self, image_1, image_2=None):
        out = [i for i in image_1]
        if image_2 is not None:
            out += [i for i in image_2]
        return (out,)


class CameraBasicFromChaoJie:
    """`CameraBasicFromChaoJie` (`comfyui_nodes.py:278-309`)."""

    @classmethod
    def INPUT_TYPES(cls):
        from flexam_tpu_torch.conditioning.camera_presets import PRESET_NAMES
        return {"required": {
            "camera_pose": (PRESET_NAMES, {"default": "Static"}),
            "speed": ("FLOAT", {"default": 1.0}),
            "video_length": ("INT", {"default": 16})}}

    RETURN_TYPES = ("CameraPose",)
    FUNCTION = "run"
    CATEGORY = "FlexAM-TPU"

    def run(self, camera_pose, speed, video_length):
        from flexam_tpu_torch.conditioning.camera_presets import \
            preset_camera_motion
        return (preset_camera_motion(camera_pose, speed, video_length),)


class CameraCombineFromChaoJie:
    """`CameraCombineFromChaoJie` (`comfyui_nodes.py:311-337`): the sum of
    up to four preset motions as one trajectory."""

    @classmethod
    def INPUT_TYPES(cls):
        from flexam_tpu_torch.conditioning.camera_presets import PRESET_NAMES
        pose = (PRESET_NAMES, {"default": "Static"})
        return {"required": {
            "camera_pose1": pose, "camera_pose2": pose,
            "camera_pose3": pose, "camera_pose4": pose,
            "speed": ("FLOAT", {"default": 1.0}),
            "video_length": ("INT", {"default": 16}),
        }}

    RETURN_TYPES = ("CameraPose",)
    FUNCTION = "run"
    CATEGORY = "FlexAM-TPU"

    def run(self, camera_pose1, camera_pose2="Static",
            camera_pose3="Static", camera_pose4="Static", speed=1.0,
            video_length=16):
        from flexam_tpu_torch.conditioning.camera_presets import \
            combine_presets
        return (combine_presets(
            [camera_pose1, camera_pose2, camera_pose3, camera_pose4],
            speed, video_length),)


class CameraJoinFromChaoJie:
    """`CameraJoinFromChaoJie` (`comfyui_nodes.py:338-357`)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"camera_pose1": ("CameraPose",),
                             "camera_pose2": ("CameraPose",)}}

    RETURN_TYPES = ("CameraPose",)
    FUNCTION = "run"
    CATEGORY = "FlexAM-TPU"

    def run(self, camera_pose1, camera_pose2):
        from flexam_tpu_torch.conditioning.camera_presets import \
            join_camera_motion
        return (join_camera_motion(camera_pose1, camera_pose2),)


class CameraTrajectoryFromChaoJie:
    """`CameraTrajectoryFromChaoJie` (`comfyui_nodes.py:359-390`)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "camera_pose": ("CameraPose",),
            "fx": ("FLOAT", {"default": 0.474812461, "min": 0.0,
                             "max": 1.0, "step": 0.000000001}),
            "fy": ("FLOAT", {"default": 0.844111024, "min": 0.0,
                             "max": 1.0, "step": 0.000000001}),
            "cx": ("FLOAT", {"default": 0.5, "min": 0.0, "max": 1.0}),
            "cy": ("FLOAT", {"default": 0.5, "min": 0.0, "max": 1.0}),
        }}

    RETURN_TYPES = ("STRING", "INT")
    RETURN_NAMES = ("camera_trajectory", "video_length")
    FUNCTION = "run"
    CATEGORY = "FlexAM-TPU"

    def run(self, camera_pose, fx=0.474812461, fy=0.844111024, cx=0.5,
            cy=0.5):
        from flexam_tpu_torch.conditioning.camera_presets import \
            trajectory_json
        return (trajectory_json(camera_pose, fx, fy, cx, cy),
                len(camera_pose))


NODE_CLASS_MAPPINGS = {
    "LoadFlexAMModel": LoadFlexAMModel,
    "FlexAMV2VSampler": FlexAMV2VSampler,
    # reference names (superset parity, `comfyui_nodes.py:393-419`)
    "LoadWan2_2FunModel_FlexAM": LoadFlexAMModel,
    "Wan2_2FunV2VSampler_FlexAM": FlexAMV2VSampler,
    "FunTextBox": FunTextBox,
    "FunRiflex": FunRiflex,
    "FunCompile": FunCompile,
    "FunAttention": FunAttention,
    "LoadConfig": LoadConfig,
    "VideoToCanny": VideoToCanny,
    "VideoToDepth": VideoToDepth,
    "VideoToOpenpose": VideoToPose,
    "VideoToTrackingPredict": VideoToTrackingPredict,
    "VideoToTrackingVisualize": VideoToTrackingVisualize,
    "VideoToCosVisualize": VideoToCosVisualize,
    "VideoTodepthVisualize": VideoTodepthVisualize,
    "VideoToTrackingVisualizeAll": VideoToTrackingVisualizeAll,
    "CreateTrajectoryBasedOnKJNodes": CreateTrajectoryBasedOnKJNodes,
    "CameraBasicFromChaoJie": CameraBasicFromChaoJie,
    "CameraTrajectoryFromChaoJie": CameraTrajectoryFromChaoJie,
    "CameraJoinFromChaoJie": CameraJoinFromChaoJie,
    "CameraCombineFromChaoJie": CameraCombineFromChaoJie,
    "ImageMaximumNode": ImageMaximumNode,
    "ImageCollectNode": ImageCollectNode,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "LoadFlexAMModel": "Load FlexAM Model (TPU)",
    "FlexAMV2VSampler": "FlexAM V2V Sampler (TPU)",
    "LoadWan2_2FunModel_FlexAM": "Load FlexAM Model",
    "Wan2_2FunV2VSampler_FlexAM": "FlexAM Sampler",
    "FunTextBox": "FunTextBox",
    "FunRiflex": "FunRiflex",
    "FunCompile": "FunCompile",
    "FunAttention": "FlexAM Attention Backend",
    "LoadConfig": "Load Config",
    "VideoToCanny": "Video To Canny",
    "VideoToDepth": "Video To Depth",
    "VideoToOpenpose": "Video To Pose",
    "VideoToTrackingPredict": "Video To 3D Tracking Predict",
    "VideoToTrackingVisualize": "Video To 3D Tracking Visualize",
    "VideoToCosVisualize": "Video To Cosine Encoding Visualize",
    "VideoTodepthVisualize": "Video To Depth Visualize",
    "VideoToTrackingVisualizeAll":
        "Video To All Tracking Visualizations (Combined)",
    "CreateTrajectoryBasedOnKJNodes": "Create Trajectory Based On KJNodes",
    "CameraBasicFromChaoJie": "Camera Basic From ChaoJie",
    "CameraTrajectoryFromChaoJie": "Camera Trajectory From ChaoJie",
    "CameraJoinFromChaoJie": "Camera Join From ChaoJie",
    "CameraCombineFromChaoJie": "Camera Combine From ChaoJie",
    "ImageMaximumNode": "Image Maximum Node",
    "ImageCollectNode": "Image Collect Node",
}
