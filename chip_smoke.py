#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`flexam_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with "phase" and "seconds" when it ends:

  env                  torch / CUDA versions and the card (nvidia-smi);
  build                the CUDA kernels built from csrc/ (one nvcc a
                       source, all started together, then one link), with
                       ptxas's registers / spills by kernel, the Hopper
                       opcodes (HGMMA, IGMMA, UTMALDG, ...) in the SASS of
                       the attention kernels B1, B2, B5 and B6, and the
                       128-bit loads and stores of the row kernels B3, B4;
  kernels              B1, B2, B3 and B4 (both modes) at the flagship
                       shapes, B5 and B6 at the long-clip shape (23,296
                       tokens), each held to its plain PyTorch version, with
                       its time (20 back-to-back launches between two CUDA
                       events, the median of 5 such runs, so the wrapper's
                       host time is not counted), its bound and the library
                       yardstick (B3/B4: GB/s beside out.copy_(x)'s); then
                       B6 on q/k whose size changes from one quantization
                       block to the next, and B2, B3 (RIFLEx tables) and B4
                       at the long path's shapes;
  reference_check      a small head_dim-128 DiT through the kernels on the
                       card against the same DiT on the CPU (plain path),
                       with dense, block-sparse and int8 attention;
  dit_forward_flagship one DiT forward at full width (Wan2.2-Fun-5B,
                       512x896x97f: 11,648 tokens with the ref block, CFG
                       batch 2), random bf16 weights made on the card;
  generate             the main path: the full-width model (umT5-XXL, the
                       48-channel VAE, the DiT) on 512x896x17f with the
                       first frame known, 4 Euler steps at CFG 6.0, T5
                       released after encoding; then a 1-step denoise with
                       no known frame (the broadcast B4 mode). Launch counts
                       are reset just before and read just after;
  generate_from_tracks conditioning from tracks on the same pipeline,
                       weights and prompt context: a grid of 4,680 tracks
                       (density 10, drifting (0.5, 0.2) px a frame,
                       distinct depths) at 512x896x97f. The device
                       rasterizer's six streams are held to the numpy
                       rasterizer's bit for bit (pixels that differ: 0);
                       prepare_conditioning_from_tracks (full_edit, first
                       frame, streamed encode) is timed with its peak
                       memory and held to prepare_conditioning on the
                       numpy-rasterized videos (bound below); then
                       generate_from_cond, 2 Euler steps at CFG 6.0 and
                       the streamed decode, with B1-B4 launched and B5/B6
                       not. At 17 frames (whole-clip encode):
                       foreground_edit with a video, mask video and raster
                       mask (per-token timestep), and background_edit with
                       a video and no mask video, whose denoise step must
                       launch B4's broadcast mode. One more prepare from
                       tracks runs under torch.profiler
                       ("prepare_from_tracks_profile");
  generate_long        the long-clip path on the same pipeline, weights and
                       prompt context: 512x896x201f (23,296 tokens with the
                       ref block), first frame known, RIFLEx (k 6, L_test
                       51), streamed VAE encode and decode, 2 Euler steps at
                       CFG 6.0 through the auto attention ladder (B6 for
                       self-attention); then 1 step under
                       FLEXAM_ATTENTION=sparse (B5). Launch counts are reset
                       and read around each; a profiled step of each
                       follows ("denoise_long_profile");
  checkpoint_load      reference-format checkpoint files at full
                       Wan2.2-Fun-5B width, random bf16 weights: the DiT as
                       two .safetensors shards (2 of 30 blocks),
                       Wan2.2_VAE.pth in full, the umT5 .pth (2 of 24
                       layers); the depth is cut only to bound the disk and
                       the write time. The port's loaders read them back
                       onto the card (seconds and GB/s a file, the full
                       depth extrapolated from the per-block time), every
                       leaf equal to what was written in value and in the
                       dtype JAX's loader gives it; then a 1-step
                       apply_tracks at 512x896x17f on the loaded models
                       (hashed prompt ids under FLEXAM_ALLOW_HASHED_IDS=1),
                       and a 4-step denoise in chunks of 2 with snapshots,
                       resumed from the step-1 snapshot: equal to the
                       uninterrupted run bit for bit;
  demo                 `flexam_tpu_torch.demo.main` in process at
                       --random_init 5b, 512x896, four runs: full_edit with
                       synthetic tracks at 49 frames (6,272 tokens with the
                       ref block, 2 steps, zeros for input); full_edit from
                       a tracks .npz without extrinsics with camera motion
                       (solved poses) and object motion, 49 frames, 2 steps;
                       background_edit at 17 frames with an .npz mask video
                       and an .npy repaint frame, 1 step; full_edit at 17
                       frames, 7 steps, TeaCache threshold 1e9 (5 forwards
                       computed, 2 skipped: B1 launched 5 x 30 times). Each
                       run's stage seconds, peak memory and launch counts
                       (reset before it). Every demo mode passes a mask
                       video, so the blocks run B4's per-token mode, not
                       B4' (which the generate phases cover);
  serving              the serving session, `flexam_tpu_torch.tools.
                       serving_bench.main` in process at Wan2.2-Fun-5B width
                       and 512x896x97f (11,648 tokens, CFG batch 2, random
                       weights from seeds, a random text context and no
                       umT5), in four modes: bf16 (resident), int8 (int8
                       block linears), fp8 (e4m3 weight storage) and int8
                       with --attention sparse (B5), 2 runs of 2 steps each
                       (prepare from tracks, denoise, streamed decode). One
                       line a mode: the records and summary, the peak
                       memory, the resident DiT's bytes and the launches
                       (reset before each mode; the bench hands the first
                       frame, which the pipeline marks known token by token,
                       so the blocks run B4's binary mode; the line says
                       which ran). The int8 tree must hold 300
                       weight_q leaves, the fp8 tree float8 leaves, the
                       sparse run must launch B5. Before the sessions
                       ("serving_checks"): the card's int8 GEMM gives the
                       CPU's int32 accumulators for the same int8 operands;
                       a 5B block's linears quantized on the card equal
                       numpy's quantization byte for byte; one ffn linear
                       at the flagship rows and one flagship forward in int8
                       and in fp8 stay within the bounds below of bf16 (and
                       the int8 forward is profiled);
  serve                the generation server (`flexam_tpu_torch.serve`) as
                       `--host --random_init 5b` builds it (umT5-XXL, the
                       VAE and the DiT resident, random bf16), serving on
                       127.0.0.1 in a thread and driven with http.client
                       only, at 512x896: /health (backend cuda, the card's
                       name); a control-video job, 17f, 2 steps at CFG 6.0,
                       its progress seen at 1/2 and 2/2; a tracks job at
                       97f (11,648 tokens, a first frame, 2 steps) with a
                       job queued behind it (queue_position 0) and
                       cancelled before it runs; an 8-step 17f job
                       cancelled after its first step (it must end
                       cancelled before step 8, device memory back within
                       256 MB); a 33-frame long video in 17-frame windows;
                       camera conditions on a DiT without the adapter (state
                       error, JAX's text); one blocking UI form request
                       (POST /generate). One line a job: wall seconds from
                       submit to result, stage seconds, the host seconds of
                       the result's npz + base64 encoding, peak memory and
                       launches (B1-B4 launched, B5, B6 and the exact branch
                       not); then the B4 mode each job ran;
  serve_cli            `python -m flexam_tpu_torch.serve --host --random_init
                       tiny --platform cuda` in a subprocess and its
                       `--client`, which must receive (1, 3, 9, 32, 32): the
                       tiny config's head_dim 24 through the dispatcher's
                       exact branch on the card;
  serve_camera         the serve phase's weights with a Control-Camera
                       adapter (24 channels, downscale 16, the 5B VAE's
                       compression), a 17-pose camera_conditions request at
                       512x896x17f, 2 steps at CFG 6.0, against the same
                       request without it (finite latents, outputs that
                       differ); the adapter's forward on the CFG batch
                       timed by back-to-back launches;
  track                the video-input path at full width, on a textured
                       512x896x97f clip whose scene moves by (-1, -1) px a
                       frame: (a) UniDepth V2 (ViT-L/14, bf16, random
                       weights) through the depth registry, with seconds,
                       frames/s, tokens a frame, peak and the exact
                       branch's calls; (b) the device flow tracker at
                       density 10 (4,590 tracks) on that depth, held to the
                       known translation (bounds below); (c) DenseTrack3D
                       (the reference config, fp32) written as a
                       reference-format densetrack3d.pth of random values,
                       read back by `load_densetrack3d` (every tensor
                       mapped), and `track_video_delta` on the UniDepth
                       depth, with its windows and early exits; (d) the
                       three models at tiny configs on the card and on the
                       CPU, held to each other (bounds below); (e)
                       `python -m flexam_tpu_torch.tools.track --method
                       delta` on the clip, then `demo.main` at --random_init
                       5b, 49 frames, 1 step, full_edit from the clip: DELTA
                       tracking (FLEXAM_DELTA_CKPT), the Farneback tracker
                       (--tracking_method flow, `track_video_flow` on the
                       card, as JAX's demo runs OpenCV's), and
                       --repaint true, each with its stage seconds, peak and
                       launches (B1-B4 required, B1 30 times a generation:
                       the repaint's frame is a second one; every run
                       passes a mask video, so B4 runs its per-token
                       mode); (f), run before the others while the
                       serve phase's 5B pipeline is resident, one
                       `track_method: "flow"` job over HTTP on a bare 17f
                       clip, 1 step. Launch counts are reset before each run
                       of (e) and (f) and read after it ("track_launches");
  geometry             camera and image geometry at full width, random
                       weights from seeds, fp32: (a) MoGe-2 (ViT-L/14) on
                       one 512x896 frame of a textured clip (518x896 in,
                       2,368 patches), with seconds, peak, the exact
                       branch's calls, the focal, shift and mask share; (b)
                       VGGT through `vggt_video_poses` on a 49-frame
                       512x896 clip (294x518 in: 782 tokens a frame, 38,318
                       in each global layer), whose rotations must equal
                       the identity and translations 0 within 1e-6 (the
                       zero last layer of its camera head); (c) Pi3
                       through `pi3_video_poses` on the same clip (25 views
                       at stride 2, 378x672 in: 1,296 tokens a view),
                       identity poses likewise; (d) the three models at
                       the tiny configs of tests/test_{moge,vggt,pi3}.py on
                       the card and on the CPU, their camera heads' last
                       layers random (bounds below); (e) three `demo.main`
                       runs at --random_init 5b, 49 frames, 1 step, each
                       model read from a reference-format file of the
                       random weights in bf16 (the loader's order, deleted
                       after): an image with FLEXAM_MOGE_CKPT,
                       --object_motion up and --object_mask; the clip with
                       grid tracks, --camera_motion "rot y 10" and
                       FLEXAM_VGGT_CKPT; the clip with --camera_motion path
                       --pose_file path.mp4 (17 frames of it, only its .npz
                       frame dump exists) and FLEXAM_PI3_CKPT, which runs
                       Pi3 for the poses and again on the path video
                       (`process_video_file`). Each run must call its
                       model (and never the track solver), launch B1 30
                       times and B2-B4, and prints its wall, stage seconds,
                       calls and peak ("geometry_launches");
  nodes                the ComfyUI node pack (`flexam_tpu_torch.nodes`) at
                       full width on a textured 512x896x49f clip: (a)
                       VideoToDepth through the depth registry with
                       FLEXAM_DAV2_CKPT (Depth-Anything-V2-Large, fp32,
                       518x910 in: 2,406 tokens a frame), then with only
                       FLEXAM_ZOE_CKPT (ZoeD_M12_N, fp32, 384x672 in: 1,009
                       tokens), each model read from a reference-format
                       file of random bf16 values, the registry's choice
                       asserted, with seconds, frames/s, tokens, peak and
                       the exact branch's calls; (b) VideoToTrackingPredict
                       with no DELTA file (the Farneback tracker on the
                       card, density 10: JAX's node runs OpenCV's
                       Farneback there), VideoToTrackingVisualizeAll on its
                       tracks (six host-rasterized streams) and VideoToCanny
                       (host work, thresholds 30 / 60: the widget's 100 /
                       200 find no edge in this clip); then VideoToPose on
                       a 480x832x49f crop of the clip, the native DWPose
                       (FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE naming the
                       tiny YOLOX- and RTMPose-shaped graphs that
                       `flexam_tpu_torch.testing` writes: no real .onnx file
                       is in the repository) with its two graphs on the
                       card, then again on YOLOX-L and RTMPose-l at their
                       published widths with random weights (`write_dwpose`,
                       two persons a frame), and the raw-keypoint branch (a
                       fixture of seeded keypoints), each timed; (c)
                       LoadFlexAMModel
                       (random_init, Wan2.2-Fun-5B width, bf16) and
                       FlexAMV2VSampler at the widgets' defaults
                       (base_resolution 640: 480x832x49f, 5,460 tokens with
                       the ref frame, CFG 6.0, TeaCache on with 5 skip-start
                       steps) cut to 2 steps, fed (b)'s control, depth and
                       cosine videos and a rank-8 LoRA file written by the
                       smoke, through the host weight cache; the merged
                       weights must differ from the pristine ones, and after
                       a second run at strength 0.5 (1 step) equal the
                       pristine weights merged at 0.5 (restored from the
                       cache first); then one fg_generation step with a mask
                       video and one step after FunAttention("sparse") on a
                       512x512 crop (640x640 after the snap: B5 takes frame
                       blocks of a multiple of 8 tokens, and 480x832 gives
                       390, which runs dense in both packages), which must
                       launch B5 (the backend is put back).
                       Every run launches B2-B4 and not B6, B1 every run
                       but the sparse step, where B5 takes the video
                       self-attention ("nodes_launches"); (d) tiny ZoeDepth
                       and DAv2 on the card against the CPU, Canny of one
                       512x896 frame on the card equal to the host's, the
                       tiny DWPose graphs' outputs and features on 2 frames
                       of the crop on the card against the CPU (bound
                       below) with equal keypoints and rendered frames,
                       YOLOX-L's and RTMPose-l's on 1 frame (bound below,
                       which their weights rounded to TF32 must leave),
                       each graph timed, and Farneback's
                       flow between 3 frames of the crop on the card
                       against the CPU (bound below);
  repaint_flux         the FLUX.1-Depth repaint (`repaint_flux.py`): (a)
                       FLUX.1-Depth-dev at its published widths (hidden
                       3072, 24 heads, 19 double + 38 single blocks,
                       in_channels 128: 11.9 B parameters), T5 v1.1 XXL
                       (4.76 B), CLIP-L text and the FLUX VAE, random bf16
                       weights drawn on the card; one 512x896 repaint of
                       FLUX_STEPS steps (2,304 tokens: 1,792 image + 512
                       T5), with the seconds of the text encode, the VAE
                       encode, each step and the decode, and the peak; B1
                       must launch 57 times a step and nothing else
                       (exact_calls 0); (b) the transformer and VAE written
                       as flux1-depth-dev.safetensors / ae.safetensors in
                       the BFL / ae names (23.8 + 0.17 GB; the free disk
                       printed first, the files deleted after), then
                       `demo.main` at --random_init 5b, --repaint true with
                       FLEXAM_FLUX_CKPT / FLEXAM_FLUX_AE, 17 frames,
                       FLUX_DEMO_STEPS (30) steps: the write and read GB/s,
                       the repaint's seconds and launches (B1 57 x 30 =
                       1,710), the demo's wall and peak; `verify_ckpt
                       --model flux` and `--model flux-ae` on the files;
                       (c) the tiny repainter on the card against the CPU
                       (bound below). The kernels phase holds B1 at
                       FLUX's shape, [1, 2304, 24, 128], and at a ragged
                       2,072 tokens (480x832), timed beside SDPA
                       ("flux_shapes"; "repaint_launches");
  depthcrafter         DepthCrafter (`perception/depthcrafter{,_model}.py`):
                       (a) `estimate_depth` with FLEXAM_DEPTH_BACKEND=
                       depthcrafter on a textured 512x896x32f clip, 2
                       steps, fp32 (JAX's dtype), from files at the
                       published widths (random bf16 values): the SVD UNet
                       (320/640/1280/1280, 1.52 B), the SD VAE with the
                       temporal decoder, the CLIP ViT-H/14 image tower;
                       the seconds of the load, the encode, the CLIP
                       embedding, a UNet pass and the decode, the peak (it
                       must stay under 80 GB), the exact branch's calls
                       and the kernels' launches (all 0: every head is 64
                       wide or 80 or 512), and the largest exact call's
                       fp32 logits unchunked (33 GB at 32 frames x 5 heads
                       x 7,168 tokens) and as `attention_plain` chunks them
                       (1 GiB); (b) the exact branch chunked by rows and by
                       batch elements against one whole chunk on the card
                       (bound below), timed; (c) `verify_ckpt` on the
                       svd-unet, svd-vae and svd-clip files, the `onnx`
                       depth hook on a tiny graph (card against CPU, the
                       bound of the tiny DWPose graphs), and the tiny
                       denoiser on the card against the CPU (bound below)
                       ("depthcrafter_launches").

The flagship phase also runs one more forward under torch.profiler, and a
"dit_forward_profile" line gives its device time by kernel group.

Each kernel is held to its plain version element by element, within a few
bf16 ulps of the element's own size (the bounds and their reasons are in
flexam_tpu_torch/testing.py). Then one JSON line with every kernel's
numbers, the nvidia-smi line, and the result line. TF32 is off for
matmuls and convolutions (torch.backends.cuda.matmul.allow_tf32 /
cudnn.allow_tf32 = False), so fp32 work on the card runs in full fp32. Any
failure raises and exits non-zero.
Without a CUDA device, or without the flexam_tpu_torch package beside this
script, it exits non-zero and prints no result.

The quantized modes against bf16 (serving_checks), relative L2 error. One
linear: int8 rounds each token's activations to steps of amax/127 and each
weight row to its own; for random activations amax is about 3.9 standard
deviations over 3072 features, for the uniform (xavier) weights 1.73, so
the output's error is sqrt(3.9^2 + 1.73^2) / (127 sqrt 12) = 0.0097 of its
size. e4m3 keeps 3 mantissa bits (a rounding error of 2^-3 / sqrt 12 of a
weight's binade) above 2^-6, and below 2^-6, where it is subnormal, a fixed
step of 2^-9: the random ffn weights (xavier, |w| < 0.0186) lie mostly
there, so the error is about 2^-9 / sqrt 12 = 5.6e-4 against a weight rms
of 0.0107, 0.053 of the output (q/k/v/o, |w| < 0.031: about 0.03). Bound
for one linear: twice that, 0.02 (JAX's own test bound for int8) and 0.1.
A forward runs 30 blocks whose branch errors add independently in the
residual stream, at most sqrt(30) times one linear's error: int8 0.053,
fp8 0.29; the bounds are 0.06 and 0.3.

The flow tracker against the known translation (track (b)). A step's
error is the dense flow's error at the track: the LK design (4 pyramid
levels, 4 iterations a level, 15x15 windows, at half resolution above 384p)
leaves 0.23 px per axis a step on this texture, unbiased (`python -m
flexam_tpu_torch.tools.flow_accuracy --platform cpu`, this phase's clip and
seed, on the CPU, where the port equals the JAX package). Under an integer translation a track sees the same texture at
every step, so its step errors are correlated: after 96 steps its error
lies between the random walk's sqrt(96) x 0.23 = 2.3 px and the straight
line's 96 x 0.23 = 22 px per axis; the CPU run gives 7.0 px per axis, a
median end-point error of 8.07 px (p90 15.3), a mean error vector of
0.30 px, and 0.85 of the tracks that stay inside visible at the end. The
card computes the same function with other rounding, which reshuffles the
walk, not its spread. Bounds: median end-point error under 12 px (1.5 x the
CPU's), mean error vector under 1.5 px, visible share at least 0.5. A
fault of sign, scale or indexing moves the end points by tens of pixels (a
tracker that does not move: 136 px).

The card against the CPU (track (d)), the same tiny models in fp32 on both
(TF32 off). Their sums run in other orders (cuBLAS, cuDNN, the GPU's
reductions), which changes a K-term fp32 sum by at most about K x 2^-24 of
its size, 1e-4 for the widest (K = 1536), and typically 1e-6. DenseTrack3D's
positions move only by its delta head's outputs (about 1e-2 cells at
random init) and are otherwise grid coordinates passed through resizes and
a convex upsample, so their difference stays near 1e-5 of ~100 px: bound
1e-2 px; visibilities (sigmoids of O(1) logits) 1e-3, with a flip allowed
only where the CPU's value lies within 1e-3 of 0.5; depths and UniDepth's
outputs 1e-3 of their largest value. The flow tracker's chained positions
are bounded the same (1e-2 px) where both keep a track; a forward-backward
or border test may decide a track otherwise only where its value sits at
the threshold, so at most 1 % of the visibility entries may differ.

The card against the CPU for the geometry models (geometry (d)), the same
argument: their widest sums have K <= 1,536 terms, so outputs within 1e-3
of their largest value. MoGe's mask is `logits > 0`: an entry may flip only
where the CPU's logit lies within 1e-3 of its largest |logit| of 0, and a
flip changes the points the focal/shift solver sees, so the points, depth
and intrinsics are compared only where no entry flipped (the count is
printed); the normals always.

The card against the CPU for the node pack's depth models (nodes (d)):
the same argument at K <= 576, outputs within 1e-3 of their largest value;
Canny is integer work, so its edges must be equal. The DWPose graphs run
with TF32 off inside the call (`perception/onnx_graph.py`). The tiny pair
(`flexam_tpu_torch/testing.py`), with their intermediate features as
outputs, sums at most K = 392 terms (the 7x7 conv over 8 channels): every
output within NODES_GRAPH_REL = 1e-5 of its largest value, the bound its
CPU test holds it to against OpenCV's dnn and which weights rounded to
TF32 leave by 50x or more. Their keypoints then must be equal: the image
picks each SimCC row's argmax by the sign of a function of the row's
tokens, through a clamp that is exact away from a window of 5e-7, and the
detector's boxes come from dyadic weights that every order of summation
gives exactly; the rendered frames may differ only where a score sits
within the outputs' difference of a threshold, at most
NODES_POSE_DIFF_SHARE of the pixels. YOLOX-L and RTMPose-l at their
published widths (random weights) sum up to K = 9216 terms (3x3 over 1024
channels) through about 150 layers: their outputs within
NODES_PUBLISHED_REL = 1e-5 of their largest value, and the same graphs
with their weights rounded to TF32 must leave that bound, so the check
tells TF32 from fp32.
Farneback's flow is elementwise float32 work, index gathers and float64
box sums in both places: a probe on the H100 found the card equal to the
CPU, and the bound, NODES_FLOW_CARD_CPU_PX of end-point difference, is the
bound its CPU test holds it to against OpenCV.

The card against the CPU for FLUX (repaint_flux (c)), the tiny
repainter in fp32 on both: its transformer's velocity within
FLUX_CARD_CPU_REL = 1e-4 of its largest value. Its sums have at most
K = 256 terms (2^-24 K = 1.5e-5 of their size), and the timestep
embedding scales t by 1000 before cos / sin, so a one-ulp difference in a
frequency moves an argument by up to 6e-5 rad (the CPU tests measure
5e-5 of the output between XLA and torch for this cause). The repainted
uint8 image within one level: the float image is truncated to uint8 on
both sides, so a value at a level's edge may land on either side.
DepthCrafter's tiny denoiser (depthcrafter (c)), fp32 on both with the same
latents and pixel noise: within DC_CARD_CPU_ABS = 1e-4 of its [0, 1]
output. The latents start at sigma 700 times N(0, 1), so the UNet's input
and the Euler update carry values of size 1e3 whose fp32 rounding (6e-5
absolute) the last step's x0 prediction passes to the decode. The exact
branch chunked against one whole chunk (depthcrafter (b)): cuBLAS sums a
smaller product in another order, a few fp32 ulps of each value: within
EXACT_CHUNK_REL = 1e-5 of the largest.

The track path against the host path (generate_from_tracks): each latent of
the cond within 5e-2 of its max |ref| (the bound reference_check uses for
bf16 models). The two paths feed the bf16 VAE encoder the same normalized
streams, rounded differently: the host path rounds each clip to fp16 and
then to bf16, the track path rounds the fp32 value to bf16 once, and for
the first frame it rounds the frame to fp16 before normalizing. So some
input elements differ by one bf16 ulp (2^-8 of their size), about the
rounding error every bf16 layer of the encoder adds; the latents then
differ at the level of the encoder's own bf16 noise, not of a fault (a
wrong stream, frame or mask would move them by the size of the latents).
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
SEED = 1234
FLAGSHIP_LATENT = (25, 32, 56)     # 97 frames at 512 x 896, 16x VAE
GENERATE_VIDEO = (17, 512, 896)    # frames, height, width of the main path
TRACKS_VIDEO = (97, 512, 896)      # the track path: 11,648 tokens
TRACK_DENSITY = 10                 # grid spacing in pixels: 4,680 points
LONG_VIDEO = (201, 512, 896)       # the long-clip path: 51 latent frames
LONG_TOKENS = 52 * 448             # with the ref block: 23,296
FLUX_HW = (512, 896)               # the FLUX repaint's image
FLUX_TOKENS = 64 * 112 // 4 + 512  # 1,792 image + 512 T5 tokens
FLUX_STEPS = 4                     # the full-width repaint (a)
FLUX_DEMO_STEPS = 30               # the demo's repaint (b), the reference's
FLUX_CARD_CPU_REL = 1e-4           # tiny FLUX forward, card vs CPU
DC_VIDEO = (32, 512, 896)          # DepthCrafter's clip (a)
DC_STEPS = 2
DC_CARD_CPU_ABS = 1e-4             # tiny denoiser, card vs CPU ([0, 1])
EXACT_CHUNK_REL = 1e-5             # the exact branch chunked vs whole


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, **kw) -> float:
    """Milliseconds per call of `fn` on the card, from back-to-back
    launches between two CUDA events (`flexam_tpu_torch/tools/timing.py`:
    20 calls a run, the median of 5 runs unless `kw` says otherwise), so
    the wrapper's host time is not counted."""
    from flexam_tpu_torch.tools.timing import device_ms as timed
    return timed(fn, **kw)


def compare(got, ref, bound_rel: float, name: str) -> dict:
    """max abs / max rel error of a whole model's output; fails above
    bound_rel of max |ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    rel = err / scale if scale else err
    if not (err <= bound_rel * scale) or not g.isfinite().all():
        raise AssertionError(f"{name}: max abs err {err} > {bound_rel} x "
                             f"max|ref| {scale}")
    return {"max_abs_err": err, "max_rel_err": rel, "bound_rel": bound_rel,
            "max_abs_ref": scale}


class StagePeaks:
    """Peak memory allocated in each stage of a run: `mark(name)` closes the
    stage that ran since the last mark (or since the object was made), and
    the next stage starts from the memory allocated then."""

    def __init__(self):
        import torch
        self.torch = torch
        self.gb = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.resident_gb = torch.cuda.memory_allocated() / 1e9

    def mark(self, name: str) -> None:
        self.torch.cuda.synchronize()
        self.gb[name] = self.torch.cuda.max_memory_allocated() / 1e9
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> float:
        return max(self.gb.values())


# the wgmma opcodes each attention kernel must have (int8 wgmma is IGMMA)
HOPPER_OPCODES = {"flash_kernel": ("HGMMA", "UTMALDG"),
                  "single_kv_kernel": ("HGMMA", "UTMALDG"),
                  "sparse_attention_kernel": ("HGMMA", "UTMALDG"),
                  "int8_attention_kernel": ("IGMMA", "HGMMA", "UTMALDG")}


def hopper_sass(lib: Path) -> dict:
    """Counts of the opcodes that tell the attention kernels' Hopper design
    from an mma.sync one (wgmma: HGMMA for bf16, IGMMA for int8; TMA
    loads: UTMALDG; mbarriers: SYNCS; HMMA / IMMA are mma.sync) in their
    SASS, from cuobjdump; fails if B1, B2 or B5 lacks HGMMA or UTMALDG, or
    B6 lacks IGMMA, HGMMA or UTMALDG. Also B6's int -> float conversions
    by full opcode: I2F.*.RP comes from integer divisions (the work-item
    index); a conversion of each logit would add I2F (or I2FP) without RP.
    And the row kernels' (B3, B4) 128-bit global loads and stores, by
    instantiation (`ln_mod_kernel<12>` serves 3072 features); fails if one
    lacks either. Null where the toolkit has no cuobjdump."""
    from flexam_tpu_torch.tools.attention_ab import (key_opcodes,
                                                     sass_opcodes,
                                                     wide_accesses)
    try:
        ops = sass_opcodes(lib)
    except (OSError, subprocess.CalledProcessError) as e:
        return {"cuobjdump": None, "reason": str(e)[:200]}
    keys = {k: v for k, v in key_opcodes(ops).items() if k in HOPPER_OPCODES}
    rows = {k: wide_accesses(v) for k, v in ops.items()
            if k.startswith(("ln_mod_kernel", "rmsnorm_rope_kernel"))}
    if len(rows) < 2 or not all(all(n.values()) for n in rows.values()):
        raise AssertionError(f"row kernels without 128-bit global loads or "
                             f"stores in their SASS: {rows}")
    keys["row_kernels_128_bit"] = rows
    for kernel, need in HOPPER_OPCODES.items():
        got = keys.get(kernel, {})
        if not all(got.get(op) for op in need):
            raise AssertionError(f"{kernel}: no {' / '.join(need)} in its "
                                 f"SASS ({got})")
    i2f = {op: n for op, n in ops["int8_attention_kernel"].items()
           if op.split(".")[0] in ("I2F", "I2FP")}
    keys["int8_attention_kernel_i2f"] = i2f
    keys["int8_attention_kernel_i2f_outside_divisions"] = sum(
        n for op, n in i2f.items() if ".RP" not in op)
    return keys


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(dev, results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from flexam_tpu_torch.core.rope import build_video_rope, make_rope_tables
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    from flexam_tpu_torch.ops import fused
    from flexam_tpu_torch.testing import (check_attention,
                                          check_ln_modulation,
                                          check_rmsnorm_rope)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    B, H, D, L, LT, DIM = 2, 24, 128, 11648, 512, 3072

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    lines = {}

    # attention: B1 self-attention (L x L), B2 cross-attention (L x 512)
    q = randn(B, L, H, D)
    for name, lk, fn in (("flash_attention", L, fa.flash_attention),
                         ("single_kv_attention", LT, fa.single_kv_attention)):
        k, v = randn(B, lk, H, D), randn(B, lk, H, D)
        got = fn(q, k, v)
        # the plain version over query chunks of 1024 rows: all of them
        # are compared (the full fp32 logits would be 26 GB at L x L)
        ref = fa.attention_plain(q, k, v, q_chunk=1024)
        torch.cuda.synchronize()
        err = check_attention(got, ref, name)
        del got, ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * B * H * L * lk * D
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(flops, nbytes)
        ms = device_ms(lambda: fn(q, k, v))
        lines[name] = dict(
            err, ms=ms, tflops=flops / ms / 1e9, bound_share=bms / ms,
            plain_ms=device_ms(lambda: fa.attention_plain(q, k, v,
                                                          q_chunk=1024),
                               launches=1, reps=3, warmup=1),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt)),
            bound_ms=bms, bound_by=by,
            plain_compare="every query row; the plain version runs over "
                          "1024-row query chunks",
            shape=f"q [{B},{L},{H},{D}] k/v [{B},{lk},{H},{D}] bf16")
        del k, v, qt, kt, vt
    del q

    # B3: q/k RMSNorm over 3072 + RoPE on the flagship grid (26 x 16 x 28).
    # Rows get their own offset and scale, as DiT hidden states have, so
    # that B4's mean subtraction matters.
    x = (randn(B, L, DIM, dtype=torch.float32)
         * torch.exp(0.5 * randn(B, L, 1, dtype=torch.float32))
         + 4.0 * randn(B, L, 1, dtype=torch.float32)).to(bf)
    gamma = (1.0 + 0.1 * randn(DIM, dtype=torch.float32)).to(bf)
    tables = torch.from_numpy(make_rope_tables(D, 1024)).to(dev)
    cos, sin = build_video_rope(tables, (26, 16, 28), D)
    # what this card streams: out.copy_(x) reads x and writes out once
    copy_out = torch.empty_like(x)
    copy_ms = device_ms(lambda: copy_out.copy_(x))
    copy = dict(copy_ms=copy_ms, copy_gbps=4.0 * x.numel() / copy_ms / 1e6)
    del copy_out

    def streamed(nbytes, ms):
        """The row kernels' bandwidth figures beside the copy's."""
        bms, by = bound_ms(10.0 * x.numel(), nbytes)
        return dict(ms=ms, gbps=nbytes / ms / 1e6, bound_share=bms / ms,
                    bound_ms=bms, bound_by=by, **copy)

    got = fused.rmsnorm_rope(x, gamma, cos, sin, H)
    ref = fused.rmsnorm_rope_plain(x, gamma, cos, sin, H)
    lines["rmsnorm_rope"] = dict(
        check_rmsnorm_rope(got, ref, "rmsnorm_rope"),
        **streamed(2.0 * 2 * x.numel() + 2 * DIM + 4.0 * 2 * cos.numel(),
                   device_ms(lambda: fused.rmsnorm_rope(x, gamma, cos, sin,
                                                        H))),
        plain_ms=device_ms(lambda: fused.rmsnorm_rope_plain(x, gamma, cos, sin,
                                                            H)),
        library_ms=None,
        shape=f"x [{B},{L},{DIM}] bf16, tables [{L},{D // 2}] fp32")

    # B4 both modes: binary (TI2V first frame known) and broadcast, with the
    # main path's terms: the shift a fresh tensor, the scale a strided view
    # of the [B, 2, 6, D] (binary) or [B, 1, 6, D] modulation tensor
    mask = torch.ones((B, L), device=dev)
    mask[:, 448:896] = 0.0     # the first video frame after the ref block
    for name, terms, m in (("ln_mod_binary", (B, 2, DIM), mask),
                           ("ln_mod_bcast", (B, DIM), None)):
        mod = randn(B, terms[1] if m is not None else 1, 6, DIM,
                    dtype=torch.float32)
        sh = randn(*terms, dtype=torch.float32)
        sc = mod[:, :, 1] if m is not None else mod[:, 0, 1]
        got = fused.ln_modulation(x, sh, sc, mask=m)
        ref = fused.ln_modulation_plain(x, sh, sc, mask=m)
        lines[name] = dict(
            check_ln_modulation(got, ref, sh, m, name),
            **streamed(2.0 * 2 * x.numel() + 4.0 * 2 * sh.numel()
                       + (4.0 * m.numel() if m is not None else 0.0),
                       device_ms(lambda: fused.ln_modulation(x, sh, sc,
                                                             mask=m))),
            plain_ms=device_ms(lambda: fused.ln_modulation_plain(x, sh, sc,
                                                                 mask=m)),
            library_ms=None,
            shape=f"x [{B},{L},{DIM}] bf16, shift/scale {list(terms)} fp32 "
                  "(scale a strided view)")
        if m is not None:
            # the kernel reads the strided scale as it is: its time on a
            # contiguous copy of the same terms, beside
            sc_c = sc.contiguous()
            lines[name]["contiguous_terms_ms"] = device_ms(
                lambda: fused.ln_modulation(x, sh, sc_c, mask=m))
    del x
    lines.update(long_kernels(dev, gen))
    lines["flash_attention"]["flux_shapes"] = flux_b1_shapes(dev, gen)
    results.update(lines)
    emit("kernels", t0, kernels=sorted(lines), **lines)


def flux_b1_shapes(dev, gen) -> dict:
    """B1 at FLUX.1-Depth's joint-attention shape: batch 1, 24 heads of 128,
    2,304 tokens (512x896: 1,792 image + 512 T5 tokens) and a ragged 2,072
    (480x832: 1,560 + 512), each held to the plain version over every row,
    timed beside it and beside SDPA (the yardstick)."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    from flexam_tpu_torch.testing import check_attention
    out = {}
    for name, L in (("flux_2304", FLUX_TOKENS), ("flux_ragged_2072", 2072)):
        q, k, v = (torch.randn((1, L, 24, 128), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        got = fa.flash_attention(q, k, v)
        ref = fa.attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = check_attention(got, ref, f"flash_attention {name}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * 24 * L * L * 128
        bms, by = bound_ms(flops, 2.0 * 4 * q.numel())
        ms = device_ms(lambda: fa.flash_attention(q, k, v))
        out[name] = dict(
            err, shape=f"q/k/v [1,{L},24,128] bf16", ms=ms,
            tflops=flops / ms / 1e9, bound_ms=bms, bound_by=by,
            bound_share=bms / ms,
            plain_ms=device_ms(lambda: fa.attention_plain(q, k, v)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt)),
            ctas=-(-L // 128) * 24)
        del q, k, v, qt, kt, vt, got, ref
    return out


def long_kernels(dev, gen) -> dict:
    """B5 and B6 at the long-clip shape: q/k/v [2, 23296, 24, 128] bf16
    (512x896x201f: 51 latent frames + the ref block, 448 tokens each); then
    B2, B3 (RIFLEx tables) and B4 (binary) at the shapes the long path
    gives them ("long/..." lines)."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    from flexam_tpu_torch.ops import int8_attention as i8
    from flexam_tpu_torch.ops import sparse_attention as sp
    from flexam_tpu_torch.testing import (block_scaled, check_int8_attention,
                                          check_sparse_attention)

    B, H, D, L = 2, 24, 128, LONG_TOKENS
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2.0 * 4 * q.numel()          # q, k, v read once, o written once
    shape = f"q/k/v [{B},{L},{H},{D}] bf16"
    lines = {}

    # B5 with the w=2 policy of 51 frames + ref: 26 blocks of 896 tokens
    pol = sp.video_sparse_policy(51, 448, ref_tokens=448, window=2)
    rows, blk = pol["rows"], pol["blk"]
    kidx, nnz = (torch.from_numpy(a).to(dev) for a in sp.rows_to_arrays(rows))
    pairs = int(nnz.sum().item())

    def b5():
        return sp.sparse_flash_attention(q, k, v, rows, blk, kidx=kidx,
                                         nnz=nnz)

    got = b5()
    ref = sp.masked_dense_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    err = check_sparse_attention(got, ref, "sparse_attention")
    del got, ref
    tok_blk = torch.arange(L, device=dev) // blk
    bmask = torch.zeros((len(rows), len(rows)), dtype=torch.bool, device=dev)
    for i, r in enumerate(rows):
        bmask[i, r] = True
    tok_mask = bmask[tok_blk][:, tok_blk]            # [L, L] bool
    flops = 4.0 * B * H * pairs * blk * blk * D
    bms, by = bound_ms(flops, nbytes)
    ms = device_ms(b5)
    lines["sparse_attention"] = dict(
        err, ms=ms, tflops=flops / ms / 1e9, bound_share=bms / ms,
        plain_ms=device_ms(lambda: sp.masked_dense_attention(q, k, v, rows,
                                                             blk),
                           launches=1, reps=3, warmup=1),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=tok_mask)),
        library="F.scaled_dot_product_attention with the boolean token mask",
        bound_ms=bms, bound_by=by, blocks=len(rows), blk=blk,
        active_pairs=pairs, density=pairs / len(rows) ** 2,
        dense_bound_ms=bound_ms(4.0 * B * H * L * L * D, nbytes)[0],
        plain_compare="every query row; the plain version runs over 512-row "
                      "query chunks", shape=shape)
    del tok_mask

    # B6, what the auto ladder takes for self-attention at this length
    def b6():
        return i8.int8_attention(q, k, v)

    got = b6()
    ref = i8.int8_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = check_int8_attention(got, ref, "int8_attention")
    del ref
    exact = fa.attention_plain(q, k, v, q_chunk=1024)
    rel = ((got.float() - exact.float()).abs().mean()
           / exact.float().abs().mean()).item()
    del got, exact
    ops_i8 = 2.0 * B * H * L * L * D        # Q K^T in int8
    ops_bf = 2.0 * B * H * L * L * D        # P V in bf16
    t_ops = (ops_i8 / PEAK_INT8_OPS + ops_bf / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ms = device_ms(b6)
    lines["int8_attention"] = dict(
        err, ms=ms, tflops=(ops_i8 + ops_bf) / ms / 1e9,
        bound_share=max(t_ops, t_bytes) / ms,
        tflops_note="int8 and bf16 operations together, per second",
        quantize_ms=device_ms(lambda: i8.quantize_qk(q, k)),
        plain_ms=device_ms(lambda: i8.int8_attention_plain(q, k, v),
                           launches=1, reps=3, warmup=1),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                    vt)),
        library="bf16 F.scaled_dot_product_attention (exact attention, not "
                "the int8 function)",
        b1_ms=device_ms(lambda: fa.flash_attention(q, k, v)),
        b1_note="B1 at the same shape: what the auto ladder replaces (exact, "
                "not the int8 function)",
        mean_rel_err_vs_exact=rel, mean_rel_err_bound_jax_test=0.02,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        plain_compare="every query row; the plain version runs over 512-row "
                      "query chunks", shape=shape)
    if rel >= 0.02:
        raise AssertionError(f"int8_attention: mean relative error {rel} "
                             "against exact attention >= 0.02")

    # B6 again with q rows and keys whose size alternates by 4x from one
    # quantization block (1,456 rows) to the next: 12 of the 15 block edges
    # fall inside a 64-row / 64-key tile, and each side of an edge must
    # take its own block's scale
    blk6 = i8.quant_block(L)
    qb, kb = block_scaled(q, blk6), block_scaled(k, blk6, phase=1)
    got = i8.int8_attention(qb, kb, v)
    ref = i8.int8_attention_plain(qb, kb, v)
    torch.cuda.synchronize()
    lines["long/int8_attention_block_scales"] = dict(
        check_int8_attention(got, ref, "int8_attention block scales"),
        quant_block=blk6, scales="q rows x2.0 / x0.5 by block, keys the "
        "other way round", shape=shape)
    del q, k, v, qt, kt, vt, qb, kb, got, ref
    lines.update(long_path_shapes(dev, gen))
    return lines


def long_path_shapes(dev, gen) -> dict:
    """B2, B3 and B4 (binary) at the long path's shapes, against their plain
    versions: cross-attention of 23,296 queries over 512 text tokens, the
    q/k RMSNorm + RoPE with the RIFLEx tables (k 6, L_test 51) on the
    52 x 16 x 28 grid, and the AdaLN prologue with the first video frame
    known."""
    import torch
    from flexam_tpu_torch.core.rope import build_video_rope, make_rope_tables
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    from flexam_tpu_torch.ops import fused
    from flexam_tpu_torch.testing import (check_attention,
                                          check_ln_modulation,
                                          check_rmsnorm_rope)

    B, H, D, L, LT, DIM = 2, 24, 128, LONG_TOKENS, 512, 3072
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    lines = {}
    q, k, v = randn(B, L, H, D), randn(B, LT, H, D), randn(B, LT, H, D)
    got = fa.single_kv_attention(q, k, v)
    ref = fa.attention_plain(q, k, v, q_chunk=1024)
    torch.cuda.synchronize()
    lines["long/single_kv_attention"] = dict(
        check_attention(got, ref, "long/single_kv_attention"),
        ms=device_ms(lambda: fa.single_kv_attention(q, k, v)),
        shape=f"q [{B},{L},{H},{D}] k/v [{B},{LT},{H},{D}] bf16")
    del q, k, v, got, ref

    # rows with their own offset and scale, as in the flagship check
    x = (randn(B, L, DIM, dtype=torch.float32)
         * torch.exp(0.5 * randn(B, L, 1, dtype=torch.float32))
         + 4.0 * randn(B, L, 1, dtype=torch.float32)).to(bf)
    gamma = (1.0 + 0.1 * randn(DIM, dtype=torch.float32)).to(bf)
    tables = torch.from_numpy(make_rope_tables(
        D, 1024, riflex={"k": 6, "L_test": 51})).to(dev)
    cos, sin = build_video_rope(tables, (52, 16, 28), D)
    got = fused.rmsnorm_rope(x, gamma, cos, sin, H)
    ref = fused.rmsnorm_rope_plain(x, gamma, cos, sin, H)
    torch.cuda.synchronize()
    ms = device_ms(lambda: fused.rmsnorm_rope(x, gamma, cos, sin, H))
    lines["long/rmsnorm_rope"] = dict(
        check_rmsnorm_rope(got, ref, "long/rmsnorm_rope"),
        ms=ms, gbps=(4.0 * x.numel() + 8.0 * cos.numel()) / ms / 1e6,
        riflex={"k": 6, "L_test": 51}, grid=[52, 16, 28],
        shape=f"x [{B},{L},{DIM}] bf16, tables [{L},{D // 2}] fp32")
    del got, ref

    mask = torch.ones((B, L), device=dev)
    mask[:, 448:896] = 0.0     # the first video frame after the ref block
    # the scale a strided view of the modulation tensor, as on the main path
    sh = randn(B, 2, DIM, dtype=torch.float32)
    sc = randn(B, 2, 6, DIM, dtype=torch.float32)[:, :, 1]
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    ref = fused.ln_modulation_plain(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    ms = device_ms(lambda: fused.ln_modulation(x, sh, sc, mask=mask))
    lines["long/ln_mod_binary"] = dict(
        check_ln_modulation(got, ref, sh, mask, "long/ln_mod_binary"),
        ms=ms, gbps=4.0 * x.numel() / ms / 1e6,
        shape=f"x [{B},{L},{DIM}] bf16, shift/scale [{B},2,{DIM}] fp32")
    return lines


def phase_reference_check(dev) -> None:
    """A small head_dim-128 DiT through the kernels on the card, against the
    same weights and inputs through the plain versions on the CPU (bf16
    both), with dense, block-sparse and int8 attention. Bound: 5e-2 of max
    |ref| (bf16 over 2 blocks; the two devices order their sums
    differently, and under int8 a value on a rounding tie may quantize one
    step apart)."""
    import torch
    from flexam_tpu_torch.config import DiTConfig
    from flexam_tpu_torch.core import attention
    from flexam_tpu_torch.models.dit import dit_forward, init_dit_params
    from flexam_tpu_torch.ops import launch_counts
    from flexam_tpu_torch.ops.sparse_attention import make_sparse_attn_fn

    t0 = time.perf_counter()
    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                    in_dim=8, out_dim=4, text_dim=32, text_len=6, freq_dim=32,
                    add_ref_conv=False, add_cnn_block=False)
    params = init_dit_params(cfg, seed=SEED, dtype=torch.bfloat16,
                             device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((2, 8, 3, 16, 16), generator=gen).to(torch.bfloat16)
    ctx = torch.randn((2, 6, 32), generator=gen).to(torch.bfloat16)
    t = torch.tensor([700.0, 700.0])
    mask = (torch.rand((2, 3 * 8 * 8), generator=gen) > 0.3).float()
    out = {}
    on_card = _to(params, dev)
    for name, m in (("binary", mask), ("scalar", None)):
        ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=m)
        got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                          binary_t_mask=None if m is None else m.to(dev))
        out[name] = compare(got.cpu(), ref, 5e-2, f"reference_check/{name}")
    # the long-clip backends: B5 (3 frames of 64 tokens, window 1: frame 0
    # does not see frame 2) and B6 (every attention call, explicitly)
    sparse = make_sparse_attn_fn(3, 64, window=1)
    counts = launch_counts()
    ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=mask,
                      attn_fn=sparse)
    got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                      binary_t_mask=mask.to(dev), attn_fn=sparse)
    out["sparse"] = compare(got.cpu(), ref, 5e-2, "reference_check/sparse")
    os.environ["FLEXAM_ATTENTION"] = "pallas_int8"
    attention._default_backend.cache_clear()
    try:
        ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=mask)
        got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                          binary_t_mask=mask.to(dev))
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    out["int8"] = compare(got.cpu(), ref, 5e-2, "reference_check/int8")
    after = launch_counts()
    for k, n in (("sparse_attention", 2), ("int8_attention", 4)):
        if after[k] - counts[k] != n:
            raise AssertionError(f"reference_check: {k} launched "
                                 f"{after[k] - counts[k]} times, expected {n}")
    emit("reference_check", t0, **out)


def _to(tree, dev):
    import torch
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def phase_dit_flagship(dev, cfg):
    import torch
    from flexam_tpu_torch.models.dit import (dit_forward, init_dit_params,
                                             make_rope_tables_for)
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    dcfg = cfg.dit
    params = init_dit_params(dcfg, seed=SEED, dtype=torch.bfloat16,
                             device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf = torch.bfloat16
    lt, lh, lw = FLAGSHIP_LATENT
    c = dcfg.out_dim

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    x = randn(2, c, lt, lh, lw)
    y = randn(2, dcfg.in_dim - c, lt, lh, lw)
    ac = randn(2, dcfg.in_dim_cnn_block - c, lt, lh, lw)
    ref = randn(2, c, lh, lw)
    ctx = randn(2, dcfg.text_len, dcfg.text_dim)
    t = torch.full((2,), 900.0, device=dev)
    dens = torch.full((2,), 0.5, device=dev)
    n_vid = lt * (lh // 2) * (lw // 2)
    mask = torch.ones((2, n_vid), device=dev)
    mask[:, :(lh // 2) * (lw // 2)] = 0.0     # first frame known
    rope = make_rope_tables_for(dcfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t1 = time.perf_counter()
    with torch.no_grad():
        out = dit_forward(params, dcfg, x, t, ctx, density=dens, y=y,
                          additional_control=ac, full_ref=ref,
                          rope_tables=rope, binary_t_mask=mask)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t1
    counts = launch_counts()
    finite = bool(out.isfinite().all().item())
    if not finite or tuple(out.shape) != tuple(x.shape):
        raise AssertionError(f"flagship forward: shape {tuple(out.shape)}, "
                             f"finite {finite}")
    expect = {"flash_attention": dcfg.num_layers,
              "single_kv_attention": dcfg.num_layers,
              "rmsnorm_rope": 2 * dcfg.num_layers,
              "ln_mod_binary": 2 * dcfg.num_layers}
    for k, n in expect.items():
        if counts[k] != n:
            raise AssertionError(f"flagship forward: {k} launched "
                                 f"{counts[k]} times, expected {n}")
    emit("dit_forward_flagship", t0, tokens=n_vid + (lh // 2) * (lw // 2),
         batch=2, init_seconds=round(t_init, 3), forward_seconds=fwd_s,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         finite=finite, launches=counts)
    t0 = time.perf_counter()
    with torch.no_grad():
        emit("dit_forward_profile", t0, **profile_forward(
            lambda: dit_forward(params, dcfg, x, t, ctx, density=dens, y=y,
                                additional_control=ac, full_ref=ref,
                                rope_tables=rope, binary_t_mask=mask)))
    return params


def profile_forward(fn) -> dict:
    """Device time of one more call of `fn` under torch.profiler: the wall
    time, the device-busy share, device time by kernel group, and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = {"B1 flash_attention": ("flash_kernel",),
              "B2 single_kv_attention": ("single_kv_kernel",),
              "B5 sparse_attention": ("sparse_attention_kernel",),
              "B6 int8_attention": ("int8_attention_kernel",),
              "B3 rmsnorm_rope": ("rmsnorm_rope_kernel",),
              "B4 ln_modulation": ("ln_mod_kernel",),
              "gemm": ("gemm", "gemv", "cutlass", "xmma", "sm90_", "cublas",
                       "nvjet"),
              "conv": ("conv", "implicit_convolve", "cudnn")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    by_group, top = {}, []
    for ev in prof.key_averages():
        # device-side activities only (kernels, copies), not the host ops
        # that launched them; CUPTI's "Command Buffer Full" marks a full
        # launch queue, not device work
        dev_us = ev.self_device_time_total
        if (ev.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0
                or ev.key == "Command Buffer Full"):
            continue
        name = ev.key
        g = next((k for k, pats in groups.items()
                  if any(p in name for p in pats)), "other (elementwise etc.)")
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, ev.count, name[:90]))
    top.sort(reverse=True)
    busy = sum(by_group.values()) / 1e3
    return {"wall_seconds": wall, "device_busy_seconds": busy,
            "device_busy_share": busy / wall if wall else None,
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"device_ms": a, "calls": b, "name": c}
                            for a, b, c in top[:12]]}


def phase_generate(dev, cfg, dit_params, results: dict):
    import numpy as np
    import torch
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels

    t0 = time.perf_counter()
    models = FlexAMModels(
        cfg=cfg, dit_params=dit_params,
        vae_params=init_vae_params(cfg.vae, seed=SEED + 2, device=dev),
        t5_params=init_t5_params(cfg.t5, seed=SEED + 3, device=dev))
    pipe = FlexAMGenerationPipeline(models, device=dev)
    T, Hp, Wp = GENERATE_VIDEO
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def clip(frames=T):
        return torch.rand((1, 3, frames, Hp, Wp), generator=gen, device=dev)

    video, control, depth = clip(), clip(), clip()
    cos_videos = [clip() for _ in range(4)]
    ref_image = clip(1)
    mask = torch.ones((1, 1, T, Hp, Wp), device=dev)
    mask[:, :, 0] = 0.0                       # first frame known
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    peaks = StagePeaks()
    stage = {}
    step_times = []

    reset_launch_counts()
    t1 = time.perf_counter()
    context = pipe.encode_prompt("a red fox runs through fresh snow")
    torch.cuda.synchronize()
    stage["encode"] = time.perf_counter() - t1
    pipe.release_t5()
    torch.cuda.empty_cache()
    peaks.mark("encode")
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning(video, mask, control, depth, cos_videos,
                                     ref_image)
    torch.cuda.synchronize()
    stage["prepare"] = time.perf_counter() - t1
    peaks.mark("prepare")
    if not cond["first_frame_known"] or not cond["per_token_t"]:
        raise AssertionError("generate: expected the binary-timestep path")

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        if done == total:
            peaks.mark("denoise")

    t_den = time.perf_counter()
    out = pipe.generate_from_cond(cond, context, num_inference_steps=4,
                                  guidance_scale=6.0, seed=SEED,
                                  progress_cb=progress)
    t_end = time.perf_counter()
    peaks.mark("decode")
    stage["denoise"] = step_times[-1] - t_den
    stage["decode"] = t_end - step_times[-1]
    peak = peaks.peak()
    if out.shape != (1, 3, T, Hp, Wp) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"generate: output {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")

    # no known frame: scalar timestep, the broadcast B4 mode
    t1 = time.perf_counter()
    cond_free = pipe.prepare_conditioning(video, None, control, depth,
                                          cos_videos, ref_image)
    lat = pipe.denoise(cond_free, context, num_inference_steps=1,
                       guidance_scale=6.0, seed=SEED)
    torch.cuda.synchronize()
    stage["no_known_frame_prepare_denoise_1_step"] = time.perf_counter() - t1
    counts = launch_counts()
    if not bool(lat.isfinite().all().item()):
        raise AssertionError("no-known-frame denoise: non-finite latents")
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for k in MAIN_PATH_KERNELS:
        results.setdefault(k, {})["launches"] = counts[k]
    emit("generate", t0, setup_seconds=round(t_setup, 3),
         stages=stage, step_seconds=[b - a for a, b in
                                     zip([t_den] + step_times[:-1],
                                         step_times)],
         output_shape=list(out.shape), output_range=[float(out.min()),
                                                     float(out.max())],
         peak_memory_allocated_gb=peak, frames=T,
         resident_at_start_gb=peaks.resident_gb,
         peak_memory_allocated_gb_by_stage=peaks.gb, launches=counts)
    return pipe, context


def grid_tracks(frames: int, height: int, width: int, density: int, seed: int):
    """A grid of points, one every `density` pixels, drifting (0.5, 0.2) px
    a frame (the JAX demo's synthetic tracks), all visible, with distinct
    depths (a random permutation of an even ladder in [1, 3]) so that the
    painter's order, and so every pixel, is defined exactly."""
    import numpy as np
    ys = np.arange(0, height, density, dtype=np.float32) + density / 2
    xs = np.arange(0, width, density, dtype=np.float32) + density / 2
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    n = gx.size
    depth = np.linspace(1.0, 3.0, n, dtype=np.float32)[
        np.random.RandomState(seed).permutation(n)]
    base = np.stack([gx.reshape(-1), gy.reshape(-1), depth], axis=1)
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    drift = np.concatenate([t * 0.5, t * 0.2, t * 0.0], axis=2)
    return (base[None] + drift).astype(np.float32), np.ones((frames, n), bool)


def phase_generate_from_tracks(dev, pipe, context) -> None:
    """Conditioning from tracks on the card, through generate_from_cond
    (module docstring). Reuses the main path's pipeline, DiT weights and
    context."""
    import numpy as np
    import torch
    from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                               rasterize_cos_videos,
                                               rasterize_depth_video,
                                               rasterize_tracking_video)
    from flexam_tpu_torch.conditioning.rasterize_device import \
        DeviceRasterizer
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    T, Hp, Wp = TRACKS_VIDEO
    tracks, vis = grid_tracks(T, Hp, Wp, TRACK_DENSITY, SEED + 6)
    rs = np.random.RandomState(SEED + 7)
    first = (rs.randint(0, 256, (1, 3, 1, Hp, Wp)) / 255.0).astype(np.float32)
    out = {"frames": T, "points": int(tracks.shape[1])}
    stage = {}

    # the rasterizer on the card against the numpy rasterizer, bit for bit
    t1 = time.perf_counter()
    enc = cosine_positional_encoding(tracks, Hp, Wp)
    host = {"tracking": rasterize_tracking_video(tracks, vis, Hp, Wp),
            "depth": rasterize_depth_video(tracks, vis, Hp, Wp)}
    host.update({f"cos_{i}": v for i, v in
                 rasterize_cos_videos(enc, tracks, vis, Hp, Wp).items()})
    stage["numpy_rasterize"] = time.perf_counter() - t1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rast = DeviceRasterizer(tracks, vis, Hp, Wp, device=dev)
    on_card = {"tracking": rast.tracking_video(),
               "depth": rast.depth_video()}
    on_card.update({f"cos_{i}": v for i, v in enumerate(rast.cos_videos())})
    torch.cuda.synchronize()
    stage["device_rasterize"] = time.perf_counter() - t1
    differ, painted = {}, {}
    for k, v in on_card.items():
        ref = torch.from_numpy(host[k]).to(dev)
        if v.device != ref.device or v.dtype != torch.float32 \
                or v.shape != ref.shape:
            raise AssertionError(f"device rasterizer {k}: {v.device} "
                                 f"{v.dtype} {tuple(v.shape)}")
        differ[k] = int((v != ref).any(dim=1).sum().item())
        painted[k] = float((ref != 0).any(dim=1).float().mean().item())
    del on_card, rast, ref
    if any(differ.values()) or min(painted.values()) < 0.05:
        raise AssertionError(f"device rasterizer against numpy: pixels that "
                             f"differ {differ}, painted share {painted}")
    out["rasterizer_pixels_differing"] = differ
    out["rasterizer_painted_share"] = painted

    # prepare from tracks (full_edit from a first frame, streamed encode)
    torch.cuda.empty_cache()
    peaks = StagePeaks()
    reset_launch_counts()
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning_from_tracks(tracks, vis, Hp, Wp,
                                                 first_frame=first)
    torch.cuda.synchronize()
    stage["prepare_from_tracks"] = time.perf_counter() - t1
    peaks.mark("prepare_from_tracks")
    vcfg = pipe.cfg.vae
    latent_shape = (vcfg.latent_channels,
                    (T - 1) // vcfg.temporal_compression_ratio + 1,
                    Hp // vcfg.spatial_compression_ratio,
                    Wp // vcfg.spatial_compression_ratio)  # (48, 25, 32, 56)
    if tuple(cond["latent_shape"]) != latent_shape \
            or not cond["first_frame_known"] or not cond["per_token_t"]:
        raise AssertionError(f"prepare_from_tracks: latent shape "
                             f"{cond['latent_shape']}, first frame known "
                             f"{cond['first_frame_known']}")
    keys = ("control_latents", "mask_latents", "masked_video_latents",
            "additional_control", "ref_latents", "mask_ti2v")
    off = [k for k in keys if cond[k].device != dev]
    if off:
        raise AssertionError(f"prepare_from_tracks: {off} not on {dev}")
    t1 = time.perf_counter()
    emit("prepare_from_tracks_profile", t1, **profile_forward(
        lambda: pipe.prepare_conditioning_from_tracks(tracks, vis, Hp, Wp,
                                                      first_frame=first)))
    peaks.mark("prepare_from_tracks_profile")

    # against the host path on the numpy-rasterized videos
    mask = np.ones((1, 1, T, Hp, Wp), np.float32)
    mask[:, :, 0] = 0.0
    t1 = time.perf_counter()
    host_cond = pipe.prepare_conditioning(
        np.repeat(first, T, axis=2), mask, host["tracking"], host["depth"],
        [host[f"cos_{i}"] for i in range(4)], first)
    torch.cuda.synchronize()
    stage["prepare_host_videos"] = time.perf_counter() - t1
    peaks.mark("prepare_host_videos")
    del host, mask
    out["against_host_path"] = {k: compare(cond[k], host_cond[k], 5e-2,
                                           f"generate_from_tracks/{k}")
                                for k in keys}
    del host_cond
    torch.cuda.empty_cache()

    # generate from the cond: 2 steps and the streamed decode
    step_times = []

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        if done == total:
            peaks.mark("denoise_2_steps")

    reset_launch_counts()
    t_den = time.perf_counter()
    video = pipe.generate_from_cond(cond, context, num_inference_steps=2,
                                    guidance_scale=6.0, seed=SEED,
                                    progress_cb=progress)
    t_end = time.perf_counter()
    peaks.mark("decode_streamed")
    counts = launch_counts()
    stage["denoise_2_steps"] = step_times[-1] - t_den
    stage["decode_streamed"] = t_end - step_times[-1]
    must = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
            "ln_mod_binary")
    if any(counts[k] == 0 for k in must) or counts["sparse_attention"] \
            or counts["int8_attention"]:
        raise AssertionError(f"generate_from_tracks: launches {counts}; "
                             f"expected {must} > 0, B5 and B6 0")
    if video.shape != (1, 3, T, Hp, Wp) or not np.isfinite(video).all() \
            or video.min() < 0.0 or video.max() > 1.0:
        raise AssertionError(f"generate_from_tracks: output {video.shape}, "
                             f"range [{video.min()}, {video.max()}]")
    out["output_range"] = [float(video.min()), float(video.max())]
    del video, cond

    # fg / bg edits at 17 frames (whole-clip encode, masked-group producer)
    Tf = GENERATE_VIDEO[0]
    ftracks, fvis = grid_tracks(Tf, Hp, Wp, TRACK_DENSITY, SEED + 8)
    fvideo = (rs.randint(0, 256, (1, 3, Tf, Hp, Wp)) / 255.0).astype(
        np.float32)
    fmask = np.zeros((1, 1, Tf, Hp, Wp), np.float32)
    fmask[..., : Wp // 2] = 1.0
    if pipe._use_streaming(1, Tf, Hp, Wp):
        raise AssertionError("17 frames should encode whole")
    t1 = time.perf_counter()
    fg = pipe.prepare_conditioning_from_tracks(
        ftracks, fvis, Hp, Wp, generate_type="foreground_edit",
        raster_mask=fmask[0, 0], video=fvideo, mask_video=fmask,
        ref_image=fvideo[:, :, :1])
    torch.cuda.synchronize()
    stage["prepare_foreground_edit_17f"] = time.perf_counter() - t1
    if not fg["per_token_t"] or fg["first_frame_known"]:
        raise AssertionError(f"foreground_edit: per_token_t "
                             f"{fg['per_token_t']}, first frame known "
                             f"{fg['first_frame_known']}")
    t1 = time.perf_counter()
    bg = pipe.prepare_conditioning_from_tracks(
        ftracks, fvis, Hp, Wp, generate_type="background_edit",
        raster_mask=1.0 - fmask[0, 0], video=fvideo)
    torch.cuda.synchronize()
    stage["prepare_background_edit_17f"] = time.perf_counter() - t1
    if bg["per_token_t"]:
        raise AssertionError("background_edit with no mask video: "
                             "per_token_t should be false")
    reset_launch_counts()
    t1 = time.perf_counter()
    lat = pipe.denoise(bg, context, num_inference_steps=1, guidance_scale=6.0,
                       seed=SEED)
    torch.cuda.synchronize()
    stage["background_edit_denoise_1_step"] = time.perf_counter() - t1
    peaks.mark("edits_17f")
    bg_counts = launch_counts()
    if not bg_counts["ln_mod_bcast"] or bg_counts["ln_mod_binary"] \
            or not bool(lat.isfinite().all().item()):
        raise AssertionError(f"background_edit step: launches {bg_counts}")
    for name, c in (("foreground_edit", fg), ("background_edit", bg)):
        bad = [k for k in keys if not bool(c[k].isfinite().all().item())]
        if bad:
            raise AssertionError(f"{name}: non-finite {bad}")
    emit("generate_from_tracks", t0, stages=stage,
         step_seconds=[b - a for a, b in zip([t_den] + step_times[:-1],
                                             step_times)],
         resident_at_start_gb=peaks.resident_gb,
         peak_memory_allocated_gb_by_stage=peaks.gb, launches=counts,
         background_edit_step_launches=bg_counts, **out)


def phase_generate_long(dev, pipe, context, results: dict) -> None:
    """The long-clip path: 512x896x201f through generate_from_cond with the
    auto attention ladder (B6), then one step under FLEXAM_ATTENTION=sparse
    (B5). Reuses the main path's pipeline, DiT weights and context."""
    import numpy as np
    import torch
    from flexam_tpu_torch.core import attention
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    T, Hp, Wp = LONG_VIDEO
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    video = torch.rand((1, 3, T, Hp, Wp), generator=gen, device=dev)
    control = torch.rand((1, 3, T, Hp, Wp), generator=gen, device=dev)
    ref_image = torch.rand((1, 3, 1, Hp, Wp), generator=gen, device=dev)
    mask = torch.ones((1, 1, T, Hp, Wp), device=dev)
    mask[:, :, 0] = 0.0                       # first frame known
    pipe.enable_riflex(k=6, L_test=51)
    if os.environ.get("FLEXAM_ATTENTION") or os.environ.get(
            "FLEXAM_INT8_AUTO") == "0":
        raise AssertionError("generate_long: FLEXAM_ATTENTION / "
                             "FLEXAM_INT8_AUTO must be unset for the auto "
                             "ladder")
    attention._default_backend.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peaks = StagePeaks()
    stage, step_times = {}, []

    reset_launch_counts()
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning(video, mask, control, None, None,
                                     ref_image)
    torch.cuda.synchronize()
    stage["prepare_streamed_encode"] = time.perf_counter() - t1
    peaks.mark("prepare_streamed_encode")
    del video, control, mask
    _, lt, lh, lw = cond["latent_shape"]
    tokens = (lt + 1) * (lh // 2) * (lw // 2)
    if tokens != LONG_TOKENS or not cond["first_frame_known"]:
        raise AssertionError(f"generate_long: {tokens} tokens, first frame "
                             f"known {cond['first_frame_known']}")

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        if done == total:
            peaks.mark("denoise_2_steps")

    t_den = time.perf_counter()
    out = pipe.generate_from_cond(cond, context, num_inference_steps=2,
                                  guidance_scale=6.0, seed=SEED,
                                  progress_cb=progress)
    t_end = time.perf_counter()
    peaks.mark("decode_streamed")
    counts = launch_counts()
    stage["denoise_2_steps"] = step_times[-1] - t_den
    stage["decode_streamed"] = t_end - step_times[-1]
    peak = peaks.peak()
    steps = [b - a for a, b in zip([t_den] + step_times[:-1], step_times)]
    layers = pipe.cfg.dit.num_layers
    if counts["int8_attention"] != 2 * layers or counts["flash_attention"]:
        raise AssertionError(f"generate_long: launches {counts}; expected "
                             f"int8_attention {2 * layers} and "
                             "flash_attention 0")
    missing = [k for k in LONG_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"generate_long: never launched: {missing}")
    if out.shape != (1, 3, T, Hp, Wp) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"generate_long: output {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    out_range = [float(out.min()), float(out.max())]
    del out
    results["int8_attention"]["launches"] = counts["int8_attention"]

    # one step with video self-attention block-sparse (B5)
    os.environ["FLEXAM_ATTENTION"] = "sparse"
    attention._default_backend.cache_clear()
    try:
        reset_launch_counts()
        t1 = time.perf_counter()
        lat = pipe.denoise(cond, context, num_inference_steps=1,
                           guidance_scale=6.0, seed=SEED)
        torch.cuda.synchronize()
        stage["sparse_denoise_1_step"] = time.perf_counter() - t1
        sparse_counts = launch_counts()
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    if (sparse_counts["sparse_attention"] != layers
            or sparse_counts["flash_attention"]
            or sparse_counts["int8_attention"]):
        raise AssertionError(f"generate_long sparse step: launches "
                             f"{sparse_counts}; expected sparse_attention "
                             f"{layers}, flash and int8 0")
    if not bool(lat.isfinite().all().item()):
        raise AssertionError("generate_long sparse step: non-finite latents")
    results["sparse_attention"]["launches"] = sparse_counts["sparse_attention"]
    emit("generate_long", t0, frames=T, tokens=tokens, riflex={"k": 6,
                                                                "L_test": 51},
         stages=stage, step_seconds=steps, output_shape=[1, 3, T, Hp, Wp],
         output_range=out_range, peak_memory_allocated_gb=peak,
         resident_at_start_gb=peaks.resident_gb,
         peak_memory_allocated_gb_by_stage=peaks.gb,
         launches=counts, sparse_step_launches=sparse_counts)

    # where a long step's time goes: one more step of each, profiled
    t0 = time.perf_counter()
    prof = {"int8_auto": profile_forward(lambda: pipe.denoise(
        cond, context, num_inference_steps=1, guidance_scale=6.0, seed=SEED))}
    os.environ["FLEXAM_ATTENTION"] = "sparse"
    attention._default_backend.cache_clear()
    try:
        prof["sparse"] = profile_forward(lambda: pipe.denoise(
            cond, context, num_inference_steps=1, guidance_scale=6.0,
            seed=SEED))
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    pipe.disable_riflex()
    emit("denoise_long_profile", t0, **prof)


CKPT_LAYERS = 2                    # DiT blocks / umT5 layers written
DEMO_PROMPT = "a red fox runs through fresh snow"


class StageTimer:
    """Wall seconds of named stages inside a call the smoke does not own
    (`demo.main`): wraps each (owner, attribute) callable while active and
    synchronises the card before stopping its clock. Nested stages count
    in both (generate_from_cond's denoise and decode are their own).
    `seconds` sums each stage's calls; `each` lists them, `last` holds its
    last call's seconds and `calls` its number of calls; `returned` its last result, unless
    `keep_returned` is false (a result that holds a model would hold its
    device memory through the rest of the run)."""

    def __init__(self, targets, keep_returned: bool = True):
        self.targets = targets
        self.keep_returned = keep_returned
        self.seconds = {}
        self.each = {}
        self.last = {}
        self.calls = {}
        self.returned = {}

    def __enter__(self):
        import torch
        self._orig = []
        for owner, name in self.targets:
            orig = getattr(owner, name)
            self._orig.append((owner, name, orig))

            def wrapped(*a, _orig=orig, _name=name, **kw):
                t = time.perf_counter()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                self.seconds[_name] = self.seconds.get(_name, 0.0) + dt
                self.last[_name] = dt
                self.each.setdefault(_name, []).append(dt)
                self.calls[_name] = self.calls.get(_name, 0) + 1
                if self.keep_returned:
                    self.returned[_name] = out
                return out

            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self._orig:
            setattr(owner, name, orig)
        return False


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def phase_checkpoint_load(dev) -> None:
    """Reference-format checkpoint files at full Wan2.2-Fun-5B width, written
    from random bf16 trees and read back by the port's loaders (module
    docstring); then a 1-step apply_tracks and a denoise resumed from its
    step-1 snapshot on the loaded models."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.io import checkpoints as ck
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    from flexam_tpu_torch.orchestrator import FlexAMOrchestrator
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    t0 = time.perf_counter()
    full = WAN22_5B_FLEXAM
    cfg = dataclasses.replace(
        full, dit=dataclasses.replace(full.dit, num_layers=CKPT_LAYERS),
        t5=dataclasses.replace(full.t5, num_layers=CKPT_LAYERS))
    root = HERE / "build" / "smoke_checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    bf = torch.bfloat16
    written = {
        "dit": ck.dit_state_dict(init_dit_params(cfg.dit, seed=SEED + 10,
                                                 dtype=bf, device=dev)),
        "vae": ck.vae_state_dict(init_vae_params(cfg.vae, seed=SEED + 11,
                                                 dtype=bf, device=dev),
                                 cfg.vae),
        "t5": ck.t5_state_dict(init_t5_params(cfg.t5, seed=SEED + 12,
                                              dtype=bf, device=dev)),
    }
    # a bf16 checkpoint throughout (the DiT's modulation tables are made in
    # float32)
    written = {n: {k: v.to(bf) for k, v in sd.items()}
               for n, sd in written.items()}
    keys = sorted(written["dit"])
    files = {"dit": [root / f"diffusion_pytorch_model-0000{i + 1}-of-00002"
                     ".safetensors" for i in range(2)],
             "vae": [root / "Wan2.2_VAE.pth"],
             "t5": [root / "models_t5_umt5-xxl-enc-bf16.pth"]}
    io = {}
    for name in ("dit", "vae", "t5"):
        t1 = time.perf_counter()
        host = {k: v.cpu() for k, v in written[name].items()}
        if name == "dit":
            half = len(keys) // 2
            for path, part in zip(files[name], (keys[:half], keys[half:])):
                ck.save_safetensors(str(path), {k: host[k] for k in part})
        else:
            torch.save(host, str(files[name][0]))
        del host
        nbytes = sum(f.stat().st_size for f in files[name])
        ws = time.perf_counter() - t1
        io[name] = {"files": [f.name for f in files[name]], "gb": nbytes / 1e9,
                    "write_seconds": ws, "write_gb_per_s": nbytes / 1e9 / ws}

    def timed_load(fn, *args, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tree = fn(*args, device=dev, **kw)
        torch.cuda.synchronize()
        return tree, time.perf_counter() - t1

    dit, io["dit"]["read_seconds"] = timed_load(
        ck.load_dit_checkpoint, str(root), cfg.dit, dtype=torch.float32,
        matrix_dtype=bf)
    vae, io["vae"]["read_seconds"] = timed_load(
        ck.load_vae_checkpoint, str(files["vae"][0]), cfg.vae)
    t5, io["t5"]["read_seconds"] = timed_load(
        ck.load_t5_checkpoint, str(files["t5"][0]), cfg.t5)
    # the same loads without blocks / layers: the per-block time, and the
    # full depth extrapolated from it
    for name, fn, path, sub, depth in (
            ("dit", ck.load_dit_checkpoint, str(root), cfg.dit,
             full.dit.num_layers),
            ("t5", ck.load_t5_checkpoint, str(files["t5"][0]), cfg.t5,
             full.t5.num_layers)):
        kw = dict(matrix_dtype=bf) if name == "dit" else {}
        tree, t_base = timed_load(fn, path, dataclasses.replace(
            sub, num_layers=0), **kw)
        del tree
        per_block = (io[name]["read_seconds"] - t_base) / CKPT_LAYERS
        io[name]["read_seconds_without_blocks"] = t_base
        io[name]["read_seconds_per_block"] = per_block
        io[name]["extrapolated_full_depth_read_seconds"] = (
            t_base + depth * per_block)
        io[name]["full_depth_blocks"] = depth
    for name in io:
        io[name]["read_gb_per_s"] = io[name]["gb"] / io[name]["read_seconds"]

    # every loaded leaf against the tensor written, in value and in the
    # dtype JAX's loader gives it (float32 from a .pth; the DiT's float32
    # load cast to bf16 where the demo casts: per-block leaves and leaves
    # of 2+ dims)
    leaves, bad = 0, []
    for name, tree in (("dit", ck.dit_state_dict(dit)),
                       ("vae", ck.vae_state_dict(vae, cfg.vae)),
                       ("t5", ck.t5_state_dict(t5))):
        ref = written[name]
        if sorted(tree) != sorted(ref):
            raise AssertionError(f"checkpoint_load {name}: keys differ")
        for k, got in tree.items():
            want = ref[k]
            if name == "dit":
                dtype = bf if (k.startswith("blocks.") or want.dim() >= 2) \
                    else torch.float32
            else:
                dtype = torch.float32
            leaves += 1
            if got.dtype != dtype or got.device != want.device or \
                    not torch.equal(got.float(), want.float()):
                bad.append(f"{name}:{k} {got.dtype}")
    if bad:
        raise AssertionError(f"checkpoint_load: {len(bad)} leaves differ "
                             f"from what was written: {bad[:5]}")
    del written
    torch.cuda.empty_cache()

    # a 1-step apply_tracks on the loaded models (hashed prompt ids)
    models = FlexAMModels(cfg=cfg, dit_params=dit, vae_params=vae,
                          t5_params=t5, t5_from_checkpoint=True)
    pipe = FlexAMGenerationPipeline(models, device=dev)
    del dit, vae, t5
    try:
        pipe.tokenize([DEMO_PROMPT])
        raise AssertionError("checkpoint T5 without a tokenizer took "
                             "hashed ids")
    except RuntimeError:
        pass
    T, Hp, Wp = GENERATE_VIDEO
    tracks, vis = grid_tracks(T, Hp, Wp, TRACK_DENSITY, SEED + 13)
    rs = np.random.RandomState(SEED + 14)
    first = (rs.randint(0, 256, (1, 3, 1, Hp, Wp)) / 255.0).astype(np.float32)
    stage = {}
    os.environ["FLEXAM_ALLOW_HASHED_IDS"] = "1"
    try:
        orch = FlexAMOrchestrator(pipe, output_dir=str(root / "out"),
                                  save_tracking=False)
        reset_launch_counts()
        t1 = time.perf_counter()
        out = orch.apply_tracks(tracks, vis, Hp, Wp, prompt=DEMO_PROMPT,
                                first_frame=first, num_inference_steps=1,
                                guidance_scale=6.0, density=0.1, seed=SEED)
        torch.cuda.synchronize()
        stage["apply_tracks_1_step_17f"] = time.perf_counter() - t1
        counts = launch_counts()
        if out.shape != (1, 3, T, Hp, Wp) or not np.isfinite(out).all() \
                or out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError(f"checkpoint_load apply_tracks: output "
                                 f"{out.shape}")
        if any(counts[k] == 0 for k in MAIN_PATH_KERNELS[:4]):
            raise AssertionError(f"checkpoint_load apply_tracks: launches "
                                 f"{counts}")
        del out

        # denoise 4 steps in chunks of 2 with snapshots, then resumed from
        # the step-1 snapshot
        cond = pipe.prepare_conditioning_from_tracks(tracks, vis, Hp, Wp,
                                                     first_frame=first)
        context = pipe.encode_prompt(DEMO_PROMPT)
        pipe.steps_per_launch = 2
        snaps = {}
        kw = dict(num_inference_steps=4, guidance_scale=6.0, seed=SEED,
                  density=0.1)
        t1 = time.perf_counter()
        whole = pipe.denoise(cond, context, **kw,
                             checkpoint_cb=lambda i, snap: snaps.update(
                                 {i: snap}))
        torch.cuda.synchronize()
        stage["denoise_4_steps_snapshots"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        resumed = pipe.denoise(cond, context, resume=snaps[1], **kw)
        torch.cuda.synchronize()
        stage["denoise_resumed_from_step_1"] = time.perf_counter() - t1
    finally:
        del os.environ["FLEXAM_ALLOW_HASHED_IDS"]
    resume = {"snapshot_steps": sorted(snaps),
              "equal": bool(torch.equal(resumed, whole)),
              "max_abs_diff": float((resumed - whole).abs().max())}
    if sorted(snaps) != [1, 3] or not resume["equal"]:
        raise AssertionError(f"checkpoint_load resume: {resume}")
    del pipe, cond, context, whole, resumed, snaps
    shutil.rmtree(root, ignore_errors=True)
    emit("checkpoint_load", t0, width="Wan2.2-Fun-5B",
         cut=f"depth only: DiT {CKPT_LAYERS} of {full.dit.num_layers} blocks, "
             f"umT5 {CKPT_LAYERS} of {full.t5.num_layers} layers (disk and "
             "write time); the VAE in full",
         reads_from="the page cache (the files were just written)",
         files=io, leaves_checked=leaves, stages=stage,
         apply_tracks_launches=counts, resume=resume)


def phase_demo(dev, results: dict) -> None:
    """`flexam_tpu_torch.demo.main` in process at --random_init 5b,
    512x896, in four runs (module docstring), each with its stage seconds,
    peak memory and launch counts (reset before each run)."""
    import gc
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch import demo, orchestrator
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline as Pipe

    t0 = time.perf_counter()
    root = HERE / "build" / "smoke_demo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    Hp, Wp = GENERATE_VIDEO[1:]
    # fixtures: tracks without extrinsics, an object mask, a mask video
    # (.npz frame dump) and a repaint frame
    tracks, vis = grid_tracks(49, Hp, Wp, TRACK_DENSITY, SEED + 15)
    np.savez(root / "tracks.npz", tracks=tracks, visibility=vis)
    omask = np.zeros((Hp, Wp), np.uint8)
    omask[Hp // 4: 3 * Hp // 4, Wp // 3: 2 * Wp // 3] = 255
    np.save(root / "object_mask.npy", omask)
    mv = np.zeros((17, Hp, Wp, 3), np.uint8)
    mv[:, Hp // 4: 3 * Hp // 4, Wp // 4: 3 * Wp // 4] = 255
    np.savez(root / "mask.npz", video=mv, fps=16)
    rs = np.random.RandomState(SEED + 16)
    np.save(root / "repaint.npy", rs.randint(0, 256, (Hp, Wp, 3),
                                             dtype=np.uint8))
    base = ["--prompt", DEMO_PROMPT, "--random_init", "5b", "--sample_size",
            str(Hp), str(Wp), "--seed", str(SEED)]
    runs = [
        ("full_edit_synthetic_49f", 49, 2,
         ["--generate_type", "full_edit", "--synthetic_tracks"]),
        ("full_edit_solved_camera_object_49f", 49, 2,
         ["--generate_type", "full_edit", "--tracks_npz",
          str(root / "tracks.npz"), "--camera_motion",
          "trans 0.1 0 0.2; rot y 10", "--object_motion", "up",
          "--object_mask", str(root / "object_mask.npy")]),
        ("background_edit_17f", 17, 1,
         ["--generate_type", "background_edit", "--synthetic_tracks",
          "--mask_path", str(root / "mask.npz"), "--repaint",
          str(root / "repaint.npy")]),
        ("full_edit_teacache_17f", 17, 7,
         ["--generate_type", "full_edit", "--synthetic_tracks",
          "--teacache_thresh", "1e9"]),
    ]
    out_runs, demo_launches = {}, {}
    for name, frames, steps, extra in runs:
        argv = base + extra + ["--video_length", str(frames),
                               "--num_inference_steps", str(steps),
                               "--output_dir", str(root / name)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        targets = [(demo, "_build_models"), (Pipe, "encode_prompt"),
                   (Pipe, "prepare_conditioning_from_tracks"),
                   (Pipe, "denoise"), (Pipe, "decode_u8"),
                   (orchestrator, "save_video")]
        t1 = time.perf_counter()
        with StageTimer(targets) as st:
            out = demo.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = launch_counts()
        pipe = st.returned["_build_models"]
        info = dict(pipe.last_denoise_info)
        layers = pipe.cfg.dit.num_layers
        lat = st.returned["prepare_conditioning_from_tracks"]["latent_shape"]
        tokens = (lat[1] + 1) * (lat[2] // 2) * (lat[3] // 2)
        del pipe
        st.returned.clear()
        if out.shape != (1, 3, frames, Hp, Wp) or not np.isfinite(out).all() \
                or out.min() < 0.0 or out.max() > 1.0:
            raise AssertionError(f"demo {name}: output {out.shape}")
        must = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
                "ln_mod_binary")
        if any(counts[k] == 0 for k in must) or counts["sparse_attention"] \
                or counts["int8_attention"]:
            raise AssertionError(f"demo {name}: launches {counts}")
        forwards = info.get("teacache_computed_forwards", steps)
        if counts["flash_attention"] != forwards * layers:
            raise AssertionError(f"demo {name}: flash_attention "
                                 f"{counts['flash_attention']} launches for "
                                 f"{forwards} forwards of {layers} blocks")
        if name == "full_edit_teacache_17f" and (
                counts["flash_attention"] != 5 * layers
                or info.get("teacache_computed_forwards") != 5.0
                or info.get("teacache_skipped_forwards") != 2.0):
            raise AssertionError(f"demo {name}: TeaCache ran "
                                 f"{info}, launches {counts}")
        written = sorted(os.listdir(root / name))
        out_runs[name] = {
            "frames": frames, "steps": steps, "tokens": tokens,
            "wall_seconds": wall, "stages": dict(st.seconds),
            "denoise_seconds_per_step": st.seconds["denoise"] / steps,
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "denoise_info": info, "written": written,
            "output_range": [float(out.min()), float(out.max())]}
        for k, n in counts.items():
            demo_launches[k] = demo_launches.get(k, 0) + n
        del out
    for k in results:
        results[k]["demo_launches"] = demo_launches.get(k, 0)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("demo", t0, runs=out_runs, launches_all_runs=demo_launches)


# Relative L2 bounds of the quantized modes against bf16, derived in the
# module docstring
LINEAR_BOUND = {"int8": 0.02, "fp8": 0.1}       # 2x one linear's error
FORWARD_BOUND = {"int8": 0.06, "fp8": 0.3}
SERVING_MODES = (("bf16", ["--mode", "bf16"]), ("int8", ["--mode", "int8"]),
                 ("fp8", ["--mode", "fp8"]),
                 ("int8_sparse", ["--mode", "int8", "--attention", "sparse"]))


def serving_checks(dev) -> dict:
    """What the serving sessions rest on, on the card: int8 accumulators
    equal to the CPU's, a block's weight quantization equal to numpy's byte
    for byte, one linear and one flagship forward in int8 and in fp8 within
    their bounds of bf16 (the int8 forward also profiled)."""
    import gc

    import numpy as np
    import torch
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.core.layers import linear
    from flexam_tpu_torch.io.convert import map_leaves
    from flexam_tpu_torch.models.dit import (dit_forward, init_dit_params,
                                             make_rope_tables_for)
    from flexam_tpu_torch.ops import qlinear as Q
    from flexam_tpu_torch.utils.fp8 import FP8, convert_weights_to_fp8

    out = {}
    dcfg = WAN22_5B_FLEXAM.dit
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    # int32 accumulators: the card's GEMM against the CPU's for the same
    # int8 operands (1,024 rows of the ffn's fc1, 3072 -> 14336)
    a = torch.randint(-127, 128, (1024, dcfg.dim), generator=gen,
                      device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (dcfg.ffn_dim, dcfg.dim), generator=gen,
                      device=dev, dtype=torch.int8)
    acc = Q.int_mm(a, w).cpu()
    ref = torch._int_mm(a.cpu(), w.cpu().t())
    out["int32_accumulators_differing"] = int((acc != ref).sum())
    if out["int32_accumulators_differing"]:
        raise AssertionError(f"int_mm on the card: {out}")
    # a block's linears quantized on the card against numpy, byte for byte
    shapes = {f"{m}.{n}": (dcfg.dim, dcfg.dim) for m in ("self_attn",
                                                         "cross_attn")
              for n in "qkvo"}
    shapes.update({"ffn.fc1": (dcfg.ffn_dim, dcfg.dim),
                   "ffn.fc2": (dcfg.dim, dcfg.ffn_dim)})
    differing = 0
    for name, shp in shapes.items():
        wt = (torch.randn(shp, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        qd = Q.quantize_linear_params({"weight": wt})
        qh, sh = Q._quantize_weight_host(wt.float().cpu().numpy())
        differing += int((qd["weight_q"].cpu().numpy() != qh).sum())
        differing += int((qd["w_scale"].cpu().numpy().view(np.uint32)
                          != sh.view(np.uint32)).sum())
    out["block_quantization_bytes_differing"] = differing
    if differing:
        raise AssertionError(f"weight quantization on the card: {out}")

    params = init_dit_params(dcfg, seed=SEED + 41, dtype=torch.bfloat16,
                             device=dev)
    bf = torch.bfloat16
    lt, lh, lw = FLAGSHIP_LATENT
    c = dcfg.out_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf)

    # one linear at the flagship rows (11,648 tokens): block 0's ffn fc1
    xr = randn(2, (lt + 1) * (lh // 2) * (lw // 2), dcfg.dim)
    lin = params["blocks"][0]["ffn"]["fc1"]
    y_ref = linear(xr, lin).float()
    for mode, y in (("int8", Q.qlinear(xr, Q.quantize_linear_params(lin))),
                    ("fp8", linear(xr, {**lin,
                                        "weight": lin["weight"].to(FP8)}))):
        rel = float((y.float() - y_ref).norm() / y_ref.norm())
        out[f"linear_rel_err_{mode}"] = rel
        if not rel < LINEAR_BOUND[mode]:
            raise AssertionError(f"{mode} linear: relative error {rel} "
                                 f"(bound {LINEAR_BOUND[mode]})")
    del xr, y, y_ref

    inp = dict(x=randn(2, c, lt, lh, lw),
               y=randn(2, dcfg.in_dim - c, lt, lh, lw),
               additional_control=randn(2, dcfg.in_dim_cnn_block - c,
                                        lt, lh, lw),
               full_ref=randn(2, c, lh, lw),
               context=randn(2, dcfg.text_len, dcfg.text_dim))
    t = torch.full((2,), 900.0, device=dev)
    dens = torch.full((2,), 0.5, device=dev)
    rope = make_rope_tables_for(dcfg, dev)

    def forward(p):
        with torch.no_grad():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o = dit_forward(p, dcfg, inp["x"], t, inp["context"],
                            density=dens, y=inp["y"],
                            additional_control=inp["additional_control"],
                            full_ref=inp["full_ref"], rope_tables=rope)
            torch.cuda.synchronize()
            return o, time.perf_counter() - t1

    forward(params)                                    # warm-up
    base, out["forward_seconds_bf16"] = forward(params)
    base = base.float()
    for mode in ("fp8", "int8"):
        # fp8 converts a copy of the containers; int8, last, in place
        q = (convert_weights_to_fp8(map_leaves(params, lambda k, t, b: t))
             if mode == "fp8" else Q.convert_dit_to_int8(params))
        o, secs = forward(q)
        rel = float((o.float() - base).norm() / base.norm())
        out[f"forward_seconds_{mode}"] = secs
        out[f"forward_rel_err_{mode}"] = rel
        if not (bool(o.isfinite().all()) and rel < FORWARD_BOUND[mode]):
            raise AssertionError(f"{mode} flagship forward: relative error "
                                 f"{rel} (bound {FORWARD_BOUND[mode]})")
        del o
    with torch.no_grad():
        out["int8_forward_profile"] = profile_forward(
            lambda: dit_forward(q, dcfg, inp["x"], t, inp["context"],
                                density=dens, y=inp["y"],
                                additional_control=inp["additional_control"],
                                full_ref=inp["full_ref"], rope_tables=rope))
    del params, q, base, inp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serving(dev, results: dict) -> None:
    """`flexam_tpu_torch.tools.serving_bench.main` in process at 5B width,
    512x896x97f, in the modes bf16, int8, fp8 and int8 with sparse
    attention, 2 runs of 2 steps each (module docstring), after the checks
    of `serving_checks`."""
    import gc

    import torch
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    from flexam_tpu_torch.tools import serving_bench

    t0 = time.perf_counter()
    emit("serving_checks", t0, **serving_checks(dev))
    frames, hp, wp = TRACKS_VIDEO
    layers = WAN22_5B_FLEXAM.dit.num_layers
    total = {}
    for name, argv in SERVING_MODES:
        t1 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_launch_counts()
        recs, summary = serving_bench.main(argv + ["--runs", "2", "--steps",
                                                   "2"])
        counts = launch_counts()
        sparse = "sparse" in name
        dtypes = summary["dit_dtypes"]
        forwards = len(recs) * 2                      # 2 steps a run
        bad = [r for r in recs if r["video_shape"] != [1, 3, frames, hp, wp]
               or not r["latents_finite"]]
        want = {"single_kv_attention": forwards * layers,
                "rmsnorm_rope": 2 * forwards * layers,
                "sparse_attention" if sparse else "flash_attention":
                    forwards * layers}
        if bad or counts["int8_attention"] or any(
                counts[k] != n for k, n in want.items()) or (
                counts["ln_mod_bcast"] + counts["ln_mod_binary"]
                != 2 * forwards * layers):
            raise AssertionError(f"serving {name}: records {recs}, "
                                 f"launches {counts}")
        if (dtypes.get("int8", 0) != (10 * layers if "int8" in name else 0)
                or ("float8_e4m3fn" in dtypes) != (name == "fp8")):
            raise AssertionError(f"serving {name}: DiT leaves {dtypes}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        emit(f"serving_{name}", t1, records=recs, summary=summary,
             peak_memory_allocated_gb=summary["peak_alloc_gb"],
             dit_bytes=summary["dit_bytes"], launches=counts,
             b4_mode="broadcast" if counts["ln_mod_bcast"] else "binary")
    for k in results:
        results[k]["serving_launches"] = total.get(k, 0)
    gc.collect()
    torch.cuda.empty_cache()
    emit("serving", t0, launches_all_modes=total)


# ---------------------------------------------------------------------------
# The generation server
# ---------------------------------------------------------------------------

SERVE_VIDEO = (17, 512, 896)       # the server's 17-frame jobs
# the JAX package's refusal of camera conditioning without the adapter
# (`flexam_tpu/pipeline.py:1138-1147`), which the port's text must equal
CAMERA_REFUSAL = ("camera_video given but this model config has no "
                  "Control-Camera adapter (add_control_adapter is false) — "
                  "the conditioning would be silently ignored; use a "
                  "Camera-variant config")
SERVE_KERNELS = ("flash_attention", "single_kv_attention", "rmsnorm_rope")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, body=None, timeout=900):
    """(status, parsed JSON or raw bytes) of one request, as a remote
    client sends it."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.getheader("Content-Type") == "application/json":
        return resp.status, json.loads(data)
    return resp.status, data


def _poll(port: int, jid: str, until, interval=0.02, timeout=600.0):
    """/status of job `jid` every `interval` s until `until(status)`; returns
    (the last status, every step seen in a progress)."""
    seen = []
    t_end = time.perf_counter() + timeout
    while True:
        _, st = _http(port, "GET", f"/status/{jid}")
        prog = st.get("progress")
        if prog and (not seen or seen[-1] != prog["step"]):
            seen.append(prog["step"])
        if until(st):
            return st, seen
        if time.perf_counter() > t_end:
            raise AssertionError(f"serve: job {jid} stuck at {st}")
        time.sleep(interval)


def _counts() -> dict:
    """Kernel launches and the exact branch's calls since the last reset."""
    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.ops import launch_counts
    return {**launch_counts(), **exact_calls}


def _reset_counts() -> None:
    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.ops import reset_launch_counts
    reset_launch_counts()
    exact_calls["exact_attention"] = 0


def _check_serve_launches(name: str, counts: dict) -> str:
    """B1-B4 launched, B5, B6 and the exact branch not; returns B4's mode."""
    b4 = counts["ln_mod_binary"] + counts["ln_mod_bcast"]
    if any(counts[k] == 0 for k in SERVE_KERNELS) or b4 == 0 or (
            counts["sparse_attention"] or counts["int8_attention"]
            or counts["exact_attention"]):
        raise AssertionError(f"serve {name}: launches {counts}")
    return ("broadcast" if not counts["ln_mod_binary"] else
            "binary" if not counts["ln_mod_bcast"] else "both")


def _serve_targets():
    from flexam_tpu_torch import serve
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline as Pipe
    return [(Pipe, "encode_prompt"), (Pipe, "prepare_conditioning"),
            (Pipe, "prepare_conditioning_from_tracks"), (Pipe, "denoise"),
            (Pipe, "decode_u8"), (serve, "_encode_array")]


def _camera_rows(n: int):
    """`n` camera poses, [fx fy cx cy 0 0 + the 3x4 world-to-camera], a
    slow yaw and dolly (the trajectory JSON of the sampler's
    camera_conditions)."""
    import numpy as np
    rows = []
    for i in range(n):
        a = 0.05 * i
        c, s = np.cos(a), np.sin(a)
        w2c = [[c, 0, s, 0.1 * i], [0, 1, 0, 0.02 * i], [-s, 0, c, 1.0]]
        rows.append([0.47, 0.84, 0.5, 0.5, 0, 0,
                     *np.asarray(w2c).reshape(-1).tolist()])
    return rows


def phase_serve(dev, results: dict):
    """`flexam_tpu_torch.serve` at Wan2.2-Fun-5B width as `--host
    --random_init 5b` builds it, driven over HTTP on 127.0.0.1 (module
    docstring). Returns the pipeline for `serve_camera`."""
    import argparse
    import base64
    import gc
    import io
    import threading

    import numpy as np
    import torch
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.serve import (GenerationServer, _decode_array,
                                        _encode_array)

    t0 = time.perf_counter()
    pipe = demo._build_models(argparse.Namespace(
        checkpoint_path=None, random_init="5b", quant=None, prequant=None,
        platform="cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    srv = GenerationServer(pipe)
    port = _free_port()
    th = threading.Thread(target=srv.serve,
                          kwargs=dict(port=port, host="127.0.0.1"),
                          daemon=True)
    th.start()
    while srv.httpd is None:
        time.sleep(0.05)
    T, Hp, Wp = SERVE_VIDEO
    rs = np.random.RandomState(SEED + 60)
    jobs, total = {}, {}

    def run(name, submit, finish, check=True):
        """One job: counts reset, stage clocks on, `submit()` -> job id (or
        the reply of a blocking request), `finish(jid)` -> (status, reply);
        its line of numbers."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t1 = time.perf_counter()
        with StageTimer(_serve_targets()) as st:
            jid = submit()
            status, reply = finish(jid)
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        counts = _counts()
        rec = {"wall_seconds": wall, "state": status.get("state"),
               "progress": status.get("progress"),
               "stages": dict(st.seconds),
               # the result's encode is a job's last `_encode_array`
               # (the UI form's zero input video is encoded before it)
               "encode_result_seconds": st.last.get("_encode_array"),
               "encode_array_calls": st.calls.get("_encode_array", 0),
               "last_denoise_info": (dict(pipe.last_denoise_info)
                                     if status.get("state") == "done"
                                     else None),
               "peak_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts}
        if check:
            rec["b4_mode"] = _check_serve_launches(name, counts)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        jobs[name] = rec
        print(json.dumps({"serve_job": name, **rec}), flush=True)
        return rec, reply

    def submit(payload):
        return lambda: _http(port, "POST", "/submit", payload)[1]["job_id"]

    def until_done(expect="done", seen_out=None, interval=0.25):
        def finish(jid):
            st, seen = _poll(port, jid, lambda s: s["state"] not in (
                "queued", "running"), interval=interval)
            if seen_out is not None:
                seen_out.extend(seen)
            if st["state"] != expect:
                raise AssertionError(f"serve: job {jid} ended {st}")
            if expect != "done":
                return st, None
            code, out = _http(port, "GET", f"/result/{jid}")
            if code != 200:
                raise AssertionError(f"serve: /result/{jid}: {code} {out}")
            return st, _decode_array(out["video"])
        return finish

    def video_ok(name, video, frames):
        if video.dtype != np.uint8 or video.shape != (1, 3, frames, Hp, Wp):
            raise AssertionError(f"serve {name}: video {video.dtype} "
                                 f"{video.shape}")

    def clip(frames=T):
        return rs.rand(1, 3, frames, Hp, Wp).astype(np.float32)

    # (a) health
    code, health = _http(port, "GET", "/health")
    if code != 200 or health.get("backend") != "cuda" or \
            torch.cuda.get_device_name(0) != health.get("device_name"):
        raise AssertionError(f"serve: /health {code} {health}")

    # (b) a control-video job, 17f, 2 steps, CFG 6.0, progress 1/2 and 2/2
    mask = np.ones((1, 1, T, Hp, Wp), np.float32)
    mask[:, :, 0] = 0.0
    seen = []
    rec, video = run("control_video_17f", submit({
        "prompt": DEMO_PROMPT, "video": _encode_array(clip()),
        "mask_video": _encode_array(mask),
        "control_video": _encode_array(clip()),
        "num_inference_steps": 2, "guidance_scale": 6.0, "seed": SEED,
        "density": 0.1}), until_done(seen_out=seen, interval=0.005))
    video_ok("control_video_17f", video, T)
    if seen != [1, 2]:
        raise AssertionError(f"serve: progress seen {seen}, not 1/2, 2/2")
    rec["progress_seen"] = seen

    # (c) a tracks job at 97 frames while (d) waits behind it and is
    # cancelled in the queue
    F97 = TRACKS_VIDEO[0]
    tracks, vis = grid_tracks(F97, Hp, Wp, TRACK_DENSITY, SEED + 61)
    queued = {}
    tracks_job = submit({
        "prompt": DEMO_PROMPT, "tracks": _encode_array(tracks),
        "visibility": _encode_array(vis),
        "first_frame": _encode_array(clip(1)), "height": Hp, "width": Wp,
        "num_inference_steps": 2, "guidance_scale": 6.0, "seed": SEED,
        "density": 0.1})
    waiting_job = submit({"prompt": "waits", "video": _encode_array(
        np.zeros((1, 3, 5, 32, 32), np.float32)), "num_inference_steps": 1})

    def submit_tracks_then_queue():
        jid = tracks_job()
        _poll(port, jid, lambda s: s["state"] != "queued")
        qid = waiting_job()
        _, st = _http(port, "GET", f"/status/{qid}")
        _, cancel = _http(port, "POST", f"/cancel/{qid}")
        queued.update(id=qid, status=st, cancel=cancel)
        return jid

    rec, video = run("tracks_97f", submit_tracks_then_queue, until_done())
    video_ok("tracks_97f", video, F97)
    _, st = _http(port, "GET", f"/status/{queued['id']}")
    if (queued["status"].get("queue_position") != 0
            or queued["status"].get("state") != "queued"
            or queued["cancel"] != {"state": "cancelled"}
            or st["state"] != "cancelled" or st["progress"] is not None):
        raise AssertionError(f"serve: the queued job {queued}, then {st}")
    jobs["queued_cancelled"] = {"status_while_queued": queued["status"],
                                "cancel": queued["cancel"], "final": st}
    rec["result_uint8_bytes"] = int(video.nbytes)
    del video

    # (e) an 8-step job cancelled once a step has run
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()

    def cancel_after_a_step(jid):
        _poll(port, jid, lambda s: (s.get("progress") or {}).get(
            "step", 0) >= 1 or s["state"] not in ("queued", "running"),
            interval=0.005)
        _http(port, "POST", f"/cancel/{jid}")
        return until_done("cancelled")(jid)

    rec, _ = run("cancelled_8_steps_17f", submit({
        "prompt": DEMO_PROMPT, "video": _encode_array(clip()),
        "mask_video": _encode_array(mask), "num_inference_steps": 8,
        "guidance_scale": 6.0, "seed": SEED}), cancel_after_a_step)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    rec["memory_allocated_before_gb"] = before / 1e9
    rec["memory_allocated_after_gb"] = after / 1e9
    if not (1 <= rec["progress"]["step"] < 8) or after - before > 256e6:
        raise AssertionError(f"serve: cancelled job {rec}")

    # (f) a long video: 33 frames in 17-frame windows, overlap 4, 1 step
    rec, video = run("long_video_33f", submit({
        "prompt": DEMO_PROMPT, "video_length": 33,
        "partial_video_length": 17, "overlap_video_length": 4,
        "height": Hp, "width": Wp, "num_inference_steps": 1,
        "guidance_scale": 6.0, "seed": SEED}), until_done())
    video_ok("long_video_33f", video, 33)

    # (g) camera conditions on a DiT without the adapter: JAX's refusal
    def refused(jid):
        st, _ = until_done("error")(jid)
        if st["error"] != CAMERA_REFUSAL:
            raise AssertionError(f"serve: camera refusal {st['error']!r}")
        return st, None

    run("camera_refused_17f", submit({
        "prompt": DEMO_PROMPT, "camera_conditions": json.dumps(
            _camera_rows(T)), "video_length": T, "height": Hp, "width": Wp,
        "num_inference_steps": 2, "guidance_scale": 6.0}), refused,
        check=False)

    # (h) one blocking UI form request, with the queue idle
    def ui_request():
        code, out = _http(port, "POST", "/generate", {
            "prompt": DEMO_PROMPT, "num_inference_steps": 1,
            "guidance_scale": 6.0, "seed": SEED, "video_length": T,
            "height": Hp, "width": Wp, "density": 0.1})
        if code != 200 or "mp4" not in out:
            raise AssertionError(f"serve: /generate {code} "
                                 f"{str(out)[:300]}")
        return out

    rec, out = run("ui_form_17f", ui_request,
                   lambda out: ({"state": "done"}, out))
    video_ok("ui_form_17f", _decode_array(out["video"]), T)
    raw = base64.b64decode(out["mp4"])
    rec["mp4_field"] = {"bytes": len(raw), "head": raw[:4].hex()}
    if raw[:2] == b"PK":                 # save_video's .npz frame dump
        frames = np.load(io.BytesIO(raw))["video"]
        if frames.shape != (T, Hp, Wp, 3):
            raise AssertionError(f"serve: the UI's frames {frames.shape}")
        rec["mp4_field"]["npz_frames"] = list(frames.shape)

    srv.httpd.shutdown()
    th.join(30)
    srv.pipe = None     # its job worker thread lives on; the weights need not
    for k in results:
        results[k]["serve_launches"] = total.get(k, 0)
    emit("serve", t0, setup_seconds=setup_s, health=health,
         queued_cancelled=jobs["queued_cancelled"],
         cancelled_job_memory_gb={
             k: jobs["cancelled_8_steps_17f"][k] for k in (
                 "memory_allocated_before_gb", "memory_allocated_after_gb")},
         result_uint8_bytes_97f=jobs["tracks_97f"]["result_uint8_bytes"],
         progress_seen_17f=jobs["control_video_17f"]["progress_seen"],
         ui_mp4_field=jobs["ui_form_17f"]["mp4_field"],
         wall_seconds={k: v["wall_seconds"] for k, v in jobs.items()
                       if "wall_seconds" in v},
         launches_all_jobs=total)
    return pipe


def phase_serve_cli(dev) -> None:
    """`python -m flexam_tpu_torch.serve --host --random_init tiny
    --platform cuda` in a subprocess, and its `--client` (9 frames, 32x32):
    the tiny config's head_dim 24 on the card, through the exact branch."""
    import shutil

    t0 = time.perf_counter()
    port = _free_port()
    logdir = HERE / "build" / "smoke_serve_cli"
    shutil.rmtree(logdir, ignore_errors=True)
    logdir.mkdir(parents=True)
    log = open(logdir / "server.log", "w")
    server = subprocess.Popen(
        [sys.executable, "-m", "flexam_tpu_torch.serve", "--host",
         "--random_init", "tiny", "--platform", "cuda", "--port", str(port)],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    try:
        t_end = time.perf_counter() + 180
        health = None
        while health is None:
            if server.poll() is not None or time.perf_counter() > t_end:
                raise AssertionError(
                    "serve_cli: the server did not answer /health: "
                    + (logdir / "server.log").read_text()[-2000:])
            try:
                health = _http(port, "GET", "/health", timeout=5)[1]
            except OSError:
                time.sleep(0.5)
        t_up = time.perf_counter() - t0
        t1 = time.perf_counter()
        client = subprocess.run(
            [sys.executable, "-m", "flexam_tpu_torch.serve", "--client",
             "--port", str(port)], cwd=HERE, capture_output=True,
            text=True, timeout=300)
        t_client = time.perf_counter() - t1
        if client.returncode != 0 or \
                "received video (1, 3, 9, 32, 32)" not in client.stdout:
            raise AssertionError(f"serve_cli: client rc {client.returncode}"
                                 f" {client.stdout[-500:]} "
                                 f"{client.stderr[-1500:]}")
    finally:
        server.terminate()
        try:
            server.wait(30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(30)
        log.close()
    if health.get("backend") != "cuda":
        raise AssertionError(f"serve_cli: /health {health}")
    emit("serve_cli", t0, server_up_seconds=t_up,
         client_seconds=t_client, client_stdout=client.stdout.strip(),
         health=health, server_log_tail=(
             logdir / "server.log").read_text().splitlines()[-3:])
    shutil.rmtree(logdir, ignore_errors=True)


def phase_serve_camera(dev, pipe) -> None:
    """The Control-Camera path at 5B width: the serve phase's weights with a
    camera adapter (24 input channels, downscale 16 = the 5B VAE's spatial
    compression, so its grid lands on the patch grid), random bf16;
    `GenerationServer.handle` of a 17-pose camera_conditions payload at
    512x896x17f, 2 steps, CFG 6.0, against the same call without it; the
    adapter's forward on the CFG batch timed by `device_ms`."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from flexam_tpu_torch.conditioning.camera import (
        camera_inputs_from_trajectory, fold_camera_video)
    from flexam_tpu_torch.models.dit import _camera_adapter, init_dit_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    from flexam_tpu_torch.serve import (GenerationServer, _decode_array,
                                        _encode_array)

    t0 = time.perf_counter()
    base = pipe.cfg
    dcfg = dataclasses.replace(
        base.dit, add_control_adapter=True, in_dim_control_adapter=24,
        downscale_factor_control_adapter=16)
    if base.vae.spatial_compression_ratio != 16:
        raise AssertionError("serve_camera: the 5B VAE is not 16x")
    adapter = init_dit_params(dataclasses.replace(dcfg, num_layers=0),
                              seed=SEED + 70, device=dev)["control_adapter"]
    m = pipe.models
    cam_pipe = FlexAMGenerationPipeline(FlexAMModels(
        cfg=dataclasses.replace(base, dit=dcfg),
        dit_params={**m.dit_params, "control_adapter": adapter},
        vae_params=m.vae_params, t5_params=m.t5_params), device=dev)
    srv = GenerationServer(cam_pipe)
    T, Hp, Wp = SERVE_VIDEO
    rows = _camera_rows(T)
    cam, video0, mask1 = camera_inputs_from_trajectory(rows, T, Hp, Wp)
    y = torch.from_numpy(fold_camera_video(cam)).to(dev, torch.bfloat16)
    lt, lh, lw = (T - 1) // 4 + 1, Hp // 16, Wp // 16
    if y.shape != (1, 24, lt, Hp, Wp):
        raise AssertionError(f"serve_camera: folded camera {y.shape}")
    tok = _camera_adapter(adapter, y, (2, 2), 16)
    if tok.shape != (1, lt * (lh // 2) * (lw // 2), dcfg.dim):
        raise AssertionError(f"serve_camera: adapter tokens {tok.shape}, "
                             f"not the DiT's {lt}x{lh // 2}x{lw // 2} grid")
    y2 = y.repeat(2, 1, 1, 1, 1)
    with torch.no_grad():
        adapter_ms = device_ms(
            lambda: _camera_adapter(adapter, y2, (2, 2), 16), launches=5)
    del tok, y2
    kw = {"prompt": DEMO_PROMPT, "num_inference_steps": 2,
          "guidance_scale": 6.0, "seed": SEED}
    outs, recs = {}, {}
    for name, payload in (
            ("camera", {**kw, "camera_conditions": json.dumps(rows),
                        "video_length": T, "height": Hp, "width": Wp}),
            ("no_camera", {**kw, "video": _encode_array(video0),
                           "mask_video": _encode_array(mask1)})):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with StageTimer(_serve_targets()) as st:
            out = srv.handle(payload)
        counts = _counts()
        lat = st.returned["denoise"]
        if not bool(lat.isfinite().all()):
            raise AssertionError(f"serve_camera {name}: latents not finite")
        outs[name] = _decode_array(out["video"])
        recs[name] = {"stages": dict(st.seconds), "launches": counts,
                      "b4_mode": _check_serve_launches(name, counts),
                      "peak_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9}
    a, b = outs["camera"], outs["no_camera"]
    if a.shape != (1, 3, T, Hp, Wp) or a.shape != b.shape:
        raise AssertionError(f"serve_camera: {a.shape} {b.shape}")
    differing = float((a != b).mean())
    if differing == 0.0:
        raise AssertionError("serve_camera: the camera changed nothing")
    srv.pipe = None     # its job worker thread lives on; the weights need not
    del cam_pipe, srv, adapter, outs, a, b
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_camera", t0, adapter_ms_cfg_batch=adapter_ms,
         adapter_input=list(y.shape), runs=recs,
         output_values_differing=differing)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Video input: UniDepth V2, the flow tracker, DenseTrack3D, the CLIs, serve
# ---------------------------------------------------------------------------

TRACK_SHIFT = (1, 1)               # the textured clip's motion, px a frame
TRACK_FLOW_BOUND_PX = 12.0         # median end-point error (docstring)
TRACK_FLOW_BIAS_PX = 1.5           # mean end-point error vector
TRACK_FLOW_VISIBLE = 0.5           # visible share of the tracks inside
TRACK_DEMO_FRAMES = 49
SERVE_TRACK_FRAMES = 17
TRACK_DT_TINY = dict(stride=4, window_len=8, model_resolution=(64, 96),
                     upsample_factor=4, latent_dim=32, dim=64, num_heads=4,
                     num_blocks=2, iters=2, num_virtual_tracks=8,
                     compute="float32")
TRACK_UD_TINY = dict(
    patch_size=14, embed_dim=32, depth=4, num_heads=2, mlp_ratio=4.0,
    num_register_tokens=2, layer_scale_init=1.0, output_idx=(1, 2, 3, 4),
    pretrain_img_size=28, hidden_dim=16, dec_num_heads=2, expansion=2,
    dec_depths=(1, 1, 1), out_dim=4, kernel_size=3, layer_scale=1.0,
    pixels_min=28 * 28, pixels_max=56 * 56, ratio_bounds=(0.5, 2.0),
    compute="float32")
# the card against the CPU at the tiny configs (module docstring)
CARD_CPU_UV_PX = 1e-2
CARD_CPU_VIS = 1e-3
CARD_CPU_REL = 1e-3
CARD_CPU_FLIP_SHARE = 0.01


def _track_targets():
    from flexam_tpu_torch import demo, repaint
    from flexam_tpu_torch.perception import flow_device, tracking
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline as Pipe
    return [(demo, "_build_models"), (tracking, "dispatch_tracking"),
            (tracking, "track_video_delta"),
            (flow_device, "track_video_flow_device"),
            (repaint.FirstFrameRepainter, "repaint"),
            (Pipe, "encode_prompt"),
            (Pipe, "prepare_conditioning_from_tracks"), (Pipe, "denoise"),
            (Pipe, "decode_u8"), (tracking, "track_video_flow")]


def _add(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def track_serve_job(dev, pipe, track: dict, total: dict) -> None:
    """(f): one job with `track_method: "flow"` and a bare 17-frame clip,
    over HTTP on the serve phase's 5B pipeline: the server tracks the clip
    on the card, anchors full_edit on its first frame, 1 step at CFG 6.0."""
    import gc
    import threading

    import numpy as np
    import torch
    from flexam_tpu_torch.serve import (GenerationServer, _decode_array,
                                        _encode_array)
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip

    _, Hp, Wp = TRACKS_VIDEO
    T = SERVE_TRACK_FRAMES
    clip = textured_clip(T, Hp, Wp, TRACK_SHIFT, SEED + 80, dev)
    video = clip.transpose(3, 0, 1, 2)[None].astype(np.float32) / 255.0
    srv = GenerationServer(pipe)
    port = _free_port()
    th = threading.Thread(target=srv.serve,
                          kwargs=dict(port=port, host="127.0.0.1"),
                          daemon=True)
    th.start()
    while srv.httpd is None:
        time.sleep(0.05)
    try:
        payload = {"prompt": DEMO_PROMPT, "video": _encode_array(video),
                   "track_method": "flow", "track_density": TRACK_DENSITY,
                   "num_inference_steps": 1, "guidance_scale": 6.0,
                   "seed": SEED, "density": 0.1}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t1 = time.perf_counter()
        with StageTimer(_serve_targets() + _track_targets()[1:4]) as st:
            jid = _http(port, "POST", "/submit", payload)[1]["job_id"]
            status, _ = _poll(port, jid, lambda s: s["state"] not in (
                "queued", "running"), interval=0.05)
            if status["state"] != "done":
                raise AssertionError(f"track serve: job ended {status}")
            code, out = _http(port, "GET", f"/result/{jid}")
        wall = time.perf_counter() - t1
        counts = _counts()
    finally:
        srv.httpd.shutdown()
        th.join(30)
        srv.pipe = None     # the job worker thread keeps the server alive
    result = _decode_array(out["video"])
    if code != 200 or result.shape != (1, 3, T, Hp, Wp):
        raise AssertionError(f"track serve: /result {code} {result.shape}")
    if st.calls.get("track_video_flow_device") != 1:
        raise AssertionError(f"track serve: tracker calls {st.calls}")
    b4 = _check_serve_launches("track_method_flow", counts)
    _add(total, counts)
    track["serve_flow_17f"] = {
        "wall_seconds": wall, "stages": dict(st.seconds),
        "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "b4_mode": b4}
    print(json.dumps({"track_serve": "track_method_flow_17f",
                      **track["serve_flow_17f"]}), flush=True)


def track_card_vs_cpu(dev) -> dict:
    """(d): DenseTrack3D, UniDepth V2 and the flow tracker at tiny configs,
    on the card and on the CPU with the same weights and inputs, in fp32
    (TF32 off); the bounds are derived in the module docstring."""
    import numpy as np
    import torch
    from flexam_tpu_torch.perception import densetrack3d as dt
    from flexam_tpu_torch.perception import unidepth as ud
    from flexam_tpu_torch.perception.flow_device import \
        track_video_flow_device
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    out = {}
    rs = np.random.RandomState(SEED + 90)
    # DenseTrack3D
    cpu_m = dt.DenseTrack3D(**TRACK_DT_TINY, seed=SEED + 91, device="cpu")
    gpu_m = dt.DenseTrack3D(**TRACK_DT_TINY, seed=SEED + 91, device=dev)
    gpu_m.params = to(cpu_m.params, dev)
    video = rs.rand(1, 11, 3, 72, 104).astype(np.float32)
    depth = 1.0 + rs.rand(1, 11, 1, 72, 104).astype(np.float32)
    ref = dt.DensePredictor3D(cpu_m)(video, depth)
    got = dt.DensePredictor3D(gpu_m)(video, depth)
    uv_err = (got["trajs_uv"].cpu() - ref["trajs_uv"]).abs().max().item()
    vis_err = (got["vis"].cpu() - ref["vis"]).abs().max().item()
    d_rel = ((got["trajs_depth"].cpu() - ref["trajs_depth"]).abs().max()
             / ref["trajs_depth"].abs().max()).item()
    flips = ((got["vis"].cpu() > 0.5) != (ref["vis"] > 0.5))
    near = (ref["vis"] - 0.5).abs() < CARD_CPU_VIS
    if not (uv_err <= CARD_CPU_UV_PX and vis_err <= CARD_CPU_VIS
            and d_rel <= CARD_CPU_REL and not (flips & ~near).any()):
        raise AssertionError(f"track card vs cpu, densetrack3d: uv {uv_err}"
                             f" vis {vis_err} depth rel {d_rel} flips "
                             f"{int(flips.sum())}")
    out["densetrack3d"] = {
        "uv_max_abs_px": uv_err, "vis_max_abs": vis_err,
        "depth_max_rel": d_rel, "vis_flips": int(flips.sum()),
        "early_exit_windows": [cpu_m.last_info["early_exit_windows"],
                               gpu_m.last_info["early_exit_windows"]]}
    # UniDepth V2
    cfg = ud.UniDepthV2Config(**TRACK_UD_TINY)
    cpu_u = ud.UniDepthV2(cfg, seed=SEED + 92, device="cpu")
    gpu_u = ud.UniDepthV2(cfg, params=to(cpu_u.params, dev), device=dev)
    rgb = rs.rand(3, 3, 30, 44).astype(np.float32) * 255
    ref, got = cpu_u.infer(rgb), gpu_u.infer(rgb)
    out["unidepth"] = {k: compare(torch.from_numpy(got[k]),
                                  torch.from_numpy(ref[k]), CARD_CPU_REL,
                                  f"track card vs cpu, unidepth {k}")
                       for k in ("depth", "points", "confidence",
                                 "intrinsics")}
    # the flow tracker
    clip = textured_clip(6, 64, 80, TRACK_SHIFT, SEED + 93, "cpu")
    clip = clip.astype(np.float32) / 255.0
    rt, rv = track_video_flow_device(clip, density=8, device="cpu")
    gt, gv = track_video_flow_device(clip, density=8, device=dev)
    both = rv & gv
    err = float(np.abs(gt - rt)[both].max()) if both.any() else 0.0
    flip_share = float((rv != gv).mean())
    if not (err <= CARD_CPU_UV_PX and flip_share <= CARD_CPU_FLIP_SHARE
            and both.mean() > 0.5):
        raise AssertionError(f"track card vs cpu, flow: {err} px, flips "
                             f"{flip_share}, visible {both.mean()}")
    out["flow"] = {"tracks_max_abs_px": err, "vis_flip_share": flip_share,
                   "visible_share": float(both.mean())}
    return out


def phase_track(dev, results: dict, track: dict, total: dict) -> None:
    """The video-input path at full width (module docstring): (a) UniDepth
    V2 on a textured 512x896x97f clip moving by a known translation, (b)
    the device flow tracker on it, held to the translation, (c)
    DenseTrack3D from a reference-format checkpoint file, (d) the card
    against the CPU at tiny configs, (e) `tools.track` and three
    `demo.main` runs at 5B width (DELTA, the Farneback tracker of
    --tracking_method flow, --repaint true); (f) ran before it, on the
    serve phase's pipeline. Launch counts are reset before each run of
    (e)."""
    import gc
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.perception import unidepth
    from flexam_tpu_torch.perception.densetrack3d import (DenseTrack3D,
                                                          load_densetrack3d)
    from flexam_tpu_torch.perception.depth import (DEPTH_BACKENDS,
                                                   estimate_depth,
                                                   register_depth_backend)
    from flexam_tpu_torch.perception.flow_device import \
        track_video_flow_device
    from flexam_tpu_torch.perception.tracking import track_video_delta
    from flexam_tpu_torch.tools.flow_accuracy import (end_point_errors,
                                                      textured_clip)

    t0 = time.perf_counter()
    root = HERE / "build" / "smoke_track"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    F, Hp, Wp = TRACKS_VIDEO
    clip_u8 = textured_clip(F, Hp, Wp, TRACK_SHIFT, SEED + 70, dev)
    video = clip_u8.astype(np.float32) / 255.0             # [T, H, W, 3]

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def stop(t1):
        torch.cuda.synchronize()
        return (time.perf_counter() - t1,
                torch.cuda.max_memory_allocated() / 1e9)

    # (a) UniDepth V2 (ViT-L/14, bf16, random weights) on the clip
    exact_calls["exact_attention"] = 0
    t1 = start()
    depth = estimate_depth(video, backend="unidepth", device=dev)
    secs, peak = stop(t1)
    model = unidepth._BACKEND_CACHE[("__random__", str(dev))]
    (_, _, _, net_hw) = model.geometry(Hp, Wp)
    patches = (net_hw[0] // 14) * (net_hw[1] // 14)
    if depth.shape != (F, Hp, Wp) or not np.isfinite(depth).all() or \
            not (depth > 0).all():
        raise AssertionError(f"track: unidepth depth {depth.shape}")
    chunk = unidepth.video_chunk(model, Hp, Wp)
    track["unidepth_profile"] = profile_forward(
        lambda: unidepth.predict_depth_video(model, video[:chunk], chunk))
    track["unidepth"] = {
        "seconds": secs, "frames_per_second": F / secs,
        "network_input_hw": list(net_hw), "patches_per_frame": patches,
        "tokens_per_frame": patches + 1 + model.cfg.num_register_tokens,
        "chunk_frames": chunk,
        "peak_memory_allocated_gb": peak,
        "exact_calls": exact_calls["exact_attention"],
        "depth_range": [float(depth.min()), float(depth.max())]}
    unidepth._BACKEND_CACHE.clear()
    del model
    # (b), (c) and the tool read this depth through the registry
    register_depth_backend("smoke_unidepth", lambda v, **kw: depth[:len(v)])

    # (b) the flow tracker against the known translation
    t1 = start()
    tracks, vis = track_video_flow_device(video, density=TRACK_DENSITY,
                                          depth_backend="smoke_unidepth",
                                          device=dev)
    secs, peak = stop(t1)
    acc = end_point_errors(tracks, vis, TRACK_SHIFT, Hp, Wp)
    grid = (len(range(TRACK_DENSITY // 2, Hp, TRACK_DENSITY))
            * len(range(TRACK_DENSITY // 2, Wp, TRACK_DENSITY)))
    if tracks.shape != (F, grid, 3) or not (
            acc["median_end_point_error_px"] < TRACK_FLOW_BOUND_PX
            and acc["mean_error_px"] < TRACK_FLOW_BIAS_PX
            and acc["visible_share"] >= TRACK_FLOW_VISIBLE):
        raise AssertionError(f"track: flow tracks {tracks.shape}, {acc}")
    track["flow"] = {"seconds": secs, "peak_memory_allocated_gb": peak,
                     "tracks": list(tracks.shape),
                     "bound_px": TRACK_FLOW_BOUND_PX, **acc}

    # (c) DenseTrack3D (reference config, fp32) from a checkpoint file
    path = root / "densetrack3d.pth"
    written = DenseTrack3D(compute="float32", seed=SEED + 71, device=dev)
    torch.save({"model": {k: v.cpu() for k, v in
                          written.state_dict().items()}}, str(path))
    del written
    t1 = time.perf_counter()
    model = load_densetrack3d(str(path), device=dev, compute="float32")
    load_s = time.perf_counter() - t1
    if not model.load_ok or model.load_report["missed"]:
        raise AssertionError(f"track: densetrack3d load {model.load_report}")
    t1 = start()
    dtracks, dvis = track_video_delta(video, density=TRACK_DENSITY,
                                      model=model,
                                      depth_backend="smoke_unidepth")
    secs, peak = stop(t1)
    hd, wd = model.cfg.dense_reso
    n = -(-hd // TRACK_DENSITY) * -(-wd // TRACK_DENSITY)
    if dtracks.shape != (F, n, 3) or not np.isfinite(dtracks).all() or \
            not (dtracks[..., 2] > 0).all():
        raise AssertionError(f"track: densetrack3d tracks {dtracks.shape}")
    info = model.last_info
    # one window (16 frames, 4 iterations) under the profiler
    track["densetrack3d_profile"] = profile_forward(
        lambda: track_video_delta(video[:model.cfg.window_len],
                                  density=TRACK_DENSITY, model=model,
                                  depth_backend="smoke_unidepth"))
    track["densetrack3d"] = {
        "seconds": secs, "load_seconds": load_s,
        "checkpoint_mb": path.stat().st_size / 1e6,
        "tensors_mapped": len(model.load_report["loaded"]),
        "peak_memory_allocated_gb": peak, "tracks": list(dtracks.shape),
        "windows": len(info["window_starts"]),
        "early_exit_windows": info["early_exit_windows"],
        "iterations": info["iters"], "checked_deltas": info["checked_deltas"],
        "visible_share": float(dvis.mean())}
    del model, dtracks
    del DEPTH_BACKENDS["smoke_unidepth"]

    # (d) the card against the CPU
    track["card_vs_cpu"] = track_card_vs_cpu(dev)
    for k in ("unidepth", "unidepth_profile", "flow", "densetrack3d",
              "densetrack3d_profile", "card_vs_cpu"):
        print(json.dumps({"track_part": k, **track[k]}), flush=True)

    # (e) the CLIs at 5B width
    clip_path = root / "clip.npz"
    np.savez(clip_path, video=clip_u8, fps=16)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "flexam_tpu_torch.tools.track",
         "--input", str(clip_path), "--output", str(root / "tracks.npz"),
         "--method", "delta", "--delta_ckpt", str(path),
         "--density", str(TRACK_DENSITY),
         "--video_length", str(F), "--sample_size", str(Hp), str(Wp)],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    tool_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"track: tools.track rc {proc.returncode} "
                             f"{proc.stdout[-800:]} {proc.stderr[-1500:]}")
    written = np.load(root / "tracks.npz")
    if written["tracks"].shape != (F, n, 3):
        raise AssertionError(f"track: tools.track {written['tracks'].shape}")
    track["tools_track"] = {"seconds": tool_s,
                            "tracks": list(written["tracks"].shape),
                            "stdout_tail": proc.stdout.strip()
                            .splitlines()[-2:]}

    demo_clip = root / "clip49.npz"
    np.savez(demo_clip, video=clip_u8[:TRACK_DEMO_FRAMES], fps=16)
    del video, clip_u8
    base = ["--prompt", DEMO_PROMPT, "--random_init", "5b", "--sample_size",
            str(Hp), str(Wp), "--seed", str(SEED), "--input_path",
            str(demo_clip), "--video_length", str(TRACK_DEMO_FRAMES),
            "--num_inference_steps", "1", "--generate_type", "full_edit"]
    runs = [("delta_49f", ["--tracking_method", "DELTA"],
             "track_video_delta"),
            ("flow_49f", ["--tracking_method", "flow"],
             "track_video_flow"),
            ("repaint_49f", ["--repaint", "true", "--synthetic_tracks"],
             "repaint")]
    must = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
            "ln_mod_binary")
    demo_runs = {}
    os.environ["FLEXAM_DELTA_CKPT"] = str(path)
    try:
        for name, extra, stage in runs:
            t1 = start()
            _reset_counts()
            with StageTimer(_track_targets()) as st:
                out = demo.main(base + extra + ["--output_dir",
                                                str(root / name)])
            wall, peak = stop(t1)
            counts = _counts()
            st.returned.clear()
            if out.shape != (1, 3, TRACK_DEMO_FRAMES, Hp, Wp) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"track demo {name}: {out.shape}")
            if st.calls.get(stage) != 1 or any(
                    counts[k] == 0 for k in must) or \
                    counts["sparse_attention"] or counts["int8_attention"]:
                raise AssertionError(f"track demo {name}: {st.calls}, "
                                     f"launches {counts}")
            # one forward of 30 blocks a generation: the video's, and the
            # repainted frame's before it (896 tokens with its ref block)
            forwards = 2 if name == "repaint_49f" else 1
            if counts["flash_attention"] != 30 * forwards:
                raise AssertionError(f"track demo {name}: B1 launched "
                                     f"{counts['flash_attention']} times")
            _add(total, counts)
            demo_runs[name] = {"wall_seconds": wall,
                               "stages": dict(st.seconds),
                               "peak_memory_allocated_gb": peak,
                               "launches": counts}
            print(json.dumps({"track_demo": name, **demo_runs[name]}),
                  flush=True)
            del out
    finally:
        os.environ.pop("FLEXAM_DELTA_CKPT", None)
    track["demo"] = demo_runs
    for k in results:
        results[k]["track_launches"] = total.get(k, 0)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("track", t0, **track, launches_all_runs=total)


# ---------------------------------------------------------------------------
# Camera and image geometry: MoGe-2, VGGT, Pi3 and the demo's branches
# ---------------------------------------------------------------------------

GEOMETRY_FRAMES = 49               # the demo clip of the geometry runs
GEOMETRY_PATH_FRAMES = 17          # the video given as the camera path
GEOMETRY_POSE_ATOL = 1e-6          # random VGGT / Pi3: identity poses
GEO_MOGE_TINY = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                     num_register_tokens=2, output_idx=(1, 2),
                     pretrain_img_size=28, head_dim=32, num_upsamples=1,
                     pixels_min=28 * 28, pixels_max=70 * 70)
GEO_VGGT_TINY = dict(patch_size=14, embed_dim=32, enc_depth=2, enc_heads=2,
                     num_register_tokens=0, agg_dim=32, agg_depth=2,
                     agg_heads=2, cam_iters=2, cam_heads=2,
                     depth_taps=(0, 1), depth_features=16)
GEO_PI3_TINY = dict(patch_size=14, embed_dim=32, enc_depth=2, enc_heads=2,
                    num_register_tokens=0, dec_dim=32, dec_depth=1,
                    dec_heads=2, infer_hw=(28, 42))


def _geometry_targets():
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.conditioning.camera import CameraMotionGenerator
    from flexam_tpu_torch.perception import moge, pi3, pose_solver, vggt
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline as Pipe
    return [(demo, "_build_models"), (moge, "load_moge"),
            (moge.MoGeModel, "infer"), (vggt, "load_vggt"),
            (vggt, "vggt_video_poses"), (pi3, "load_pi3"),
            (pi3, "pi3_video_poses"),
            (CameraMotionGenerator, "process_video_file"),
            (pose_solver, "solve_camera_poses"),
            (Pipe, "encode_prompt"),
            (Pipe, "prepare_conditioning_from_tracks"), (Pipe, "denoise"),
            (Pipe, "decode_u8")]


def write_shape_mapped(params, path: Path) -> float:
    """A model's tree as a reference-format checkpoint of random values in
    the port's loader order (names that sort in it), in bf16 to save disk:
    `.safetensors` by the port's writer, else torch.save. Returns MB."""
    import torch
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    from flexam_tpu_torch.perception.densetrack3d import _jax_leaves
    sd = {f"tensor_{i:04d}": t.detach().to("cpu", torch.bfloat16)
          for i, (_, t) in enumerate(_jax_leaves(params))}
    if path.suffix == ".safetensors":
        save_safetensors(str(path), sd)
    else:
        torch.save(sd, str(path))
    return path.stat().st_size / 1e6


def geometry_card_vs_cpu(dev) -> dict:
    """(d): MoGe-2, VGGT and Pi3 at tiny configs, on the card and on the CPU
    with the same weights and inputs, in fp32 (TF32 off), the camera heads'
    zero-initialised last layers set to random values; bounds in the
    module docstring."""
    import numpy as np
    import torch
    from flexam_tpu_torch.perception import moge, pi3, vggt

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    def fc2(params, n, seed):
        g = torch.Generator().manual_seed(seed)
        d = params["cam_fc2"]["weight"].shape[1]
        params["cam_fc2"] = {
            "weight": torch.randn((n, d), generator=g) * 0.05,
            "bias": torch.randn((n,), generator=g) * 0.05}

    def rel(name, got, ref):
        return compare(torch.as_tensor(np.asarray(got)),
                       torch.as_tensor(np.asarray(ref)), CARD_CPU_REL,
                       f"geometry card vs cpu, {name}")["max_rel_err"]

    rs = np.random.RandomState(SEED + 120)
    out = {}
    cfg = moge.MoGeConfig(**GEO_MOGE_TINY)
    cpu = moge.MoGeModel(cfg, seed=SEED + 121, device="cpu")
    card = moge.MoGeModel(cfg, params=to(cpu.params, dev), device=dev)
    img = rs.rand(3, 44, 60).astype(np.float32)
    ref, got = cpu.infer(img), card.infer(img)
    logits = cpu.last_info["mask_logits"]
    flips = got["mask"] != ref["mask"]
    near = np.abs(logits) <= CARD_CPU_REL * np.abs(logits).max()
    if (flips & ~near).any():
        raise AssertionError(f"geometry card vs cpu, moge: "
                             f"{int(flips.sum())} mask flips off 0")
    out["moge"] = {"mask_flips": int(flips.sum()),
                   "normal_max_rel": rel("moge normal", got["normal"],
                                         ref["normal"])}
    if not flips.any():     # a flip moves the solver's point set
        out["moge"].update({f"{k}_max_rel": rel(f"moge {k}", got[k], ref[k])
                            for k in ("points", "depth", "intrinsics")})
    cfg = vggt.VGGTConfig(**GEO_VGGT_TINY)
    cpu = vggt.VGGT(cfg, seed=SEED + 122, device="cpu")
    fc2(cpu.params, 9, SEED + 123)
    card = vggt.VGGT(cfg, device=dev)
    card.params = to(cpu.params, dev)
    imgs = rs.rand(1, 3, 3, 28, 42).astype(np.float32)
    rt, _ = cpu.aggregator(imgs)
    gt, _ = card.aggregator(imgs)
    video = rs.rand(3, 30, 40, 3).astype(np.float32)
    re_, ri = vggt.vggt_video_poses(video, model=cpu)
    ge, gi = vggt.vggt_video_poses(video, model=card)
    out["vggt"] = {
        "tokens_max_rel": max(rel("vggt tokens", a.cpu(), b)
                              for a, b in zip(gt, rt)),
        "pose_encoding_max_rel": rel("vggt camera head",
                                     card.camera_head(gt)[-1],
                                     cpu.camera_head(rt)[-1]),
        "extrinsics_max_rel": rel("vggt extrinsics", ge, re_),
        "intrinsics_max_rel": rel("vggt intrinsics", gi, ri)}
    cfg = pi3.Pi3Config(**GEO_PI3_TINY)
    cpu = pi3.Pi3(cfg, seed=SEED + 124, device="cpu")
    fc2(cpu.params, 7, SEED + 125)
    card = pi3.Pi3(cfg, device=dev)
    card.params = to(cpu.params, dev)
    imgs = rs.rand(1, 3, 3, 28, 42).astype(np.float32)
    ref, got = cpu(imgs), card(imgs)
    video = rs.rand(6, 30, 44, 3).astype(np.float32)
    out["pi3"] = {**{f"{k}_max_rel": rel(f"pi3 {k}", got[k], ref[k])
                     for k in ref},
                  "video_poses_max_rel": rel(
                      "pi3 video poses",
                      pi3.pi3_video_poses(video, model=card, chunk=1),
                      pi3.pi3_video_poses(video, model=cpu, chunk=1))}
    return out


def phase_geometry(dev, results: dict) -> None:
    """Camera and image geometry at full width (module docstring): (a)
    MoGe-2 on one 512x896 frame, (b) VGGT and (c) Pi3 through their video
    pose helpers on a 49-frame 512x896 clip, random weights from seeds; (d)
    the card against the CPU at tiny configs; (e) three `demo.main` runs at
    5B width, 49 frames, 1 step, each taking its geometry from a model
    loaded from a reference-format file of random bf16 values. Launch
    counts are reset before each run of (e) and read after it."""
    import gc
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch import demo
    from flexam_tpu_torch.core.attention import exact_calls
    from flexam_tpu_torch.perception import moge, pi3, vggt
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip

    t0 = time.perf_counter()
    root = HERE / "build" / "smoke_geometry"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    F, Hp, Wp = GEOMETRY_FRAMES, TRACKS_VIDEO[1], TRACKS_VIDEO[2]
    clip_u8 = textured_clip(F, Hp, Wp, TRACK_SHIFT, SEED + 110, dev)
    video = clip_u8.astype(np.float32) / 255.0             # [T, H, W, 3]
    geo = {}

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        exact_calls["exact_attention"] = 0
        return time.perf_counter()

    def stop(t1):
        torch.cuda.synchronize()
        return (time.perf_counter() - t1,
                torch.cuda.max_memory_allocated() / 1e9,
                exact_calls["exact_attention"])

    # (a) MoGe-2 on the clip's first frame
    model = moge.MoGeModel(seed=SEED + 111, device=dev)
    t1 = start()
    out = model.infer(video[0].transpose(2, 0, 1))
    secs, peak, calls = stop(t1)
    info = model.last_info
    nh, nw = info["network_hw"]
    if out["points"].shape != (Hp, Wp, 3) or not all(
            np.isfinite(out[k]).all() for k in ("points", "intrinsics")):
        raise AssertionError(f"geometry: moge {out['points'].shape}")
    geo["moge"] = {
        "seconds": secs, "network_input_hw": [nh, nw],
        "patches": (nh // 14) * (nw // 14),
        "tokens": (nh // 14) * (nw // 14) + 1
        + model.cfg.num_register_tokens,
        "peak_memory_allocated_gb": peak, "exact_calls": calls,
        "focal": info["focal"], "shift": info["shift"],
        "scale": info["scale"], "mask_share": float(out["mask"].mean())}
    moge_file = root / "moge.pt"
    geo["moge"]["checkpoint_mb"] = write_shape_mapped(model.params,
                                                      moge_file)
    del model, out

    # (b) VGGT through vggt_video_poses
    model = vggt.VGGT(seed=SEED + 112, device=dev)
    t1 = start()
    extr, intr = vggt.vggt_video_poses(video, model=model)
    secs, peak, calls = stop(t1)
    eye = np.eye(3, dtype=np.float32)
    if extr.shape != (F, 3, 4) or intr.shape != (F, 3, 3) or not (
            np.abs(extr[:, :, :3] - eye).max() <= GEOMETRY_POSE_ATOL
            and np.abs(extr[:, :, 3]).max() <= GEOMETRY_POSE_ATOL):
        raise AssertionError(f"geometry: vggt poses {extr.shape} "
                             f"{np.abs(extr[:, :, :3] - eye).max()}")
    new_h = round(Hp * (518 / Wp) / 14) * 14
    per_frame = (new_h // 14) * (518 // 14) + model.cfg.n_special
    geo["vggt"] = {
        "seconds": secs, "network_input_hw": [new_h, 518],
        "tokens_per_frame": per_frame, "tokens_total": per_frame * F,
        "peak_memory_allocated_gb": peak, "exact_calls": calls,
        "rotation_max_dev": float(np.abs(extr[:, :, :3] - eye).max()),
        "translation_max_abs": float(np.abs(extr[:, :, 3]).max()),
        "fx": float(intr[0, 0, 0])}
    vggt_file = root / "vggt.safetensors"
    geo["vggt"]["checkpoint_mb"] = write_shape_mapped(model.params,
                                                      vggt_file)
    del model

    # (c) Pi3 through pi3_video_poses
    model = pi3.Pi3(seed=SEED + 113, device=dev)
    t1 = start()
    c2w = pi3.pi3_video_poses(video, model=model)
    secs, peak, calls = stop(t1)
    eye4 = np.eye(4, dtype=np.float32)
    if c2w.shape != (F, 4, 4) or not np.abs(
            c2w - eye4).max() <= GEOMETRY_POSE_ATOL:
        raise AssertionError(f"geometry: pi3 poses {c2w.shape}")
    views = len(pi3.pi3_views(F))
    ih, iw = model.cfg.infer_hw
    geo["pi3"] = {
        "seconds": secs, "views": views, "stride": int(
            pi3.pi3_views(F)[1]), "network_input_hw": [ih, iw],
        "tokens_per_view": (ih // 14) * (iw // 14),
        "tokens_total": views * (ih // 14) * (iw // 14),
        "peak_memory_allocated_gb": peak, "exact_calls": calls,
        "pose_max_dev": float(np.abs(c2w - eye4).max())}
    pi3_file = root / "pi3.pt"
    geo["pi3"]["checkpoint_mb"] = write_shape_mapped(model.params, pi3_file)
    del model

    # (d) the card against the CPU
    geo["card_vs_cpu"] = geometry_card_vs_cpu(dev)
    for k in ("moge", "vggt", "pi3", "card_vs_cpu"):
        print(json.dumps({"geometry_part": k, **geo[k]}), flush=True)

    # (e) the demo's geometry branches at 5B width
    img = root / "frame.npy"
    np.save(img, clip_u8[0])
    omask = np.zeros((Hp, Wp), np.uint8)
    omask[Hp // 4: 3 * Hp // 4, Wp // 3: 2 * Wp // 3] = 255
    np.save(root / "object_mask.npy", omask)
    np.savez(root / "clip.npz", video=clip_u8, fps=16)
    # the camera path's video: 17 frames (Pi3 runs on every one), only
    # its frame dump, no .mp4
    np.savez(root / "path.mp4.npz", video=clip_u8[:GEOMETRY_PATH_FRAMES],
             fps=16)
    tracks, vis = grid_tracks(F, Hp, Wp, TRACK_DENSITY, SEED + 114)
    np.savez(root / "tracks.npz", tracks=tracks, visibility=vis)
    del video, clip_u8
    base = ["--prompt", DEMO_PROMPT, "--random_init", "5b", "--sample_size",
            str(Hp), str(Wp), "--seed", str(SEED), "--video_length",
            str(F), "--num_inference_steps", "1", "--generate_type",
            "full_edit"]
    video_in = ["--input_path", str(root / "clip.npz"), "--tracks_npz",
                str(root / "tracks.npz")]
    runs = [("moge_image_49f", {"FLEXAM_MOGE_CKPT": moge_file},
             ["--input_path", str(img), "--object_motion", "up",
              "--object_mask", str(root / "object_mask.npy")],
             {"load_moge": 1, "infer": 1}),
            ("vggt_camera_49f", {"FLEXAM_VGGT_CKPT": vggt_file},
             video_in + ["--camera_motion", "rot y 10"],
             {"load_vggt": 1, "vggt_video_poses": 1}),
            ("pi3_path_49f", {"FLEXAM_PI3_CKPT": pi3_file},
             video_in + ["--camera_motion", "path", "--pose_file",
                         str(root / "path.mp4")],
             {"load_pi3": 2, "pi3_video_poses": 1,
              "process_video_file": 1})]
    must = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
            "ln_mod_binary")
    envs = ("FLEXAM_MOGE_CKPT", "FLEXAM_VGGT_CKPT", "FLEXAM_PI3_CKPT",
            "FLEXAM_MOGE_BESTEFFORT")
    saved = {k: os.environ.pop(k, None) for k in envs}
    total, demo_runs = {}, {}
    try:
        for name, env, extra, calls in runs:
            os.environ.update({k: str(v) for k, v in env.items()})
            t1 = start()
            _reset_counts()
            with StageTimer(_geometry_targets(), keep_returned=False) as st:
                out = demo.main(base + extra + ["--output_dir",
                                                str(root / name)])
            wall, peak, _ = stop(t1)
            counts = _counts()
            for k in env:
                del os.environ[k]
            if out.shape != (1, 3, F, Hp, Wp) or not np.isfinite(out).all():
                raise AssertionError(f"geometry demo {name}: {out.shape}")
            if any(st.calls.get(k) != n for k, n in calls.items()) or \
                    st.calls.get("solve_camera_poses"):
                raise AssertionError(f"geometry demo {name}: the geometry "
                                     f"did not come from the model: "
                                     f"{st.calls}")
            if any(counts[k] == 0 for k in must) or \
                    counts["sparse_attention"] or \
                    counts["int8_attention"] or \
                    counts["flash_attention"] != 30:
                raise AssertionError(f"geometry demo {name}: launches "
                                     f"{counts}")
            _add(total, counts)
            demo_runs[name] = {"wall_seconds": wall,
                               "stages": dict(st.seconds),
                               "calls": dict(st.calls),
                               "peak_memory_allocated_gb": peak,
                               "launches": counts}
            print(json.dumps({"geometry_demo": name, **demo_runs[name]}),
                  flush=True)
            del out
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    geo["demo"] = demo_runs
    for k in results:
        results[k]["geometry_launches"] = total.get(k, 0)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("geometry", t0, **geo, launches_all_runs=total)


# ---------------------------------------------------------------------------
# nodes: the ComfyUI node pack on the card
# ---------------------------------------------------------------------------

NODES_FRAMES = 49                  # the annotators' clip, 512x896
NODES_BASE_RESOLUTION = 640        # the sampler widget's default: 480x832
NODES_LORA_RANK = 8
NODES_PROMPT = "a red fox runs through fresh snow"
NODES_NEGATIVE = "blurry, low quality"
# Canny thresholds for the textured clip (its gray level's std is ~17: the
# widget's default 100 / 200 finds no edge in it)
NODES_CANNY = (30, 60)
NODES_POSE_HW = (480, 832)         # VideoToPose's crop of the clip
NODES_POSE_DIFF_SHARE = 1e-3       # rendered pixels card vs CPU (docstring)
NODES_GRAPH_REL = 1e-5             # tiny DWPose graphs' outputs, card vs CPU
NODES_PUBLISHED_REL = 1e-5         # YOLOX-L / RTMPose-l outputs, card vs CPU
NODES_FLOW_CARD_CPU_PX = 1e-4      # Farneback end-point difference, card


def _tf32_rounded(graph) -> None:
    """Round a graph's fp32 weights to TF32's 10-bit mantissa in place."""
    import torch
    for k, v in graph.consts.items():
        if v.dtype == torch.float32:
            graph.consts[k] = ((v.view(torch.int32) + 0x1000)
                               & ~0x1FFF).view(torch.float32)


def _graph_pairs(card, cpu, frames, pose_input=(288, 384)):
    """[(card outputs, CPU outputs)] of a detector / estimator pair of
    `OnnxGraph`s on each frame's letterbox and on each person's crop (the
    CPU's boxes), and the last inputs of each graph."""
    from flexam_tpu_torch.perception import dwpose
    pairs = []
    for f in frames:
        x, ratio = dwpose.letterbox(f)
        det = [o.cpu() for o in card[0](x[None])], cpu[0](x[None])
        pairs.append(det)
        for box in dwpose.detect_people(det[1][0].numpy()[0], ratio):
            crop = dwpose.crop_person(f, box, pose_input)[0].transpose(
                2, 0, 1)[None]
            pairs.append(([o.cpu() for o in card[1](crop)],
                          cpu[1](crop)))
    return pairs, x[None], crop


def pose_flow_card_vs_cpu(dev, clip_u8, det: str, pose: str,
                          published: tuple) -> dict:
    """(d), DWPose and Farneback (module docstring). The tiny graphs, with
    their features as outputs (`flexam_tpu_torch/testing.py`), on 2 frames
    of the pose crop (the detector's outputs, then the estimator's on each
    person's crop) on the card against the CPU within NODES_GRAPH_REL, the
    keypoints equal, the rendered frames equal but for
    NODES_POSE_DIFF_SHARE of the pixels. YOLOX-L and RTMPose-l
    (`published`, random weights) the same way on 1 frame within
    NODES_PUBLISHED_REL, and again with their weights rounded to TF32,
    which must leave that bound. Farneback's forward and backward flows
    between 3 frames within NODES_FLOW_CARD_CPU_PX. Each graph's call and
    the 4 flows are timed on the card, and the flow tracker on a
    512x896x97f clip (time and peak)."""
    import gc

    import numpy as np
    import torch
    from flexam_tpu_torch import testing
    from flexam_tpu_torch.perception import dwpose
    from flexam_tpu_torch.perception.farneback import farneback_pairs
    from flexam_tpu_torch.perception.onnx_graph import OnnxGraph
    from flexam_tpu_torch.perception.tracking import (FLOW_PAIRS,
                                                      track_video_flow)
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip

    def worst(pairs, bound, name):
        return max(compare(g, r, bound, name)["max_rel_err"]
                   for got, ref in pairs for g, r in zip(got, ref))

    frames = clip_u8[:2]
    tiny = [testing.tiny_yolox_onnx(SEED + 144, features=True),
            testing.tiny_rtmpose_onnx(SEED + 144, features=True)]
    card = [OnnxGraph(b, device=dev) for b in tiny]
    pairs, x, crop = _graph_pairs(card, [OnnxGraph(b, device="cpu")
                                         for b in tiny], frames)
    out = {"dwpose_tiny_max_rel": worst(
        pairs, NODES_GRAPH_REL, "nodes card vs cpu, tiny dwpose graphs"),
        "dwpose_tiny_bound_rel": NODES_GRAPH_REL,
        "dwpose_tiny_graph_calls": len(pairs)}
    on_card = dwpose.DWPoseDetector(det, pose, device=dev)
    on_cpu = dwpose.DWPoseDetector(det, pose, device="cpu")
    persons, score_diff = 0, 0.0
    for f in frames:
        (kc, sc), (kr, sr) = on_card(f), on_cpu(f)
        if not np.array_equal(kc, kr):
            raise AssertionError("nodes card vs cpu: dwpose keypoints "
                                 "differ")
        persons += len(kc)
        score_diff = max(score_diff, float(np.abs(sc - sr).max()))
    video = frames.astype(np.float32) / 255.0
    rendered = dwpose.dwpose_video(video, det, pose, device=dev)
    want = dwpose.dwpose_video(video, det, pose, device="cpu")
    differ = int((rendered != want).any(-1).sum())
    if differ > NODES_POSE_DIFF_SHARE * rendered[..., 0].size:
        raise AssertionError(f"nodes card vs cpu: dwpose renders differ on "
                             f"{differ} pixels")
    out.update({"dwpose_persons": persons,
                "dwpose_score_max_abs_diff": score_diff,
                "dwpose_render_pixels_differing": differ,
                "dwpose_tiny_det_graph_ms": device_ms(
                    lambda: card[0](x), launches=5, reps=3),
                "dwpose_tiny_pose_graph_ms": device_ms(
                    lambda: card[1](crop), launches=5, reps=3)})
    # YOLOX-L and RTMPose-l: card vs CPU, the TF32 check, times
    card = [OnnxGraph(p, device=dev) for p in published]
    cpu = [OnnxGraph(p, device="cpu") for p in published]
    pairs, x, crop = _graph_pairs(card, cpu, frames[:1])
    out["dwpose_published_max_rel"] = worst(
        pairs, NODES_PUBLISHED_REL, "nodes card vs cpu, YOLOX-L / RTMPose-l")
    out["dwpose_published_bound_rel"] = NODES_PUBLISHED_REL
    out["dwpose_published_graph_calls"] = len(pairs)
    out["dwpose_published_det_graph_ms"] = device_ms(
        lambda: card[0](x), launches=5, reps=3)
    out["dwpose_published_pose_graph_ms"] = device_ms(
        lambda: card[1](crop), launches=5, reps=3)
    out["dwpose_published_det_graph_profile"] = profile_forward(
        lambda: card[0](x))
    out["dwpose_published_pose_graph_profile"] = profile_forward(
        lambda: card[1](crop))
    for g in card:
        _tf32_rounded(g)
    out["dwpose_published_tf32_weights_max_rel"] = max(
        ((a.cpu() - b).abs().max() / b.abs().max()).item()
        for g, inp, ref in ((card[0], x, pairs[0][1]),
                            (card[1], crop, pairs[-1][1]))
        for a, b in zip(g(inp), ref))
    if not out["dwpose_published_tf32_weights_max_rel"] > \
            NODES_PUBLISHED_REL:
        raise AssertionError("nodes card vs cpu: TF32-rounded weights stay "
                             "within NODES_PUBLISHED_REL, which then "
                             "cannot tell TF32 from fp32")
    del card, cpu
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    gray = torch.from_numpy(np.stack([
        (f.astype(np.float32) / 255.0 @ luma * 255).astype(np.uint8)
        for f in clip_u8[:3]]))
    i = np.arange(2)
    prev, nxt = np.concatenate([i, i + 1]), np.concatenate([i + 1, i])
    flow_card = farneback_pairs(gray.to(dev), prev, nxt).cpu()
    out["farneback_card_ms_4_pairs"] = device_ms(
        lambda: farneback_pairs(gray.to(dev), prev, nxt), launches=3, reps=3)
    t1 = time.perf_counter()
    host = farneback_pairs(gray, prev, nxt)
    host_s = time.perf_counter() - t1
    epe = (flow_card - host).norm(dim=-1)
    if not epe.max().item() <= NODES_FLOW_CARD_CPU_PX:
        raise AssertionError(f"nodes card vs cpu: farneback end-point "
                             f"difference {epe.max().item()}")
    out.update({"farneback_pairs": int(len(prev)),
                "farneback_hw": list(gray.shape[1:]),
                "farneback_end_point_diff_max_px": epe.max().item(),
                "farneback_end_point_diff_mean_px": epe.mean().item(),
                "farneback_bound_px": NODES_FLOW_CARD_CPU_PX,
                "farneback_host_seconds_4_pairs": host_s,
                "flow_mean_px": host.norm(dim=-1).mean().item()})
    # the tracker at 97 frames, 512x896: its flows are batched FLOW_PAIRS
    # pairs at a time, so its peak should not grow with the clip
    long_clip = textured_clip(97, 512, 896, TRACK_SHIFT, SEED + 147, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    tracks, vis = track_video_flow(long_clip.astype(np.float32) / 255.0,
                                   density=TRACK_DENSITY,
                                   depth_backend="luminance", device=dev)
    torch.cuda.synchronize()
    if not (np.isfinite(tracks).all() and vis[-1].any()):
        raise AssertionError("nodes: the flow tracker at 97 frames")
    out["farneback_tracker_97f"] = {
        "seconds": time.perf_counter() - t1, "frames": 97, "hw": [512, 896],
        "tracks": int(tracks.shape[1]), "flow_pairs_a_batch": FLOW_PAIRS,
        "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "visible_share_last": float(vis[-1].mean())}
    return out


def _nodes_targets():
    from flexam_tpu_torch.nodes import FlexAMV2VSampler
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline as Pipe
    from flexam_tpu_torch.utils import masks
    return [(FlexAMV2VSampler, "_apply_loras"),
            (masks, "generate_mask_fg_tracking"), (Pipe, "encode_prompt"),
            (Pipe, "prepare_conditioning"), (Pipe, "denoise"),
            (Pipe, "decode_u8")]


def nodes_card_vs_cpu(dev) -> dict:
    """(d): ZoeDepth and Depth-Anything-V2 at the tiny configs of
    tests/test_torch_{zoedepth,depth_anything}.py on the card and on the
    CPU, the same weights and inputs in fp32 (TF32 off), and Canny of one
    512x896 frame on the card and on the host. The two devices sum in other
    orders (cuBLAS, cuDNN, the GPU's reductions): a K-term fp32 sum moves
    by at most about K x 2^-24 of its size, K <= 576 here (the 3x3 convs
    over 64 channels, the 2x-wide MLP), 3.4e-5, typically 1e-6, so through
    the few layers of the tiny models the depths stay within 1e-3 of their
    largest value (CARD_CPU_REL). Canny is integer work (Sobel, the
    fixed-point sectors, the union-find): the edges must be equal."""
    import numpy as np
    import torch
    from flexam_tpu_torch.perception import depth_anything as dav2
    from flexam_tpu_torch.perception import zoedepth as zoe
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip
    from flexam_tpu_torch.utils.cv import canny_u8, rgb_to_gray_cv

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    def rel(name, got, ref):
        return compare(torch.as_tensor(np.asarray(got)),
                       torch.as_tensor(np.asarray(ref)), CARD_CPU_REL,
                       f"nodes card vs cpu, {name}")["max_rel_err"]

    rs = np.random.RandomState(SEED + 130)
    video = rs.rand(3, 48, 64, 3).astype(np.float32)
    cfg = zoe.tiny_zoe_config()
    gen = torch.Generator().manual_seed(SEED + 131)
    cpu = zoe.ZoeDepth(cfg, params=zoe.zoedepth_init(gen, cfg, "cpu"),
                       device="cpu")
    card = zoe.ZoeDepth(cfg, params=to(cpu.params, dev), device=dev)
    x = video[:1].transpose(0, 3, 1, 2)
    out = {"zoe_video_max_rel": rel(
        "zoe video", zoe.zoe_depth_video(video, model=card, batch=2),
        zoe.zoe_depth_video(video, model=cpu, batch=2)),
        "zoe_infer_pad_flip_max_rel": rel("zoe infer", card.infer(x),
                                          cpu.infer(x))}
    dcfg = dav2.tiny_dav2_config()
    gen = torch.Generator().manual_seed(SEED + 132)
    params = dav2.dav2_init(gen, dcfg, "cpu")
    out["dav2_video_max_rel"] = rel(
        "dav2 video", dav2.dav2_infer_video(to(params, dev), video, dcfg, 2),
        dav2.dav2_infer_video(params, video, dcfg, 2))
    frame = rgb_to_gray_cv(textured_clip(1, TRACKS_VIDEO[1], TRACKS_VIDEO[2],
                                         TRACK_SHIFT, SEED + 133, dev)[0])
    t1 = time.perf_counter()
    host = canny_u8(frame, *NODES_CANNY)
    host_s = time.perf_counter() - t1
    on_card = canny_u8(frame, *NODES_CANNY, device=dev)
    differ = int((on_card != host).sum())
    if differ:
        raise AssertionError(f"nodes card vs cpu: canny differs on {differ} "
                             "pixels")
    out.update({"canny_pixels_differing": differ,
                "canny_edge_share": float((host > 0).mean()),
                "canny_host_seconds_one_frame": host_s})
    return out


def phase_nodes(dev, results: dict) -> None:
    """The ComfyUI node pack at full width (module docstring): (a) the
    depth annotators (VideoToDepth through Depth-Anything-V2-Large, then
    ZoeDepth ZoeD_M12_N, each read from a reference-format file of random
    weights) on a textured 512x896x49f clip; (b) VideoToTrackingPredict
    (no DELTA file: the Farneback tracker), VideoToTrackingVisualizeAll
    and VideoToCanny on it, and VideoToPose (DWPose on the tiny graphs,
    then on YOLOX-L and RTMPose-l of random weights, then raw keypoints)
    on a 480x832 crop; (c) LoadFlexAMModel at
    Wan2.2-Fun-5B width and FlexAMV2VSampler at the widgets' defaults
    (480x832x49f, 5,460 tokens
    with the ref frame), 2 steps with a rank-8 LoRA through the host cache,
    a second run at strength 0.5 (1 step), an fg_generation step with a
    mask video and a step after FunAttention("sparse"); (d) the card
    against the CPU. Launch counts are reset before each run of (c) and
    read after it ("nodes_launches")."""
    import gc
    import shutil

    import numpy as np
    import torch

    import flexam_tpu_torch.perception as perception
    from flexam_tpu_torch import nodes as N
    from flexam_tpu_torch.core.attention import _backend_choice, exact_calls
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    from flexam_tpu_torch.perception import depth as depth_registry
    from flexam_tpu_torch.perception import depth_anything as dav2
    from flexam_tpu_torch.perception import flow_device
    from flexam_tpu_torch.perception import zoedepth as zoe
    from flexam_tpu_torch.testing import write_dwpose, write_tiny_dwpose
    from flexam_tpu_torch.tools.flow_accuracy import textured_clip

    t0 = time.perf_counter()
    root = HERE / "build" / "smoke_nodes"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    F, Hp, Wp = NODES_FRAMES, TRACKS_VIDEO[1], TRACKS_VIDEO[2]
    clip_u8 = textured_clip(F, Hp, Wp, TRACK_SHIFT, SEED + 140, dev)
    video = clip_u8.astype(np.float32) / 255.0             # [T, H, W, 3]
    out = {}

    def start():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        return time.perf_counter()

    def stop(t1):
        torch.cuda.synchronize()
        return (time.perf_counter() - t1,
                torch.cuda.max_memory_allocated() / 1e9)

    envs = ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
            "FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT", "FLEXAM_DELTA_CKPT",
            "FLEXAM_ATTENTION", "FLEXAM_DWPOSE_DET", "FLEXAM_DWPOSE_POSE")
    saved = {k: os.environ.pop(k, None) for k in envs}
    picked = []
    originals = {n: depth_registry.DEPTH_BACKENDS[n]
                 for n in ("unidepth", "dav2", "zoe", "luminance")}
    for n, fn in originals.items():
        depth_registry.DEPTH_BACKENDS[n] = (
            lambda v, _n=n, _f=fn, **kw: (picked.append(_n), _f(v, **kw))[1])
    try:
        # (a) the depth annotators from reference-format files
        files = {}
        t1 = time.perf_counter()
        dcfg, zcfg = dav2.DAv2Config(), zoe.ZoeDepthConfig()
        gen = torch.Generator(device=dev).manual_seed(SEED + 141)
        p_dav2 = dav2.dav2_init(gen, dcfg, dev)
        files["dav2"] = root / "depth_anything_v2_vitl.pth"
        torch.save({k: v.to("cpu", torch.bfloat16)
                    for k, v in dav2.dav2_state_dict(p_dav2).items()},
                   str(files["dav2"]))
        gen = torch.Generator(device=dev).manual_seed(SEED + 142)
        p_zoe = zoe.zoedepth_init(gen, zcfg, dev)
        files["zoe"] = root / "ZoeD_M12_N.pt"
        torch.save({"model": {k: v.to("cpu", torch.bfloat16) for k, v in
                              zoe.zoedepth_state_dict(p_zoe).items()}},
                   str(files["zoe"]))
        out["checkpoint_write_seconds"] = time.perf_counter() - t1
        # one forward of each at the node's batch, profiled: 8 DAv2 frames
        # at 518x910, 4 ZoeDepth frames at 384x672
        (dh, dw), (zh, zw) = (dav2._lower_bound_size(
            Hp, Wp, dcfg.input_size, dcfg.patch_size),
            zoe._midas_size(Hp, Wp, zcfg))
        x = torch.randn((8, dh, dw, 3), generator=gen, device=dev)
        out["dav2_forward_profile"] = profile_forward(
            lambda: dav2.dav2_forward(p_dav2, x, dcfg))
        x = torch.rand((4, zh, zw, 3), generator=gen, device=dev)
        out["zoe_forward_profile"] = profile_forward(
            lambda: zoe.zoedepth_forward(p_zoe, zcfg, x))
        del p_dav2, p_zoe, x
        geometry = {
            "dav2": (dav2._lower_bound_size(Hp, Wp, dcfg.input_size,
                                            dcfg.patch_size),
                     dcfg.patch_size),
            "zoe": (zoe._midas_size(Hp, Wp, zcfg), zcfg.patch_size)}
        for name, env in (("dav2", "FLEXAM_DAV2_CKPT"),
                          ("zoe", "FLEXAM_ZOE_CKPT")):
            for k in ("FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT"):
                os.environ.pop(k, None)
            os.environ[env] = str(files[name])
            if name == "zoe":       # a DAv2 file would win: only Zoe's set
                os.environ.pop("FLEXAM_DAV2_CKPT", None)
            picked.clear()
            t1 = start()
            viz, = N.VideoToDepth().process(video, video_length=F,
                                            device=dev)
            secs, peak = stop(t1)
            calls = exact_calls["exact_attention"]
            if picked != [name] or viz.shape != (1, 3, F, Hp, Wp) or not (
                    np.isfinite(viz).all() and 0 <= viz.min()
                    and viz.max() <= 1):
                raise AssertionError(f"nodes: VideoToDepth {name}: picked "
                                     f"{picked}, {viz.shape}")
            (nh, nw), patch = geometry[name]
            out[f"depth_{name}"] = {
                "seconds": secs, "frames_per_second": F / secs,
                "network_input_hw": [nh, nw],
                "tokens_per_frame": (nh // patch) * (nw // patch) + 1,
                "peak_memory_allocated_gb": peak, "exact_calls": calls,
                "checkpoint_mb": files[name].stat().st_size / 1e6,
                "video_mean": float(viz.mean())}
            print(json.dumps({"nodes_part": f"depth_{name}",
                              **out[f"depth_{name}"]}), flush=True)
            del viz
        for k in ("FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT"):
            os.environ.pop(k, None)
        gc.collect()
        torch.cuda.empty_cache()

        # (b) tracking (the Farneback tracker), the visualizers, Canny
        picked.clear()
        t1 = start()
        # (the node takes the tracker from the perception package)
        with StageTimer([(perception, "track_video_flow"),
                         (flow_device, "track_video_flow_device")],
                        keep_returned=False) as st:
            tracks, vis = N.VideoToTrackingPredict().process(
                video, density=TRACK_DENSITY, video_length=F, device=dev)
        secs, peak = stop(t1)
        if tracks.shape[:1] != (F,) or tracks.shape[-1] != 3 or \
                vis.dtype != bool or not np.isfinite(tracks).all() or \
                not vis.any() or st.calls != {"track_video_flow": 1}:
            raise AssertionError(f"nodes: tracking {tracks.shape} "
                                 f"{st.calls}")
        out["tracking"] = {"tracker": "farneback", "seconds": secs,
                           "tracks": int(tracks.shape[1]),
                           "hw": [Hp, Wp], "frames": F,
                           "visible_share_last": float(vis[-1].mean()),
                           "depth_backend": picked,
                           "peak_memory_allocated_gb": peak}
        print(json.dumps({"nodes_part": "tracking", **out["tracking"]}),
              flush=True)
        t1 = time.perf_counter()
        streams = N.VideoToTrackingVisualizeAll().process(
            tracks, vis, input_video=video)
        out["visualize_all_host_seconds"] = time.perf_counter() - t1
        if len(streams) != 6 or any(s.shape != (1, 3, F, Hp, Wp)
                                    for s in streams):
            raise AssertionError("nodes: visualizers "
                                 f"{[s.shape for s in streams]}")
        t1 = time.perf_counter()
        canny, = N.VideoToCanny().process(video, *NODES_CANNY,
                                          video_length=F)
        out["canny_host_seconds"] = time.perf_counter() - t1
        out["canny_edge_share"] = float((canny > 0).mean())
        if canny.shape != (1, 3, F, Hp, Wp) or not canny.any():
            raise AssertionError(f"nodes: canny {canny.shape}")
        print(json.dumps({"nodes_part": "annotators",
                          **{k: out[k] for k in (
                              "tracking", "visualize_all_host_seconds",
                              "canny_host_seconds", "canny_edge_share")}}),
              flush=True)
        del canny
        tracking_video, depth_video, *cos = streams
        del streams

        # (b) VideoToPose: the native DWPose on the tiny graphs, then the
        # raw-keypoint branch, on a 480x832 crop
        ph, pw = NODES_POSE_HW
        pose_video = video[:, :ph, :pw]
        det, pose = write_tiny_dwpose(str(root), seed=SEED + 144)
        os.environ["FLEXAM_DWPOSE_DET"] = det
        os.environ["FLEXAM_DWPOSE_POSE"] = pose
        t1 = start()
        rendered, = N.VideoToPose().process(pose_video, video_length=F,
                                            device=dev)
        secs, peak = stop(t1)
        os.environ.pop("FLEXAM_DWPOSE_DET")
        os.environ.pop("FLEXAM_DWPOSE_POSE")
        if rendered.shape != (1, 3, F, ph, pw) or not (
                np.isfinite(rendered).all() and rendered.min() >= 0
                and 0 < rendered.max() <= 1):
            raise AssertionError(f"nodes: VideoToPose {rendered.shape}")
        out["pose_dwpose"] = {"seconds": secs, "frames": F, "hw": [ph, pw],
                              "frames_per_second": F / secs,
                              "peak_memory_allocated_gb": peak,
                              "drawn_share": float((rendered > 0).any(1)
                                                   .mean())}
        # the same at YOLOX-L and RTMPose-l width (random weights, two
        # persons a frame): the real path's work
        t1 = time.perf_counter()
        published = write_dwpose(str(root), seed=SEED + 146)
        write_s = time.perf_counter() - t1
        os.environ["FLEXAM_DWPOSE_DET"], os.environ["FLEXAM_DWPOSE_POSE"] = \
            published
        t1 = start()
        rendered, = N.VideoToPose().process(pose_video, video_length=F,
                                            device=dev)
        secs, peak = stop(t1)
        os.environ.pop("FLEXAM_DWPOSE_DET")
        os.environ.pop("FLEXAM_DWPOSE_POSE")
        if rendered.shape != (1, 3, F, ph, pw) or not (
                np.isfinite(rendered).all() and rendered.min() >= 0
                and 0 < rendered.max() <= 1):
            raise AssertionError(f"nodes: VideoToPose (YOLOX-L, RTMPose-l) "
                                 f"{rendered.shape}")
        out["pose_dwpose_published"] = {
            "seconds": secs, "frames": F, "hw": [ph, pw],
            "frames_per_second": F / secs, "peak_memory_allocated_gb": peak,
            "graphs_mb": [os.path.getsize(p) / 1e6 for p in published],
            "write_seconds": write_s,
            "drawn_share": float((rendered > 0).any(1).mean())}
        rs = np.random.RandomState(SEED + 145)
        fixture = root / "keypoints.npz"
        np.savez(fixture, keypoints=rs.uniform(0.05, 0.95, (F, 2, 133, 2)),
                 scores=rs.uniform(0.0, 1.0, (F, 2, 133)))
        t1 = time.perf_counter()
        drawn, = N.VideoToPose().process(pose_video, video_length=F,
                                         fixture=str(fixture), device=dev)
        kp_s = time.perf_counter() - t1
        if drawn.shape != (1, 3, F, ph, pw) or not drawn.any():
            raise AssertionError(f"nodes: VideoToPose keypoints "
                                 f"{drawn.shape}")
        out["pose_keypoints"] = {"host_seconds": kp_s, "persons": 2,
                                 "drawn_share": float((drawn > 0).any(1)
                                                      .mean())}
        print(json.dumps({"nodes_part": "pose", **{
            k: out[k] for k in ("pose_dwpose", "pose_dwpose_published",
                                "pose_keypoints")}}), flush=True)
        del rendered, drawn

        # (c) the loader and the sampler at 5B width
        t1 = start()
        pipe, = N.LoadFlexAMModel().loadmodel(
            "Wan2.2-Fun-5B-FLEXAM", random_init="5b", device=dev)
        secs, peak = stop(t1)
        out["load_model"] = {"seconds": secs,
                             "peak_memory_allocated_gb": peak}
        blocks = pipe.models.dit_params["blocks"]
        gen = torch.Generator().manual_seed(SEED + 143)
        lora = {}
        for i in range(len(blocks)):
            for proj in ("q", "k", "v", "o"):
                o, n = blocks[i]["self_attn"][proj]["weight"].shape
                stem = f"lora_unet_blocks_{i}_self_attn_{proj}"
                lora[f"{stem}.lora_down.weight"] = torch.randn(
                    (NODES_LORA_RANK, n), generator=gen) * 0.01
                lora[f"{stem}.lora_up.weight"] = torch.randn(
                    (o, NODES_LORA_RANK), generator=gen) * 0.01
                lora[f"{stem}.alpha"] = torch.tensor(float(NODES_LORA_RANK))
        lora_path = root / "lora_rank8.safetensors"
        save_safetensors(str(lora_path), lora)
        w0 = blocks[1]["self_attn"]["q"]["weight"].detach().clone()
        stem = "lora_unet_blocks_1_self_attn_q"
        delta = (lora[f"{stem}.lora_up.weight"].numpy()
                 @ lora[f"{stem}.lora_down.weight"].numpy())
        del blocks
        widgets = dict(  # the sampler's widget defaults, steps cut to 2
            video_length=F, base_resolution=NODES_BASE_RESOLUTION, seed=43,
            steps=2, cfg=6.0, denoise_strength=1.0, scheduler="Flow",
            shift=5, boundary=0.9, teacache_threshold=0.10,
            enable_teacache=True, num_skip_start_steps=5,
            teacache_offload=True, cfg_skip_ratio=0.0,
            generate_type="motion_transfer", dilation_pixels=200)
        th, tw = N.FlexAMV2VSampler().snap_resolution(
            Hp, Wp, NODES_BASE_RESOLUTION)
        lat = ((F - 1) // 4 + 1, th // 16, tw // 16)
        tokens = lat[0] * (lat[1] // 2) * (lat[2] // 2) + \
            (lat[1] // 2) * (lat[2] // 2)
        mask = np.zeros((F, 1, Hp, Wp), np.float32)     # the demo layout
        mask[:, :, Hp // 4: 3 * Hp // 4, Wp // 3: 2 * Wp // 3] = 1.0
        runs = [
            ("motion_transfer_lora", dict(
                widgets, original_video=video, control_video=tracking_video,
                depth_video=depth_video, cos_video0=cos[0],
                cos_video1=cos[1], cos_video2=cos[2], cos_video3=cos[3],
                loras=[str(lora_path)], strength_model=[1.0],
                lora_cache=True)),
            ("lora_half_1_step", dict(
                widgets, steps=1, original_video=video,
                control_video=tracking_video, loras=[str(lora_path)],
                strength_model=[0.5], lora_cache=True)),
            ("fg_generation_1_step", dict(
                widgets, steps=1, generate_type="fg_generation",
                original_video=video, control_video=tracking_video,
                mask_video=mask)),
            # B5 takes frame blocks of a multiple of 8 tokens (JAX's
            # dispatch): 480x832 gives 390 a frame, which runs dense in
            # both packages, so the sparse step takes a 512x512 crop
            # (640x640 after the snap: 400 tokens a frame)
            ("sparse_1_step", dict(
                widgets, steps=1, original_video=video[:, :, :Hp],
                control_video=tracking_video[..., :Hp]))]
        total, sampler = {}, {}
        for name, kw in runs:
            if name == "sparse_1_step":
                N.FunAttention().process("sparse", pipe)
            t1 = start()
            with StageTimer(_nodes_targets(), keep_returned=False) as st:
                result, = N.FlexAMV2VSampler().process(
                    pipe, NODES_PROMPT, negative_prompt=NODES_NEGATIVE, **kw)
            wall, peak = stop(t1)
            counts = _counts()
            if name == "sparse_1_step":
                os.environ.pop("FLEXAM_ATTENTION", None)
                _backend_choice.cache_clear()
            hw = (th, tw) if name != "sparse_1_step" else \
                N.FlexAMV2VSampler().snap_resolution(Hp, Hp,
                                                     NODES_BASE_RESOLUTION)
            if result.shape != (1, 3, F, *hw) or \
                    not np.isfinite(result).all():
                raise AssertionError(f"nodes sampler {name}: {result.shape}")
            b4 = counts["ln_mod_binary"] + counts["ln_mod_bcast"]
            sparse = name == "sparse_1_step"
            # B5 takes every video self-attention of the sparse step, so
            # B1 runs there 0 times
            must = ("single_kv_attention", "rmsnorm_rope") + (
                () if sparse else ("flash_attention",))
            if any(counts[k] == 0 for k in must) or b4 == 0 or \
                    counts["int8_attention"] or counts["exact_attention"] \
                    or bool(counts["sparse_attention"]) != sparse:
                raise AssertionError(f"nodes sampler {name}: launches "
                                     f"{counts}")
            w = pipe.models.dit_params["blocks"][1]["self_attn"]["q"][
                "weight"]
            if name == "motion_transfer_lora" and torch.equal(w, w0):
                raise AssertionError("nodes: the LoRA merge left the "
                                     "weights as they were")
            if name == "lora_half_1_step":
                # restored from the host cache, then merged at 0.5
                want = (w0.float() + torch.from_numpy(0.5 * delta).to(dev)
                        ).to(w0.dtype)
                if not torch.equal(w, want):
                    raise AssertionError("nodes: the weights were not "
                                         "restored before the 0.5 merge")
            _add(total, counts)
            sampler[name] = {
                "wall_seconds": wall, "stages": dict(st.seconds),
                "peak_memory_allocated_gb": peak, "launches": counts,
                "b4_mode": ("broadcast" if not counts["ln_mod_binary"] else
                            "binary" if not counts["ln_mod_bcast"] else
                            "both")}
            print(json.dumps({"nodes_sampler": name, **sampler[name]}),
                  flush=True)
            del result
        out["sampler"] = {"hw": [th, tw], "frames": F, "tokens": tokens,
                          "runs": sampler}
        N.FlexAMV2VSampler._lora_cache.clear()
        N.FlexAMV2VSampler._lora_before.clear()
        del pipe, tracking_video, depth_video, cos
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the card against the CPU
        out["card_vs_cpu"] = nodes_card_vs_cpu(dev)
        out["card_vs_cpu"].update(pose_flow_card_vs_cpu(
            dev, clip_u8[:, :ph, :pw], det, pose, published))
        print(json.dumps({"nodes_part": "card_vs_cpu",
                          **out["card_vs_cpu"]}), flush=True)
    finally:
        depth_registry.DEPTH_BACKENDS.update(originals)
        _backend_choice.cache_clear()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    for k in results:
        results[k]["nodes_launches"] = total.get(k, 0)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("nodes", t0, **out, launches_all_runs=total)


# ---------------------------------------------------------------------------
# The FLUX.1-Depth repaint and DepthCrafter
# ---------------------------------------------------------------------------

def _depth_map(h: int, w: int):
    """A smooth depth map with structure at several scales."""
    import numpy as np
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    return (1.0 + 0.5 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
            + yy / h + 0.1 * np.sin(xx / 5.0))


def _textured_clip(frames: int, h: int, w: int, seed: int):
    """uint8 [T, H, W, 3]: a textured plane sliding 2 px a frame with a
    square moving the other way (motion and edges for the models)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    base = rs.rand(h + 4 * frames, w + 4 * frames, 3).astype(np.float32)
    k = np.ones(9, np.float32) / 9
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        f = base[2 * t:2 * t + h, 2 * t:2 * t + w]
        f = (f - f.min()) / (f.max() - f.min())
        y, x = h // 3, (w // 2 + 3 * t) % (w - 64)
        f[y:y + 64, x:x + 64] = 1.0 - f[y:y + 64, x:x + 64]
        out[t] = (f * 255).astype(np.uint8)
    return out


def _counts_delta(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def flux_card_vs_cpu(dev) -> dict:
    """(c) the tiny repainter in fp32 (TF32 off) on the card and on the CPU
    from the same trees and latents: the transformer's velocity within
    FLUX_CARD_CPU_REL of its largest value, and the uint8 image within one
    level (module docstring)."""
    import numpy as np
    import torch
    from flexam_tpu_torch import repaint_flux as rf
    from flexam_tpu_torch.models.flux import flux_forward, make_img_ids
    cpu = rf.make_tiny_repainter(seed=SEED, device="cpu")
    card = rf.FluxDepthRepainter(_to(cpu.params, dev), _to(cpu.vae_params,
                                                            dev),
                                 cfg=cpu.cfg, vae_cfg=cpu.vae_cfg,
                                 dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(SEED + 40)
    h, w = 32, 48
    lat = torch.randn((1, 4, h // 2, w // 2), generator=g).numpy()
    img = torch.randn((2, 96, 32), generator=g)
    txt = torch.randn((2, 7, 32), generator=g)
    ids = torch.from_numpy(make_img_ids(16, 24))
    y = torch.randn((2, 24), generator=g)
    t = torch.tensor([0.9, 0.3])
    gd = torch.tensor([7.5, 3.0])
    tid = torch.zeros((7, 3), dtype=torch.int32)
    with torch.no_grad():
        ref = flux_forward(cpu.params, cpu.cfg, img, ids, txt, tid, t, y, gd)
        got = flux_forward(card.params, card.cfg, img.to(dev), ids.to(dev),
                           txt.to(dev), tid.to(dev), t.to(dev), y.to(dev),
                           gd.to(dev))
    out = {"forward": compare(got.cpu(), ref, FLUX_CARD_CPU_REL,
                              "tiny FLUX forward card vs CPU")}
    a = cpu("a red house", _depth_map(40, 56), h, w, 4, latents=lat)
    b = card("a red house", _depth_map(40, 56), h, w, 4, latents=lat)
    diff = np.abs(a.astype(int) - b.astype(int))
    if diff.max() > 1:
        raise AssertionError(f"tiny repaint card vs CPU: {diff.max()} levels")
    out["repaint_levels_max"] = int(diff.max())
    out["repaint_pixels_differing"] = int((diff > 0).sum())
    return out


def flux_full_repainter(dev):
    """FLUX.1-Depth-dev, its VAE, T5 v1.1 XXL and CLIP-L at their published
    widths, random bf16 weights drawn on the card (no file)."""
    import torch
    from flexam_tpu_torch import repaint_flux as rf
    from flexam_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                   init_clip_text_params)
    from flexam_tpu_torch.models.flux import FluxConfig, init_flux_params
    from flexam_tpu_torch.models.flux_vae import (FluxVAEConfig,
                                                  init_flux_vae_params)
    from flexam_tpu_torch.models.t5 import init_t5_params
    bf = torch.bfloat16
    return rf.FluxDepthRepainter(
        init_flux_params(FluxConfig(), seed=SEED, dtype=bf, device=dev),
        init_flux_vae_params(FluxVAEConfig(), seed=SEED + 1, dtype=bf,
                             device=dev),
        init_t5_params(rf.FLUX_T5_CONFIG, seed=SEED + 2, dtype=bf,
                       device=dev),
        init_clip_text_params(CLIPTextConfig(), seed=SEED + 3, dtype=bf,
                              device=dev), dtype=bf, device=dev)


def phase_repaint_flux(dev, results: dict) -> None:
    """FLUX.1-Depth (module docstring): (a) the full-width repaint with
    random weights, (b) the demo's `--repaint true` from files at full
    size, then verify_ckpt on them, (c) the tiny repainter card vs CPU."""
    import gc
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch import demo
    from flexam_tpu_torch import repaint_flux as rf
    from flexam_tpu_torch.testing import write_flux_files
    from flexam_tpu_torch.tools import verify_ckpt

    t0 = time.perf_counter()
    H, W = FLUX_HW
    out = {}
    # (a) the full-width repaint: FLUX.1-Depth-dev, T5 v1.1 XXL, CLIP-L and
    # the VAE drawn on the card in bf16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    rp = flux_full_repainter(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    n_params = {name: sum(t.numel() for t in _tree_leaves_t(tree))
                for name, tree in (("flux", rp.params), ("t5", rp.t5_params),
                                   ("clip", rp.clip_params),
                                   ("vae", rp.vae_params))}
    resident = torch.cuda.memory_allocated() / 1e9
    depth = _depth_map(H, W)
    _reset_counts()
    stages = [(rf.FluxDepthRepainter, "encode_text"),
              (rf.FluxDepthRepainter, "control_tokens"),
              (rf, "flux_forward"), (rf, "flux_vae_decode")]
    with StageTimer(stages, keep_returned=False) as st:
        t1 = time.perf_counter()
        img = rp("a lighthouse on a cliff at dusk", depth, H, W,
                 num_inference_steps=FLUX_STEPS, seed=SEED)
        wall = time.perf_counter() - t1
    counts = _counts()
    if img.shape != (H, W, 3) or img.dtype != np.uint8:
        raise AssertionError(f"repaint_flux (a): image {img.shape}")
    blocks = rp.cfg.depth_double + rp.cfg.depth_single       # 19 + 38
    others = {k: n for k, n in counts.items() if k != "flash_attention"}
    if counts["flash_attention"] != blocks * FLUX_STEPS or any(
            others.values()):
        raise AssertionError(f"repaint_flux (a): launches {counts}, want "
                             f"flash_attention = {blocks} x {FLUX_STEPS} "
                             "only")
    out["full_width"] = {
        "image": [H, W], "tokens": FLUX_TOKENS, "steps": FLUX_STEPS,
        "params": n_params, "init_seconds": init_s,
        "resident_gb": resident, "wall_seconds": wall,
        "text_seconds": st.seconds["encode_text"],
        "vae_encode_seconds": st.seconds["control_tokens"],
        "step_seconds": st.each["flux_forward"],
        "vae_decode_seconds": st.seconds["flux_vae_decode"],
        "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "exact_calls": counts["exact_attention"],
        "image_mean": float(img.mean()), "image_std": float(img.std())}
    results["flash_attention"]["repaint_launches"] = counts[
        "flash_attention"]

    # (b) the demo from files at full size (BFL / ae names)
    root = HERE / "build" / "smoke_flux"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free_gb = shutil.disk_usage(root).free / 1e9
    print(json.dumps({"repaint_flux_part": "disk", "free_gb": free_gb}),
          flush=True)
    rp.t5_params = rp.clip_params = None          # the demo's files: 2
    t1 = time.perf_counter()
    paths = write_flux_files(str(root), rp)
    write_s = time.perf_counter() - t1
    sizes = {k: os.path.getsize(v) / 1e9 for k, v in paths.items()}
    del rp
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["FLEXAM_FLUX_CKPT"] = paths["ckpt"]
    os.environ["FLEXAM_FLUX_AE"] = paths["ae"]
    vid = _textured_clip(17, H, W, SEED + 41)
    np.savez(root / "input.npz", video=vid, fps=16)
    argv = ["--prompt", DEMO_PROMPT, "--random_init", "5b", "--sample_size",
            str(H), str(W), "--seed", str(SEED), "--generate_type",
            "full_edit", "--synthetic_tracks", "--repaint", "true",
            "--video_length", "17", "--num_inference_steps",
            str(FLUX_DEMO_STEPS), "--input_path", str(root / "input.npz"),
            "--output_dir", str(root / "out")]
    seen = {}
    orig_call = rf.FluxDepthRepainter.__call__

    def counted(self, *a, **kw):
        before = _counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig_call(self, *a, **kw)
        torch.cuda.synchronize()
        seen["repaint_seconds"] = time.perf_counter() - t
        seen["launches"] = _counts_delta(before)
        seen["blocks"] = self.cfg.depth_double + self.cfg.depth_single
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rf.FluxDepthRepainter.__call__ = counted
    try:
        with StageTimer([(rf, "load_flux_repainter")],
                        keep_returned=False) as st:
            t1 = time.perf_counter()
            video = demo.main(argv)
            torch.cuda.synchronize()
            demo_wall = time.perf_counter() - t1
    finally:
        rf.FluxDepthRepainter.__call__ = orig_call
        del os.environ["FLEXAM_FLUX_CKPT"], os.environ["FLEXAM_FLUX_AE"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    rl = seen["launches"]
    if rl["flash_attention"] != seen["blocks"] * FLUX_DEMO_STEPS or \
            rl["exact_attention"]:
        raise AssertionError(f"repaint_flux (b): the repaint's launches {rl}")
    frame = np.load(root / "out" / "temp_repainted.npy")
    if video.shape != (1, 3, 17, H, W) or frame.shape != (H, W, 3) or \
            not np.isfinite(video).all():
        raise AssertionError(f"repaint_flux (b): {video.shape}, "
                             f"{frame.shape}")
    gc.collect()
    torch.cuda.empty_cache()
    ver = {}
    for kind, key in (("flux", "ckpt"), ("flux-ae", "ae")):
        t1 = time.perf_counter()
        rc = verify_ckpt.main(["--model", kind, paths[key]])
        ver[kind] = {"rc": rc, "seconds": time.perf_counter() - t1}
        if rc != 0:
            raise AssertionError(f"verify_ckpt --model {kind}: rc {rc}")
        gc.collect()
        torch.cuda.empty_cache()
    out["demo"] = {
        "free_disk_gb": free_gb, "file_gb": sizes,
        "write_seconds": write_s,
        "write_gbps": sum(sizes.values()) / write_s,
        "load_seconds": st.seconds["load_flux_repainter"],
        "read_gbps": sum(sizes.values()) / st.seconds["load_flux_repainter"],
        "repaint_steps": FLUX_DEMO_STEPS,
        "repaint_seconds": seen["repaint_seconds"],
        "repaint_launches": rl, "demo_wall_seconds": demo_wall,
        "peak_memory_allocated_gb": peak, "verify_ckpt": ver,
        "launches_all": _counts()}
    results["flash_attention"]["repaint_launches"] += rl["flash_attention"]
    shutil.rmtree(root, ignore_errors=True)
    del video
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the tiny repainter, card vs CPU
    out["card_vs_cpu"] = flux_card_vs_cpu(dev)
    for k in results:
        results[k].setdefault("repaint_launches", 0)
    emit("repaint_flux", t0, **out)


def _tree_leaves_t(tree):
    from flexam_tpu_torch.io.convert import tree_leaves
    return tree_leaves(tree)


def depthcrafter_card_vs_cpu(dev) -> dict:
    """(c) the tiny denoiser in fp32 (TF32 off) on the card and on the CPU
    from the same trees, latents and pixel noise: within DC_CARD_CPU_ABS
    of the [0, 1] output (module docstring)."""
    import numpy as np
    import torch
    from flexam_tpu_torch.perception import depthcrafter_model as tm
    cpu = tm.make_tiny_denoiser(seed=SEED, device="cpu")
    card = tm.DepthCrafterDenoiser(_to(cpu.params, dev),
                                   _to(cpu.vae_params, dev), cfg=cpu.cfg,
                                   vae_cfg=cpu.vae_cfg, dtype=torch.float32,
                                   device=dev)
    g = torch.Generator().manual_seed(SEED + 50)
    f = torch.rand((4, 32, 48, 3), generator=g).numpy()
    lat = torch.randn((1, 4, 4, 16, 24), generator=g)
    aug = torch.randn((4, 3, 32, 48), generator=g)
    a = cpu(f, num_inference_steps=2, latents=lat, aug_noise=aug)
    b = card(f, num_inference_steps=2, latents=lat, aug_noise=aug)
    err = float(np.abs(a - b).max())
    if not err <= DC_CARD_CPU_ABS:
        raise AssertionError(f"tiny denoiser card vs CPU: {err}")
    return {"max_abs_err": err, "bound": DC_CARD_CPU_ABS}


def phase_depthcrafter(dev, results: dict) -> None:
    """DepthCrafter (module docstring): (a) `estimate_depth` through the
    registry at published widths on a 512x896x32f clip, fp32, 2 steps; (b)
    the exact branch chunked against one whole chunk on the card; (c)
    verify_ckpt's svd kinds, the onnx hook and the tiny denoiser."""
    import gc
    import shutil

    import numpy as np
    import torch
    from flexam_tpu_torch.core import attention as core_att
    from flexam_tpu_torch.models import svd_vae as ts
    from flexam_tpu_torch.models.clip import CLIPVisionConfig, init_vit_params
    from flexam_tpu_torch.models.flux_vae import init_flux_vae_params
    from flexam_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                  init_svd_unet_params)
    from flexam_tpu_torch.perception import depthcrafter_model as tm
    from flexam_tpu_torch.perception.depth import estimate_depth
    from flexam_tpu_torch.testing import (tiny_depth_onnx,
                                          write_depthcrafter_files)
    from flexam_tpu_torch.tools import verify_ckpt
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

    t0 = time.perf_counter()
    T, H, W = DC_VIDEO
    root = HERE / "build" / "smoke_depthcrafter"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}
    # (a) files at the published widths (random weights, bf16 storage)
    t1 = time.perf_counter()
    bf = torch.bfloat16
    unet = init_svd_unet_params(SVDUNetConfig(), seed=SEED, dtype=bf,
                                device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    vae = {"encoder": init_flux_vae_params(tm.SD_VAE_CONFIG, seed=SEED + 52,
                                           dtype=bf, device=dev)["encoder"],
           "quant_conv": {"w": (torch.randn((8, 8, 1, 1), generator=g,
                                            device=dev) / 8 ** 0.5).to(bf),
                          "b": torch.zeros(8, dtype=bf, device=dev)},
           "decoder": ts.init_temporal_decoder_params(
               tm.temporal_decoder_config(tm.SD_VAE_CONFIG), seed=SEED + 53,
               dtype=bf, device=dev)}
    clip = init_vit_params(CLIPVisionConfig(), seed=SEED + 54, dtype=bf,
                           device=dev,
                           proj_dim=SVDUNetConfig().cross_attention_dim)
    paths = write_depthcrafter_files(str(root), unet, vae, clip)
    write_s = time.perf_counter() - t1
    sizes = {k: os.path.getsize(v) / 1e9 for k, v in paths.items()}
    n_params = {name: sum(t.numel() for t in _tree_leaves_t(tree))
                for name, tree in (("unet", unet), ("vae", vae),
                                   ("clip", clip))}
    del unet, vae, clip
    gc.collect()
    torch.cuda.empty_cache()
    clip_u8 = _textured_clip(T, H, W, SEED + 55)
    video = clip_u8.astype(np.float32) / 255.0
    env = {"FLEXAM_DEPTH_BACKEND": "depthcrafter",
           "FLEXAM_DEPTHCRAFTER_CKPT": paths["unet"],
           "FLEXAM_SVD_VAE": paths["vae"], "FLEXAM_SVD_CLIP": paths["clip"]}
    os.environ.update(env)
    shapes = []
    orig_exact = core_att.exact_attention

    def exact(q, k, v, *a, **kw):
        shapes.append((q.shape[0], q.shape[2], q.shape[1], k.shape[1]))
        return orig_exact(q, k, v, *a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    targets = [(tm, "load_depthcrafter_denoiser"),
               (tm.DepthCrafterDenoiser, "_encode_frames"),
               (tm.DepthCrafterDenoiser, "_embed_frames"),
               (tm, "svd_unet_forward"), (ts, "temporal_decode")]
    core_att.exact_attention = exact
    try:
        with StageTimer(targets, keep_returned=False) as st:
            t1 = time.perf_counter()
            depth = estimate_depth(video, device=dev, dtype=torch.float32,
                                   num_inference_steps=DC_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    finally:
        core_att.exact_attention = orig_exact
        for k in env:
            del os.environ[k]
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if depth.shape != (T, H, W) or not np.isfinite(depth).all() or \
            depth.min() < 0 or depth.max() > 1:
        raise AssertionError(f"depthcrafter (a): depth {depth.shape}")
    kernels = {k: n for k, n in counts.items() if k != "exact_attention"}
    if any(kernels.values()) or not counts["exact_attention"] or peak > 80:
        raise AssertionError(f"depthcrafter (a): launches {counts}, peak "
                             f"{peak} GB")
    if st.calls.get("svd_unet_forward") != 2 * DC_STEPS:
        raise AssertionError(f"depthcrafter (a): UNet passes {st.calls}")
    big = max(shapes, key=lambda s: s[0] * s[1] * s[2] * s[3])
    b_, h_, lq_, lk_ = big
    row = 4 * h_ * lk_
    nb = b_ if fa.LOGITS_BUDGET >= b_ * row else fa.LOGITS_BUDGET // row
    rows = max(1, min(2048, lq_, fa.LOGITS_BUDGET // (nb * row)))
    out["full_width"] = {
        "video": list(DC_VIDEO), "steps": DC_STEPS, "dtype": "float32",
        "params": n_params, "file_gb": sizes, "write_seconds": write_s,
        "wall_seconds": wall, "load_seconds":
        st.seconds["load_depthcrafter_denoiser"],
        "encode_seconds": st.seconds["_encode_frames"],
        "clip_embed_seconds": st.seconds["_embed_frames"],
        "unet_pass_seconds": st.seconds["svd_unet_forward"]
        / st.calls["svd_unet_forward"],
        "decode_seconds": st.seconds["temporal_decode"],
        "peak_memory_allocated_gb": peak, "launches": counts,
        "exact_calls": counts["exact_attention"],
        "largest_exact_call": {"batch": b_, "heads": h_, "q": lq_, "k": lk_,
                               "unchunked_logits_gb": b_ * h_ * lq_ * lk_
                               * 4 / 1e9,
                               "row_chunk_2048_logits_gb": b_ * h_
                               * min(2048, lq_) * lk_ * 4 / 1e9,
                               "chunk": {"batch": nb, "rows": rows,
                                         "logits_gb": nb * h_ * rows * lk_
                                         * 4 / 1e9}},
        "depth_std": float(depth.std())}
    for k in results:
        results[k]["depthcrafter_launches"] = counts.get(k, 0)
    del depth
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the exact branch on the card: chunked by bytes against one chunk
    gq = torch.Generator(device=dev).manual_seed(SEED + 56)
    q, k, v = (torch.randn((8, 2048, 5, 64), generator=gq, device=dev)
               for _ in range(3))
    whole = fa.attention_plain(q, k, v, budget=1 << 40)
    row = 4 * 5 * 2048                  # the fp32 logits of one row
    small = 12 * 8 * row                # 12 rows of all 8 elements
    chunked = fa.attention_plain(q, k, v, budget=small)
    out["exact_chunked"] = dict(
        compare(chunked, whole, EXACT_CHUNK_REL, "exact branch chunked"),
        batch_split=compare(fa.attention_plain(q, k, v, budget=3 * row),
                            whole, EXACT_CHUNK_REL,
                            "exact branch, 3 elements a chunk"),
        shape="q/k/v [8, 2048, 5, 64] fp32", budget_bytes=small,
        whole_ms=device_ms(lambda: fa.attention_plain(q, k, v,
                                                      budget=1 << 40),
                           launches=1, reps=3, warmup=1),
        chunked_ms=device_ms(lambda: fa.attention_plain(q, k, v,
                                                        budget=small),
                             launches=1, reps=3, warmup=1))
    del q, k, v, whole, chunked

    # (c) verify_ckpt's svd kinds, the onnx hook, the tiny denoiser
    ver = {}
    for kind, key in (("svd-unet", "unet"), ("svd-vae", "vae"),
                      ("svd-clip", "clip")):
        t1 = time.perf_counter()
        rc = verify_ckpt.main(["--model", kind, paths[key]])
        ver[kind] = {"rc": rc, "seconds": time.perf_counter() - t1}
        if rc != 0:
            raise AssertionError(f"verify_ckpt --model {kind}: rc {rc}")
    out["verify_ckpt"] = ver
    onnx_path = root / "depth.onnx"
    onnx_path.write_bytes(tiny_depth_onnx(seed=SEED, size=64))
    os.environ["FLEXAM_DEPTH_ONNX"] = str(onnx_path)
    try:
        small_clip = video[:4, :120, :200]
        d_card = estimate_depth(small_clip, backend="onnx", size=64,
                                device=dev)
        d_cpu = estimate_depth(small_clip, backend="onnx", size=64,
                               device="cpu")
    finally:
        del os.environ["FLEXAM_DEPTH_ONNX"]
    out["onnx"] = compare(torch.from_numpy(d_card), torch.from_numpy(d_cpu),
                          NODES_GRAPH_REL, "onnx depth hook card vs CPU")
    out["tiny_card_vs_cpu"] = depthcrafter_card_vs_cpu(dev)
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit("depthcrafter", t0, **out)


KERNELS = {
    "flash_attention": ("flexam_tpu_torch/csrc/flash_attention.cu",
                        "flexam_tpu/ops/flash_attention.py:34"),
    "single_kv_attention": ("flexam_tpu_torch/csrc/flash_attention.cu",
                            "flexam_tpu/ops/flash_attention.py:101"),
    "rmsnorm_rope": ("flexam_tpu_torch/csrc/rmsnorm_rope.cu",
                     "flexam_tpu/ops/fused.py:167"),
    "ln_mod_binary": ("flexam_tpu_torch/csrc/ln_modulation.cu",
                      "flexam_tpu/ops/fused.py:377"),
    "ln_mod_bcast": ("flexam_tpu_torch/csrc/ln_modulation.cu",
                     "flexam_tpu/ops/fused.py:403"),
    "sparse_attention": ("flexam_tpu_torch/csrc/sparse_attention.cu",
                         "flexam_tpu/ops/sparse_attention.py:163"),
    "int8_attention": ("flexam_tpu_torch/csrc/int8_attention.cu",
                       "flexam_tpu/ops/int8_attention.py:42"),
}
# the kernels each path must launch (the long path's B5 runs in its sparse
# step, checked there)
MAIN_PATH_KERNELS = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
                     "ln_mod_binary", "ln_mod_bcast")
LONG_PATH_KERNELS = ("int8_attention", "single_kv_attention", "rmsnorm_rope",
                     "ln_mod_binary")


def main() -> int:
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import flexam_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the flexam_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    if Path(flexam_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: flexam_tpu_torch was imported from "
              f"{flexam_tpu_torch.__file__}, not from beside this script",
              file=sys.stderr)
        return 3
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.ops import build
    from flexam_tpu_torch.tools.attention_ab import (ptxas_resources,
                                                     wgmma_notes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    results = {}

    t0 = time.perf_counter()
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         nvidia_smi=card, tf32_matmul=False, tf32_cudnn=False)

    t0 = time.perf_counter()
    build.library()
    log = Path(build.build_info.get("log", "")) if build.build_info.get(
        "log") else None
    text = log.read_text() if log else ""
    lib = build.library()
    emit("build", t0, nvcc_seconds=build.build_info["seconds"],
         nvcc_compile_seconds=build.build_info.get("compile_seconds"),
         cached=build.build_info["cached"], ptxas=ptxas_resources(text),
         wgmma_notes=wgmma_notes(text),
         attention_smem_bytes=lib.flexam_attention_smem_bytes(),
         int8_attention_smem_bytes=lib.flexam_int8_attention_smem_bytes(),
         attention_sass=hopper_sass(Path(build.build_info["path"])))

    phase_kernels(dev, results)
    torch.cuda.empty_cache()
    phase_reference_check(dev)
    dit_params = phase_dit_flagship(dev, WAN22_5B_FLEXAM)
    torch.cuda.empty_cache()
    pipe, context = phase_generate(dev, WAN22_5B_FLEXAM, dit_params, results)
    del dit_params
    torch.cuda.empty_cache()
    phase_generate_from_tracks(dev, pipe, context)
    torch.cuda.empty_cache()
    phase_generate_long(dev, pipe, context, results)
    del pipe, context
    gc.collect()
    torch.cuda.empty_cache()
    phase_checkpoint_load(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_demo(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serving(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    serve_pipe = phase_serve(dev, results)
    phase_serve_cli(dev)
    phase_serve_camera(dev, serve_pipe)
    track, track_total = {}, {}
    track_serve_job(dev, serve_pipe, track, track_total)
    del serve_pipe
    gc.collect()
    torch.cuda.empty_cache()
    phase_track(dev, results, track, track_total)
    gc.collect()
    torch.cuda.empty_cache()
    phase_geometry(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    phase_nodes(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    phase_repaint_flux(dev, results)
    gc.collect()
    torch.cuda.empty_cache()
    phase_depthcrafter(dev, results)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "demo_launches": r["demo_launches"],
            "serving_launches": r["serving_launches"],
            "serve_launches": r["serve_launches"],
            "track_launches": r["track_launches"],
            "geometry_launches": r["geometry_launches"],
            "nodes_launches": r["nodes_launches"],
            "repaint_launches": r["repaint_launches"],
            "depthcrafter_launches": r["depthcrafter_launches"],
            **({k: r[k] for k in ("tflops", "gbps", "bound_share", "copy_ms",
                                  "flux_shapes") if k in r})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
