#!/usr/bin/env python3
"""Quickest proof that the hvt_torch port runs on one NVIDIA GPU.

    python3 chip_smoke.py              # needs one CUDA card; builds the kernels itself
    python3 chip_smoke.py --profile    # also: per-kernel device time of one forward and
                                       # of one training step per route and per
                                       # ResNet-50 BatchNorm

Phases, in order; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi); the host the loader runs
     on: CPU count and affinity, g++, jpeglib.h and -ljpeg (a probe
     program compiled and linked), sklearn;
  2. build every kernel from hvt_torch/ops/csrc (one nvcc per source, in parallel),
     and print each kernel's registers, static shared memory and spills
     (ptxas) and the dynamic shared memory of the window-attention
     tensor-core kernels (backward, forward);
  3. each kernel against its plain PyTorch version on the card, in bf16, at
     every SwinV2-T block shape at batch 64 (each stage unshifted and, where
     the map holds more than one window, shifted); the window-attention
     forwards (packed and split) also in f32, and at N = 144 (window 12,
     the shape their CUDA-core kernel takes) in both dtypes;
  4. the main path, once per route (model.args.fuse false, then true): an
     InferenceEngine serving SwinV2-T at 224 px (10,000 classes, batch 64,
     seeded random weights) answers HTTP requests on 127.0.0.1; each kernel
     of the route must launch 12 times per forward, and the logits on the
     kernel path must match the same model's plain path on the card;
  5. times: each kernel, its plain version and a library call where one
     computes the same function, at batch 64 (the window-attention forwards
     beside SDPA in each dtype); the fused forwards (MLP half, both
     attention halves; the chunked MLP's in phase 6) beside the composite
     yardstick, the unfused route's ops computing the same half without
     grad; the two attention-half forwards and the MLP half's also with
     their host and device ms (``host_device_ms``), the device ms of each
     of their three kernels (attention output, proj, LayerNorm and residual;
     fc1, fc2, LayerNorm and residual, with fc1's and fc2's TFLOP/s; a trace
     in chiprun_out/<name>_trace.json), the design's byte floor, and the
     kernels' registers, shared memory and spills; images/s per route;
  6. the backward kernels against their plain versions at every SwinV2-T
     block shape at batch 128: the packed attention's (dqkv, dz → dbias,
     dlogit_scale) and the fused halves' (every gradient of each half, with
     one image's drop-path scale 0 and one's 1/keep); one head's logit scale
     sits above the log 100 clamp, and its gradient must be exactly 0; the
     packed and split attention backwards also in f32 (check only, every
     gradient within 1e-4·max|plain|). Then each is timed through the
     model's backward beside its bound and its plain version (and SDPA's
     backward for the packed kernel); the fused halves' three backward
     rows (the MLP half, the NHWC and the windowed attention half) and the
     chunked MLP's backward also with their host and device time
     (``host_device_ms``), each of their kernels' device ms a step
     (attention half: attention output, proj, core, dx, dWqkv, dWproj;
     MLP: fc1, fc2, LayerNorm backward, hidden, dx, dW1, dW2; both: the
     fixed-order sums), the registers, shared memory and spills of their
     kernels, and the composite yardstick: the unfused route's ops
     computing the same function (F.linear, the packed window attention or
     F.gelu, F.layer_norm, roll, partition, residual) timed through autograd;
     the chunked MLP's forward also with its host and device ms and its
     three kernels' (fc1, fc2, the LayerNorm pass storing the pre-LN sum);
  7. the training path, once per route (model.args.fuse false, then true):
     ``hvt_torch.main.main`` trains SwinV2-T (10,000 classes, batch 128,
     configs/pretrain/swinv2_tiny.yaml's recipe) for 20 steps on the
     synthetic source: finite losses, 12 launches per step of each kernel
     of the route (0 of the other route's), step ms, images/s and peak
     memory; then one step's loss and gradients, from the same weights and
     batch, on the kernel path against the plain path;
  8. the BatchNorm reduction kernels against f64 sums of the same bf16 inputs
     and against their plain versions, at each of the 12 BatchNorm shapes of
     ResNet-50 at batch 256 and 224 px, and ``bn_train``'s forward and
     backward through them against the plain path; then each timed beside
     its bound, its plain version and a library call (torch's
     batch_norm_stats / batch_norm_backward_reduce), summed to a training
     step with the 53 launches' shapes;
  9. the ResNet-50 training path: ``hvt_torch.main.main`` trains ResNet-50
     (configs/pretrain/inat21.yaml less ProgressiveResizing, bench.py's R50
     settings: batch 256, stem_s2d, DecoupledSGDW at lr 2.048, EMA
     100ba/20ba, smoothing 0.08, clip 2.0; 10,000 classes, synthetic source)
     for 21 steps with bn_pallas: true: finite losses, 53 launches per step
     of each BatchNorm kernel and none of the SwinV2 kernels, EMA updated at
     steps 0 and 20, one step's loss and gradients against the plain path;
     then the same run with bn_pallas: false (torch's BatchNorm, no kernel);
 10. the SwinV2-B training path on fuse: true: ``hvt_torch.main.main`` trains
     SwinV2-B (swinv2_tiny.yaml's recipe with model.name swinv2_base,
     grad_accum auto, which must resolve to 1 on the card; 10,000 classes,
     batch 128) for 20 steps: finite losses; per step 24 launches of each
     attention-half kernel, 22 of each MLP-half kernel (stages 1-3) and 2 of
     each chunked-MLP kernel (stage 4, K = 2, one launch per block for all
     chunks), none of the others; step ms, images/s and peak memory; one
     step's loss and gradients against the plain path;
 11. the fused block's other routes, training SwinV2-T (10,000 classes,
     batch 128) through ``hvt_torch.main.main``: (a) fuse_nhwc: false for 20
     steps, 12 launches per step of the windowed attention half's two
     kernels and of the MLP half's two, none of the NHWC or packed pairs,
     step ms, images/s and peak memory, one step against the plain path;
     (b) fuse_resid: false for 7 steps, 12 per step of the NHWC and MLP
     pairs (every residual outside the kernels), one step against the plain
     path; (c) fuse_attn_train: false with fallback_xla: false for 7 steps,
     12 per step of the packed attention pair and the MLP pair; (d) hvt's
     op on split q, k, v, ``hvt_torch.ops.window_attention.window_attention``,
     forward and backward at each of SwinV2-T's 12 block shapes at batch 128:
     12 launches of each split kernel;
 12. the retired fused halves (``hvt_torch.ops.swin_block_cuda``, hvt's
     ``swin_block_pallas``, which no model routes to) as their caller
     composes them: at each of SwinV2-T's 12 block shapes at batch 64, the
     map rolled by -shift, the attention branch rolled back and added, then
     the MLP branch added, in f32 and in bf16: 12 launches of each per
     dtype and none of any other kernel; the stream after each block shape's
     blocks is held against the same chain on the plain versions; a profile
     of the chains names only the branches' tensor-core kernels, the f32
     operands' pieces and the LayerNorm pass;
 13. evaluation at iNat21's eval batch: ``hvt_torch.main.main`` evaluates
     SwinV2-T on fuse: true and on fuse: false, ResNet-50 (phase 9's
     config, EMA) and SwinV2-B on fuse: true (224 px, 10,000 classes,
     synthetic eval source of 2,052 images: a batch of 2,048 and a
     padded tail of 4), each once with ``is_train: false`` (with tree-dist),
     SwinV2-T fuse: true and ResNet-50 also for 4 training steps evaluated
     at steps 0, 2 and 4: every evaluation counts exactly 2,052 images with
     finite metrics; each forward kernel of the route launches 12 (SwinV2-T)
     or 24 (SwinV2-B) times a batch and no backward kernel launches; the
     first batch's logits within 5e-2·max|logit| of the plain path and the
     metrics over the set within 1e-2 relative (cross-entropy) and 0.5%
     (acc@1, acc@5; tree-dist 0.5% of its range) of it; the EMA run's
     metrics move when its averaged weights are replaced by the live ones;
     eval images/s (a warm evaluation on the host clock), eval ms a batch
     (CUDA events) and peak memory per model;
 14. checkpoints on the card, through ``hvt_torch.main.main``: (a) SwinV2-T
     on fuse: true (phase 7's recipe, drop path 0.2, batch 128) trains 6
     steps straight, twice, then once more saving at steps 3 and 6, and a
     new Trainer with ``load_path: ckpt://...:3`` trains steps 4-6: the
     restored state equals the step-3 state bit for bit (parameters, Adam's
     mu and nu, the count, the generator), and the resumed losses and final
     state lie within 4 times the straight runs' own difference (exactly
     equal where those are); 12 launches a step of each fused kernel;
     (b) the same for ResNet-50 with EMA and bn_pallas (phase 9's config, 4
     steps, saved at and resumed from step 2; the EMA copies and running
     statistics included; 53 launches a step of each BatchNorm kernel);
     (c) SIGTERM to this process after step 2 of a 6-step SwinV2-T run with
     ``auto_resume``: ``fit`` returns, checkpoint 2 exists, the previous
     handler is back, and the same config again resumes at 2 and ends at 6;
     (d) ``hvt_torch.tools.export_torch`` writes (a)'s step-6 checkpoint as
     a swin:// file that a SwinV2-T with 1,000 classes loads through a
     strict PretrainedBackbone (backbone equal to the checkpoint's, head at
     its init) and evaluates through the fused kernels; ``InferenceEngine``
     with ``load_path`` at (b)'s checkpoint gives logits within
     5e-2·max|logit| of the Trainer's eval forward on the EMA weights, and
     with ``use_ema=False`` on the live weights; (e) the cost of a
     checkpoint of SwinV2-T, ResNet-50 with EMA and SwinV2-B (phase 10's
     model after one step): bytes on disk, ``save``'s blocking ms (host
     clock and CUDA events), the background write's seconds and
     ``restore``'s;
 15. training from JPEG folders: (a) hvt's loader fixture at iNat21's width
     (10,000 class directories, 2,560 train and 256 val JPEGs of seeded
     noise at 500x375, written by Pillow on every core); (b) the loader
     alone (``hvt_torch.tools.loader_bench``): img/s on the native and the
     Pillow route at 1, 4, 8 and every thread, train (bare, and with host
     RandAugment + ColOut) and eval; (c) ``hvt_torch.main.main`` trains
     ResNet-50 from configs/pretrain/inat21.yaml as written but for batch
     256, bn_pallas and 10 steps (one epoch, every progressive bucket,
     112 → 224 px): 53 launches a step of each BatchNorm kernel, the loop's
     ms a step per bucket beside the step alone on a resident batch (busy
     share); the BatchNorm pair against f64 sums and its plain version and
     timed at each smaller bucket's shapes (from forward hooks); one step
     at 136 px against the plain path in bf16 (loss) and f32 (gradients);
     (d) SwinV2-T on fuse: true at batch 128 from the fixture, with host
     RandAugment + ColOut + MixUp, then device RandAugment + ColOut +
     CutMix: 12 launches a step of each fused kernel, loop and resident
     step ms, busy share; (e) ``hvt_torch.tools.train_input_bench`` on
     (c)'s and (d)'s Trainers: host, device and combined img/s,
     overlap_efficiency, the host ms of a step call alone and in the loop;
     (f) every device augmentation on the card against the CPU with the
     same draws (RandAugment's pointwise ops equal, its geometric ops, both
     policies and ColOut within 1 on under 1% of pixels, MixUp, CutMix and
     the progressive resize in f32 and bf16), then timed at batches 256 and
     128; (g) ResNet-50 from the fixture with every augmentation, resumed
     from step 2 of 3 as in 14 (b). (c)-(e) must decode natively where
     phase 1 found libjpeg; without it they run on Pillow and say so;
 16. downstream on the card: (a) ``extract_features`` at full width from
     the synthetic source at 10,000 classes (20,480 train and 4,096 eval
     images): ResNet-50 from configs/simpleshot/r50_base.yaml (2048-d, batch
     4,096) and SwinV2-T on fuse: true (768-d, batch 2,048), each from a
     seeded torch:// PretrainedBackbone: img/s, ms a batch, peak memory, 12
     launches of each fused forward kernel a SwinV2-T batch and none for
     ResNet-50, one batch through the kernels against the plain path
     (cosine >= 0.999 a row, max|Δ| within 5e-2·max|f|), and a second call
     that hits the cache and builds no forward; (b) flat SimpleShot (cl2n,
     l2n) on the card against the same fit on the CPU in f64, on (a)'s
     ResNet-50 features (equal but where the CPU's nearest centroids tie:
     the synthetic source repeats 64 images) and on ResNet-50 features of
     seeded class images at 10,000 classes (equal); (c) the linear probe's
     grid search (5 folds x 3 alphas and the refit) on the card in f32 on
     ResNet-50 features of 1,000 seeded classes x 10 images, against the
     same grid in f64 on the card (the alpha, >= 99.5% of the test
     predictions, each objective within 1e-4) and the card's f64 refit
     against the CPU's over 5 iterations (within 1e-8), each fold's fit
     timed, then one fit of the chosen alpha at 10,000 classes x 3 images;
     (d) on a JPEG fixture (40 taxonomy-shaped classes, 400 train and 80 val
     images): ``hvt_torch.simpleshot.main`` with
     configs/simpleshot/r50_hierarchical.yaml, ``hvt_torch.linear_probe.main``
     with configs/linear_probe/r50_base.yaml and the predict module's ``run``
     on a multitask SwinV2-T on fuse: true, flat and hierarchical: their
     metrics, one JSONL row an image, top-1 equal to the plain path's where
     its top-2 margin passes 1e-2, 12 launches of each fused forward kernel
     a batch; (e) HTTP serving as phase 4 of ResNet-50 (inat21.yaml) and
     SwinV2-B on fuse: true at batch 64 (24 launches of each fused forward
     kernel a forward); (f) ``hvt_torch.tools.serve_bench`` on SwinV2-T
     fuse: true, engine and --http, 8 clients x 12 requests at batch 8, its
     JSON line each.
 17. the rest of training, through ``hvt_torch.main.main`` at 10,000 classes
     on the synthetic source, every run at its config's written batch with
     ``grad_accum: auto`` (the probe's launches set apart; each step's and
     the run's launches exact: a pass launches each kernel per microbatch
     as a step did before, a SAM step makes two passes): (a) ResNet-50 from
     inat21.yaml + recipes/hot_tpu.yaml with bn_pallas at 2,048 for 12
     steps, SAM (rho 0.5, interval 10) at steps 0 and 10, the resolved
     accumulation, losses, the EMA's update, step ms of SAM and other steps,
     img/s, peak memory, and the BatchNorm pair checked and timed at the
     microbatch's shapes at the sizes SAM's steps ran at, beside
     batch_norm_stats / batch_norm_backward_reduce; (b) swinv2_tiny.yaml on
     fuse: true at 2,048 for 4 steps; (c) SwinV2-B (phase 10's) at 2,048
     for 2 steps; (d) SwinV2-T fuse: true at 256, drop path 0: one step at
     grad_accum 2 against 1 (each gradient's cosine >= 0.999, loss within
     1e-3) and SAM with 2 microbatches on the kernel path against the plain
     path (phase 7's tolerances); (e) at 128, the same weights, batch and
     generator with and without recomputation, under deterministic
     settings: SwinV2-T ``remat`` on both routes (forward kernels 24,
     backward 12 a step) and ResNet-50 ``remat_stages: [1, 2, 3, 4]`` with
     bn_pallas and stochastic depth (the sums kernel once more for each of
     the 52 BatchNorms in the stages: 105; the reduce 53), gradients and
     running statistics bit-equal, peak memory of each; (f) SwinV2-T with
     ``ape`` on fuse: true, one step against the plain path; (g)
     ``bn_custom`` against ``bn_pallas`` on ResNet-50 at 256 (no BatchNorm
     kernel launch, each gradient's cosine >= 0.99) and inat21.yaml +
     fixed/r50_rand_species_multitask_pretrain_1.yaml (``bn_groups: 4``,
     the multitask hierarchy of the synthetic source) at 2,048 for 2 steps.
 18. ViT and DINOv2 through the flash-attention kernels (forward, dK/dV,
     dQ with D = rowsum(dO∘O); csrc/flash_attention.cu): (a) the kernels'
     three plans (hvt_flash_plan, 15 numbers) equal to
     flash_attention.flash_plan at every N up to 1,400; each kernel against
     its plain version in bf16 at (B, H, N) = (64, 12, 197), (64, 12, 257),
     (8, 12, 1025) and (4, 12, 1370), and at (3, 4, N) in bf16 and f32 at
     the plan's edges N = 1, 64, 208, 209, 256, 257 and 1,025 (o, dq, dk, dv
     within 1e-2/2e-2 of max|plain|, the log-sum-exp 1e-4, the dQ kernel's
     D against ``delta_rows`` 1e-5 of the largest row's Σ|dO∘O|; f32
     tensors of bf16 values, which the f32 route's rounding leaves as they
     are), and at N = 197 and 209 with one query row whose logits all lie
     below -100 (finite); the backward's rerun bit-equal, D included; (b)
     each kernel's ms, host and device ms, bound and plain version's ms at
     (2048, 12, 197) (one ViT-B/16 block at vit_b16.yaml's batch) and at the
     four shapes, beside ``delta_rows`` (the eager D the parent ran before
     its dQ), the whole CUDA backward (dQ then dK/dV) and SDPA's flash and
     efficient backends (forward, and forward plus backward) on the same q,
     k, v, and the flash kernels' ptxas lines with each plan's dynamic
     shared memory and blocks an SM; (c) pretrain/vit_b16.yaml (ViT-B/16,
     10,000 classes) at 2,048 with grad_accum auto for 3 steps on one
     synthetic batch, no warmup, on use_flash true (12 launches of each
     kernel a microbatch pass, 12 forward launches an eval batch) and false
     (no kernel): the resolved accumulation, peak memory, a falling loss,
     and on use_flash one step's loss and gradients at batch 64 against the
     plain path; (d) hvt_torch.linear_probe and hvt_torch.simpleshot on
     configs/{linear_probe,simpleshot}/dinov2_b14.yaml with use_flash and
     seeded weights on 2,048 + 512 synthetic images (12 forward launches a
     feature batch), and 256 images' 1,536-d features against the plain
     path. The three kernels close the JSON line.
 19. ConvNeXt, RegNet-Y and EfficientNet, which launch no kernel of the
     repository (every counter read 0 after each sub-phase): (a)
     convnext_tiny, regnety_040 and efficientnet_b0 at full width, batch 8,
     224 px, seeded weights drawn away from init, in f32: the card against
     the same model on the CPU (eval and train-mode logits within
     1e-3·max|logit|, running statistics within 1e-4 of their max, one
     step's gradients each at cosine >= 0.999); (b) convnext_tiny.yaml and
     regnety_040.yaml at their 2,048 with grad_accum auto, 3 steps on one
     synthetic batch without warmup (the loss must fall), evaluated on
     2,048 images before and after: the resolved accumulation, peak memory,
     step ms, img/s and each evaluation's wall time; (c) EfficientNet-B0 on
     inat21.yaml's recipe at 256 for 4 steps (drop connect and dropout 0.2);
     (d) ConvNeXt-T and RegNetY-4.0GF at 64 with remat against none,
     gradients and running statistics bit-equal; (e) ConvNeXt-T served over
     HTTP at 64 (phase 4's helper); (f) ConvNeXt-T's depthwise 7x7 and
     RegNetY's grouped 3x3 convs alone at each stage at 1,024 in bf16,
     channels-last and NCHW, forward and forward + backward ms beside the
     forward's bound.
 20. data parallelism over torch.distributed, a world of one through NCCL
     (``init_process_group`` over tcp://127.0.0.1 on a free port, then
     ``destroy_process_group``): (a) ``bn_train`` at ResNet-50's 53
     BatchNorm shapes at batch 256 and 224 px in bf16 under the declared
     group (each reduction's rows launch alone, an all-reduce of its
     (chunks, 2, C) partials, the ``bn_finish`` launch on the global n)
     against the one-process route: y, mean, var, dx, dscale and dbias
     bit-equal, the calls of each route counted, each route's ms a step and
     the host's ops of one call, and ``bn_finish`` alone against its plain
     version within BN_FINISH_TOL; (b)
     inat21.yaml's ResNet-50 (phase 9's config, bn_pallas) at 256 and
     swinv2_tiny.yaml on fuse: true at 128, 3 steps each through
     ``hvt_torch.main.main`` without the group and under it, with
     deterministic cuDNN: losses, parameters and running statistics
     bit-equal, step ms of each route, the collectives a step (the ResNet's
     106 BatchNorm all-reduces among them) and ``bn_finish``'s launches;
     (c) ``torchrun --standalone --nproc_per_node=1 -m hvt_torch.main`` for 2
     steps of ResNet-50 at 256 on the synthetic source: world 1, rank 0,
     ``log0.txt`` and the step-2 checkpoint. The script needs one card, so
     NCCL across several cards is not part of it;
 21. tensor parallelism (``mesh.model``) and ZeRO-1 (``mesh.zero``): two
     spawned ranks share the card over gloo (NCCL takes one rank a device;
     gloo's all-gathers of CUDA tensors go through the host), each running
     ``hvt_torch.main.main`` in turn on (a) SwinV2-T fused and (b) unfused
     at 128 with ``model: 2`` from a drawn backbone (PretrainedBackbone),
     (c) inat21.yaml's ResNet-50 (bn_pallas, EMA) at 256 and (d) SwinV2-T
     fused at 128, each on data 2 with and without ``zero``, and (e)
     vit_b16.yaml on flash at 64 with ``model: 2``, 2 steps each. (a), (b), (e) are held against the same run in this process:
     losses within 1e-2, step-1 gradients (gathered over the model group)
     at cosine ≥ 0.99 and norm within 5%, parameters after the steps
     within 2·steps·lr and a mean of 0.1·lr; (c) and (d) bit-equal to their
     data-parallel twins, with less optimizer state a rank. Each rank's
     step ms, peak memory, optimizer-state bytes, kernels launched and
     collectives issued a step are printed; the kernel counts a step are
     asserted (12 of each fused MLP kernel, of each packed attention
     kernel and of each flash kernel; 106 ``bn_finish``);
 22. SwinV2's Switch-MoE: SwinV2-T with 8 experts (swinv2_tiny.yaml with
     ``moe_experts: 8``; MoE in stage 2's blocks 1, 3, 5 and stage 3's
     block 1, unfused on either route) at 224 px: (a) ``fuse: true`` at 128
     for 3 steps through ``hvt_torch.main.main``, a step launching 4 of each
     packed attention kernel (the MoE blocks) and 8 of each fused half (the
     dense blocks), an eval batch the forwards alone: step ms, peak memory,
     the aux loss and dropped-token share of each MoE block, each MoE layer
     alone (forward, forward and backward, host and device ms) and their
     share of the step; one step's loss and gradients from drawn weights
     against the plain path on the same routing (the plain path takes the
     kernel path's choice of expert; the share its own argmax would route
     elsewhere is printed); (b) the same on ``fuse: false`` (12 packed
     pairs a step); (c) swinv2_tiny.yaml's 2,048 with grad_accum auto for 2
     steps; (d) an eval-only run over 2,052 images and InferenceEngine
     serving HTTP requests, the logits and the served records held against
     the plain path; (e) two gloo ranks sharing the card at ``model: 2``
     (4 of each block's 8 experts a rank) for 2 steps from a drawn
     backbone against the same run in one process (losses, step-1
     gradients, parameters; whether bit-equal is printed, not demanded),
     13 model-group all-reduces a step a rank.
 23. int8 w8a8 serving (``hvt_torch.ops.quant``, ``csrc/int8_conv.cu``): (a)
     every distinct conv product the quantizer makes in ResNet-50,
     ConvNeXt-T, EfficientNet-B0 and RegNetY-4.0GF at 224 px and batch 8
     (recorded from an int8 forward), the int8 conv kernel (or a 1x1's
     _int_mm and dequant) against its plain version (exact sums in f64):
     int32 sums and f32 outputs bit-equal, x and w off an 8-byte boundary;
     each of ResNet-50's and ConvNeXt-T's at 64, the engine's batch, its
     int32 sums and bf16 outputs bit-equal to the plain version's, timed
     beside its bound (int8 at 1,979 TOPS, 3.35 TB/s), its plain version
     and bf16 F.conv2d or F.linear (not the same function: torch has no
     CUDA int8 conv); int8_linear at SwinV2-T's and ViT-B/16's Dense shapes
     at 64, int32 sums and f32 and bf16 outputs bit-equal to its plain
     version, timed beside bf16 F.linear; (b) the int8 engine
     (``InferenceEngine(quantize="int8", calibrate=2)``) at 64 for
     ResNet-50 (inat21.yaml, seeded init), SwinV2-T on fuse: true and false
     and ConvNeXt-T (weights drawn, through load_path): the calibrated, the
     dynamic and the full-precision steps' launches (the int8 kernels, and
     the repository's kernels on SwinV2's routes as without int8), each
     row's cosine against full precision > 0.99 (hvt's bound), 4 images
     against the same int8 forward on the CPU (f32, SwinV2 in bf16, within
     5e-2·max|logit| and top-1 equal where decided); (c) the engine step's
     img/s, int8 and bf16, at 64 and 256 (ResNet-50, SwinV2-T fused), over
     two alternating windows of at least 0.5 s a kind and batch; one
     forward's kernel time split by torch.profiler, the _int_mm GEMMs found
     by their correlation with ``aten::_int_mm``; ``python -m
     hvt_torch.serve --quantize int8 --calibrate 2`` answers 4 requests,
     each record equal to the in-process engine's.
Each phase's seconds are printed when the next begins, and all of them on
the ``[done]`` line and in the report (``phase_seconds``).
Every Trainer writes its checkpoints and run log under a temporary
``machine.save_root``, emptied at the end of each run or phase and removed
at exit; the Trainers' own lines (the RunLogger's config and records) go to
chiprun_out/trainer_log.txt.
Phases 7 and 9-11 evaluate each training run on one synthetic batch before
its first step and after its last (``eval_interval: 1dur``), outside the
timed steps; those forwards' launches are counted apart.
Phases 3, 5 and 6 also hold the SwinV2-B block shapes: the fused forwards
(NHWC and windowed attention halves, MLP half) at batch 64 (eval, every
stage unchunked), the fused backwards and the chunked MLP (forward and
backward, stage 4, K = 2) at batch 128, each timed per SwinV2-B training
step beside its bound and plain version. Phases 3, 5 and 6 hold and time the
windowed attention half (forward, backward) and split-q/k/v window attention
(forward in bf16 and f32, backward) at SwinV2-T's block shapes as well.
Phase 3 holds the retired fused halves at SwinV2-T's and SwinV2-B's block
shapes at batch 64, in f32 (x and every weight) and in bf16; phase 5 times
them at both models' block shapes, with their host and device ms, each
sub-kernel's device ms (the f32 operands' pieces, qkv, the core, proj,
LayerNorm; fc1, fc2), each product's TFLOP/s, and the composite yardstick
(F.linear in f32, SDPA in f32 on the normalised q and k with z as its mask,
F.layer_norm, no grad); their bound counts every product's operations
times its bf16 piece products at the tensor-core rate, PR 8's count (the
f32 rate unless both operands are bf16) beside it.

Comparisons run with TF32 off (cuDNN and matmul), so the f32 parts of the
plain path (patch-embed conv, head) are true f32. The kernel table goes on a
line before the card's name; the last line is {"ok": true, "device": {...}}.
The full report lands in chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import http.client as http_client
import json
import math
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, the same data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3
PEAK_OPS = {"bf16": H100_BF16_FLOPS, "f32": H100_F32_FLOPS}
# SwinV2-T and SwinV2-B at 224 px: (grid, channels, heads, blocks) per stage
STAGES = ((56, 96, 3, 2), (28, 192, 6, 2), (14, 384, 12, 6), (7, 768, 24, 2))
BASE_STAGES = ((56, 128, 4, 2), (28, 256, 8, 2), (14, 512, 16, 18), (7, 1024, 32, 2))
WINDOW = 7
CLASSES = 10_000  # iNat21 species
BATCH = 64  # the engine's batch shape on the main path and in phases 3 and 5
TRAIN_BATCH = 128  # bench.py's SwinV2-T batch per chip: phases 6 and 7
TRAIN_STEPS = 20
REQUESTS = 8  # single requests served on each route before the timed burst
KERNELS = {  # name: (source, TPU kernel it replaces, route of the main path)
    "window_attention_packed_fwd": ("hvt_torch/ops/csrc/window_attention.cu",
                                    "hvt/ops/window_attention_pallas.py:473", False),
    "mlp_half_fwd": ("hvt_torch/ops/csrc/mlp.cu", "hvt/ops/fused_halves_pallas.py:338", True),
    "attention_half_nhwc_fwd": ("hvt_torch/ops/csrc/fused_halves.cu",
                                "hvt/ops/fused_halves_pallas.py:1330", True),
}
BWD_KERNEL = "window_attention_packed_bwd"
BWD_SOURCE = ("hvt_torch/ops/csrc/window_attention_bwd.cu", "hvt/ops/window_attention_pallas.py:558")
FUSED_BWD = {  # name: (source, TPU kernel it replaces) — the fuse: true route's backward
    "mlp_half_bwd": ("hvt_torch/ops/csrc/mlp.cu", "hvt/ops/fused_halves_pallas.py:371"),
    "attention_half_nhwc_bwd": ("hvt_torch/ops/csrc/fused_halves_bwd.cu",
                                "hvt/ops/fused_halves_pallas.py:1386"),
}
CHUNKED = {  # name: (source, TPU kernel it replaces) — SwinV2-B's stage-4 MLP in training
    "mlp_half_chunked_fwd": ("hvt_torch/ops/csrc/mlp.cu", "hvt/ops/fused_halves_pallas.py:592"),
    "mlp_half_chunked_bwd": ("hvt_torch/ops/csrc/mlp.cu", "hvt/ops/fused_halves_pallas.py:627"),
}
WINDOWED = {  # name: (source, TPU kernel it replaces) — hvt's fuse_nhwc: false route
    "attention_half_fwd": ("hvt_torch/ops/csrc/attention_half.cu",
                           "hvt/ops/fused_halves_pallas.py:1216"),
    "attention_half_bwd": ("hvt_torch/ops/csrc/attention_half.cu",
                           "hvt/ops/fused_halves_pallas.py:1257"),
}
SPLIT = {  # name: (source, TPU kernel it replaces) — hvt's window_attention op on split q, k, v
    "window_attention_fwd": ("hvt_torch/ops/csrc/window_attention.cu",
                             "hvt/ops/window_attention_pallas.py:107"),
    "window_attention_bwd": ("hvt_torch/ops/csrc/window_attention_bwd.cu",
                             "hvt/ops/window_attention_pallas.py:246"),
}
RETIRED = {  # name: (source, TPU kernel it replaces) — hvt's retired fused halves, phase 12
    "swin_block_attention_fwd": ("hvt_torch/ops/csrc/swin_block.cu",
                                 "hvt/ops/swin_block_pallas.py:160"),
    "swin_block_mlp_fwd": ("hvt_torch/ops/csrc/swin_block.cu", "hvt/ops/swin_block_pallas.py:244"),
}
# phases 3 and 5: each retired half in f32 (its name) and in bf16
RETIRED_CASES = tuple(name + sfx for name in RETIRED for sfx in ("", "_bf16"))
# phase 12: the device kernels the retired halves may run at SwinV2's shapes:
# the f32 operands' pieces, the four tensor-core products, the tensor-core
# attention core and the LayerNorm pass
RETIRED_DEVICE_KERNELS = ("sb_split_kernel", "sb_qkv_kernel", "attention_fwd_tc_kernel",
                          "sb_proj_kernel", "sb_fc1_kernel", "sb_fc2_kernel",
                          "sb_layer_norm_kernel")
ROUTE_STEPS = 7  # phase 11 (b) and (c): a median after the first 5
CHUNKS = 2  # hvt's K for a C = 1024 MLP half in training at its default budget
# Phase 10: launches of each kernel per SwinV2-B training step (24 blocks;
# stage 4's two MLP halves chunked, one launch per block for all K chunks)
BASE_TRAIN_PER_STEP = {"attention_half_nhwc_fwd": 24, "attention_half_nhwc_bwd": 24,
                       "mlp_half_fwd": 22, "mlp_half_bwd": 22, "mlp_half_chunked_fwd": 2,
                       "mlp_half_chunked_bwd": 2}
TRAIN_KERNELS = {  # kernels each training step launches 12 times, per route
    False: ("window_attention_packed_fwd", BWD_KERNEL),
    True: ("mlp_half_fwd", "attention_half_nhwc_fwd", *FUSED_BWD),
}
# Kernel names of each training path's backward and forward in a profile.
# The window-attention forwards run attention_fwd_tc_kernel at SwinV2's shapes
# (head dim 32, N <= 64) and attention_fwd_kernel at others. The attention
# half's forward runs attn_half_fwd_ao_kernel, attn_half_fwd_proj_kernel and
# ln_resid_fwd_kernel; its backward recomputes the attention output in
# attn_half_bwd_ao_kernel, a name of its own. The MLP half's forward (both
# sites) runs mlp_fwd_fc1_kernel, mlp_fwd_fc2_kernel and ln_resid_fwd_kernel;
# its backward recomputes h and the pre-LN sum in mlp_bwd_fc1_kernel and
# mlp_bwd_fc2_kernel.
PROFILE_NAMES = {
    False: {"backward": ("attention_bwd_",), "forward": ("attention_fwd_tc", "attention_fwd_kernel")},
    True: {"backward": ("mlp_bwd_", "attn_half_bwd_", "grad_tn", "sum_parts"),
           "forward": ("mlp_fwd_", "attn_half_fwd_", "ln_resid_fwd")},
    "base": {"backward": ("mlp_bwd_", "attn_half_bwd_", "grad_tn", "sum_parts"),
             "forward": ("mlp_fwd_", "attn_half_fwd_", "ln_resid_fwd")},
    # bn_train's four calls: each reduction's rows and finish launches, and a pass
    "resnet": {"backward": ("bwd_reduce_kernel", "finish_kernel<1>", "hvt::dx_kernel"),
               "forward": ("channel_sums_kernel", "finish_kernel<0>", "normalize_kernel")},
    # the fused route with the packed attention pair (phase 11 (c))
    "packed_fused": {"backward": ("attention_bwd_", "mlp_bwd_", "grad_tn", "sum_parts"),
                     "forward": ("attention_fwd_tc", "attention_fwd_kernel", "mlp_fwd_",
                                 "ln_resid_fwd")},
}
KEEP = 0.8  # drop-path keep probability of the scales in phase 6's inputs
# max|kernel - plain| ≤ TOL·max|plain|: both sides share the arithmetic
# contract (bf16 operands, f32 accumulation, f32 softmax/LayerNorm) and
# differ only in summation order and the odd bf16 rounding flip of an
# operand or output.
TOL = {"window_attention_packed_fwd": 1e-2, "mlp_half_fwd": 2e-2,
       "attention_half_nhwc_fwd": 2e-2, "attention_half_fwd": 2e-2,
       "window_attention_fwd": 1e-2,  # bf16: P and the output rounded on both sides
       "window_attention_fwd_f32": 1e-4,  # f32 in and out: summation order only
       "window_attention_packed_fwd_f32": 1e-4}
# The retired halves compute every product, the core and the LayerNorm at f32
# accuracy on both sides (the kernels from bf16 pieces on tensor cores): in
# f32 they differ in summation order only; in bf16 also in the output's
# rounding (and the odd flip of the GELU output's rounding to bf16, which the
# next ulp of the output covers).
TOL.update({"swin_block_attention_fwd": 1e-4, "swin_block_mlp_fwd": 1e-4,
            "swin_block_attention_fwd_bf16": 2e-2, "swin_block_mlp_fwd_bf16": 2e-2})
# The backward kernel against packed_heads_backward, relative to max|plain|:
# dqkv is rounded to bf16 at the store on both sides (1e-2, as the
# forward); dbias and dlogit_scale are f32 sums over up to 8,192 windows in
# another order (1e-3).
BWD_TOL = {"dqkv": 1e-2, "dbias": 1e-3, "dlogit_scale": 1e-3}
SPLIT_BWD_TOL = {"dq": 1e-2, "dk": 1e-2, "dv": 1e-2, "dbias": 1e-3, "dlogit_scale": 1e-3}
# Both backward kernels in f32 (phase 6, check only): f32 in and out on both
# sides, the kernel's bf16 pieces keeping f32 accuracy; every gradient within
# F32_BWD_TOL·max|plain|.
F32_BWD_TOL = 1e-4
# The fused halves' backward kernels against their plain versions, every
# gradient relative to max|plain|: both sides round every product's operands
# to bf16 (hvt's _dot/_dot_t, weight gradients included) and dx to bf16 at
# the store, so they differ in summation order and where an operand rounds
# apart: the forward halves' 2e-2.
FUSED_BWD_TOL = 2e-2
FUSED_GRADS = {
    "mlp_half_bwd": ("dx", "dw1", "db1", "dw2", "db2", "dlns", "dlnb"),
    "attention_half_nhwc_bwd": ("dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj",
                                "dbproj", "dlns", "dlnb"),
}
FUSED_GRADS["attention_half_bwd"] = FUSED_GRADS["attention_half_nhwc_bwd"]
# The fused halves' three backward rows: phase 6 also splits their time
# between host and device and among their kernels, and times the composite
# yardstick beside them (SwinV2-T's block shapes; the chunked MLP's backward
# likewise at its SwinV2-B shape).
ATTN_HALF_BWD = ("attention_half_nhwc_bwd", "attention_half_bwd")
SPLIT_BWD = (*ATTN_HALF_BWD, "mlp_half_bwd")
# The sub-kernels of a backward call, by the kernel's name, and the names of
# its two weight-gradient products (the first grad_tn after dx, then the
# second). Attention half: the attention output, proj and the LayerNorm
# backward, the core, dx, dWqkv and dWproj, the fixed-order sums. MLP half
# (both sites): fc1 and fc2 (unchunked only), the LayerNorm backward, the
# hidden kernel, dx, dW1 and dW2, the sums. A kernel matching none is keyed
# by its own name.
ATTN_SUB_KERNELS = ((("attn_half_bwd_ao", "ao"), ("attn_half_bwd_proj", "proj"),
                     ("attn_half_bwd_core", "core"), ("attn_half_bwd_dx", "dx"),
                     ("grad_tn", "grad_tn"), ("sum_parts", "sum_parts")),
                    ("grad_tn dWqkv", "grad_tn dWproj"))
# The attention half's forward (both entries): the attention output, proj and
# the LayerNorm-and-residual pass (no weight-gradient product).
ATTN_HALF_FWD = ("attention_half_nhwc_fwd", "attention_half_fwd")
FWD_SUB_KERNELS = ((("attn_half_fwd_ao", "ao"), ("attn_half_fwd_proj", "proj"),
                    ("ln_resid_fwd", "LayerNorm")), ())
# The MLP half's forward (both sites): fc1, fc2 and the LayerNorm-and-residual
# pass.
MLP_FWD_SUB_KERNELS = ((("mlp_fwd_fc1", "fc1"), ("mlp_fwd_fc2", "fc2"),
                        ("ln_resid_fwd", "LayerNorm")), ())
# The fused forwards phase 5 splits into host/device ms and their three
# kernels' device ms: their sub-kernels and the bytes per token-channel that
# their design adds to the function's through device memory (the attention
# half: ao and pre; the MLP half: h written and read in bf16, pre in f32, x
# read twice).
FWD_SPLITS = {"attention_half_nhwc_fwd": (FWD_SUB_KERNELS, 12),
              "attention_half_fwd": (FWD_SUB_KERNELS, 12),
              "mlp_half_fwd": (MLP_FWD_SUB_KERNELS, 26)}
# The retired halves' chains (csrc/swin_block.cu): the f32 operands' pieces,
# the products, the attention core, the LayerNorm pass; bytes per
# token-channel their design adds through device memory, written and read:
# attention, x's pieces (f32 x: 6 and 6), qkv (12, 12), the core's output
# (4, 4) and its pieces (6, 6), the f32 pre-LN sum (4, 4); MLP, x's pieces,
# h (4 hidden units a channel: bf16 2 and 2 each, or W2 f32: its three
# pieces, 6 and 6), the pre-LN sum.
RETIRED_ATTN_SUB = ((("sb_split", "pieces"), ("sb_qkv", "qkv"), ("attention_fwd", "core"),
                     ("sb_proj", "proj"), ("sb_layer_norm", "LayerNorm")), ())
RETIRED_MLP_SUB = ((("sb_split", "pieces"), ("sb_fc1", "fc1"), ("sb_fc2", "fc2"),
                    ("sb_layer_norm", "LayerNorm")), ())
FWD_SPLITS.update({"swin_block_attention_fwd": (RETIRED_ATTN_SUB, 64),
                   "swin_block_attention_fwd_bf16": (RETIRED_ATTN_SUB, 52),
                   "swin_block_mlp_fwd": (RETIRED_MLP_SUB, 68),
                   "swin_block_mlp_fwd_bf16": (RETIRED_MLP_SUB, 24)})
MLP_SUB_KERNELS = ((("mlp_bwd_fc1", "fc1"), ("mlp_bwd_fc2", "fc2"),
                    ("mlp_bwd_ln", "LayerNorm backward"), ("mlp_bwd_hidden", "hidden"),
                    ("mlp_bwd_dx", "dx"), ("grad_tn", "grad_tn"), ("sum_parts", "sum_parts")),
                   ("grad_tn dW1", "grad_tn dW2"))
# Phase 7, one training step on the kernel path against the plain path.
LOSS_RTOL = 1e-2
GRAD_COSINE = 0.99
ZERO_GRAD_TOL = 1e-5  # a gradient 0 in exact arithmetic, of the largest gradient
GRAD_NORM_RTOL = 0.05
# Phases 8 and 9: ResNet-50 at bench.py's batch per chip. Each BatchNorm input
# shape at 224 px as (H = W, channels, BatchNorm layers of that shape).
RESNET_BATCH = 256
RESNET_STEPS = 21  # the EMA (interval 20) updates at steps 0 and 20
RESNET_BN_SHAPES = ((112, 64, 1), (56, 64, 6), (56, 256, 4), (56, 128, 1), (28, 128, 7),
                    (28, 512, 5), (28, 256, 1), (14, 256, 11), (14, 1024, 7), (14, 512, 1),
                    (7, 512, 5), (7, 2048, 4))
RESNET_BN_LAYERS = 53
BN_KERNELS = {  # name: (source, TPU kernel it replaces); bn_train's four calls
    "bn_channel_sums": ("hvt_torch/ops/csrc/bn_stats.cu", "hvt/ops/bn_stats_pallas.py:94"),
    "bn_normalize": ("hvt_torch/ops/csrc/bn_stats.cu",
                     "hvt/ops/bn_stats_pallas.py:273 (_bn_train_fwd around :94)"),
    "bn_bwd_reduce": ("hvt_torch/ops/csrc/bn_stats.cu", "hvt/ops/bn_stats_pallas.py:181"),
    "bn_dx": ("hvt_torch/ops/csrc/bn_stats.cu",
              "hvt/ops/bn_stats_pallas.py:285 (_bn_train_bwd around :181)"),
}
# Each reduction's sums within BN_SUM_TOL·Σ|terms| of the f64 sums of the
# same bf16 inputs, per channel (f32 partials over up to 396 chunks, added
# in a fixed order), and its finish (mean, var, rstd; scale·rstd, Σg/n,
# Σg·x̂/n) within BN_FINISH_TOL·max|plain| of the plain formulas on those
# sums; the normalize and dx passes bit-equal to their plain versions on the
# same per-channel vectors (the same separately rounded f32 operations);
# bn_train's dscale and dbias, both f32 sums, within twice BN_SUM_TOL of the
# plain path's; its y and dx (bf16 at the store) within 1e-2·max|plain|.
BN_SUM_TOL = 1e-5
BN_FINISH_TOL = 1e-5
BN_STEPS = ("bn_moments", "bn_normalize", "bn_bwd_terms", "bn_dx")  # bn_stats' four dispatchers
BN_BF16_TOL = 1e-2
# Whole-model logits, kernel path vs plain path: 24 block halves, each
# within its kernel's tolerance, feed one bf16 residual stream.
LOGIT_TOL = 5e-2
TOP1_MARGIN = 1e-2
RECORD_PROB_TOL = 5e-2  # a served record's probabilities against the plain path's, of the largest
# Phase 13 and every evaluation of phases 7 and 9-11: launches of each
# kernel per eval forward (a batch), by model and route. Eval routes as hvt
# does in eval mode: the fused attention half on every fuse: true knob
# (fuse_attn_train steers training only), SwinV2-B's stage-4 MLP unchunked
# (mlp_route(1024, 4096, train=False) = 1); no backward kernel, and no
# BatchNorm kernel (eval normalises with the running statistics).
EVAL_PER_FORWARD = {
    "swinv2_tiny fuse=True": {"mlp_half_fwd": 12, "attention_half_nhwc_fwd": 12},
    "swinv2_tiny fuse=False": {"window_attention_packed_fwd": 12},
    "resnet50": {},
    "swinv2_base fuse=True": {"mlp_half_fwd": 24, "attention_half_nhwc_fwd": 24},
}
# Phase 13: iNat21's eval batch (eval_dataset.global_batch_size of
# configs/pretrain/swinv2_tiny.yaml and inat21.yaml) over 2,052 images, one
# full batch and a padded tail of 4; the plain path runs EVAL_CHUNK
# images at a time (its f32 MLP hidden activations at 2048 images would take
# 10-13 GB a tensor). Against the plain path: the first batch's logits within
# LOGIT_TOL·max|logit|, cross-entropy within EVAL_CE_RTOL relative, acc@1 and
# acc@5 within EVAL_ACC_ATOL absolute, tree-dist within EVAL_ACC_ATOL of its
# range (0-7): each argmax flip moves acc by 1/2,052 and tree-dist by up to
# 7/2,052, so these hold about 10 flips.
EVAL_BATCH = 2048
EVAL_IMAGES = 2052
EVAL_CHUNK = 256
EVAL_CE_RTOL = 1e-2
EVAL_ACC_ATOL = 5e-3
EVAL_TRAIN_STEPS = 4  # the runs that train: max_duration 4ba, eval_interval 2ba
# Phase 14: SwinV2-T (fuse: true, phase 7's recipe) trains CKPT_STEPS steps,
# saved at CKPT_AT and resumed from it; ResNet-50 (phase 9's, EMA) trains
# RESNET_CKPT_STEPS, saved at and resumed from RESNET_CKPT_AT; SIGTERM at
# SIGTERM_AT. A resumed run's losses and final state must lie within
# SPREAD_FACTOR times the two straight runs' own difference (exactly equal
# where the straight runs are), the loss's floor one part in LOSS_FLOOR
# where the straight runs differ at all.
CKPT_STEPS = 6
CKPT_AT = 3
RESNET_CKPT_STEPS = 4
RESNET_CKPT_AT = 2
SIGTERM_AT = 2
SPREAD_FACTOR = 4.0
LOSS_FLOOR = 1e-6


PHASE_SECONDS: dict[str, float] = {}  # phase → seconds, filled as the phases end
_PHASE: dict = {"name": None, "start": 0.0}


def end_phase() -> None:
    """Close the running phase: its seconds into PHASE_SECONDS, printed."""
    name = _PHASE["name"]
    if name is not None:
        PHASE_SECONDS[name] = time.perf_counter() - _PHASE["start"]
        print(f"  phase {name} took {PHASE_SECONDS[name]:.1f} s", flush=True)
        _PHASE["name"] = None


def log(msg: str) -> None:
    """Print a line; a line that opens another phase ("[N] ...") closes the
    running one first and starts its clock."""
    if msg.startswith("[") and "]" in msg:
        name = msg[1:msg.index("]")]
        if name.isdigit() and name != _PHASE["name"]:
            end_phase()
            _PHASE.update(name=name, start=time.perf_counter())
    print(msg, flush=True)


_RUNS: list[pathlib.Path] = []  # the save_root of every Trainer of this script


def runs_root() -> pathlib.Path:
    """A temporary ``machine.save_root`` for every run: the Trainer writes its
    checkpoints and run log there (SwinV2-B's final save is about 1.2 GB);
    ``clear_runs`` empties it at each phase's end, ``main`` removes it."""
    if not _RUNS:
        _RUNS.append(pathlib.Path(tempfile.mkdtemp(prefix="hvt-chip-smoke-")))
    return _RUNS[0]


def clear_runs() -> None:
    if _RUNS:
        for child in _RUNS[0].iterdir():
            shutil.rmtree(child) if child.is_dir() else child.unlink()


@contextlib.contextmanager
def trainer_output():
    """The Trainers' own stdout (the RunLogger's config and records) sent
    to chiprun_out/trainer_log.txt, so that this script's lines stay
    readable."""
    with open(OUT_DIR / "trainer_log.txt", "a") as f, contextlib.redirect_stdout(f):
        yield


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_device_ms(fn, iters: int = 5, kernels: tuple = ()) -> tuple[float, float]:
    """(host ms, device ms) of one call of ``fn`` from an idle card: the
    median time the host takes to return from the call (its launches are
    asynchronous, so this is the time it spends issuing them), and the mean
    kernel time in it from torch.profiler (of the kernels whose names
    contain one of ``kernels``, where given). Where the host's ms exceed the
    device's, back-to-back calls (cuda_time_ms) wait on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    host = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                 and (not kernels or any(k in e.key for k in kernels)))
    return sorted(host)[iters // 2], dev_us / 1e3 / iters


def host_device_line(rec: dict) -> str:
    """Phase 6's host and device times of a backward through autograd and
    in its launch wrapper, per training step and per launch."""
    total = lambda key: sum(st["launches_per_forward"] * st[key] for st in rec["stages"])  # noqa: E731
    return (f"host {total('host_ms'):.4f} / device {total('device_ms'):.4f} ms per step through "
            f"autograd, host {total('wrapper_host_ms'):.4f} / device "
            f"{total('wrapper_device_ms'):.4f} ms in the wrapper; per launch (autograd host/device, "
            "wrapper host/device): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['host_ms']:.3f}/{st['device_ms']:.3f}, "
                f"{st['wrapper_host_ms']:.3f}/{st['wrapper_device_ms']:.3f}" for st in rec["stages"]))


def kernel_split(fn, sub_kernels=ATTN_SUB_KERNELS, trace: str = "attention_half_bwd",
                 iters: int = 5) -> dict:
    """Mean device ms a call of ``fn`` spends in each kind of kernel
    (``sub_kernels``: (pattern, key) pairs and the names of the first and
    second ``grad_tn`` after ``dx``; a kernel matching no pattern is keyed
    by its own name), from a torch.profiler trace of ``iters`` calls
    (chiprun_out/<trace>_trace.json)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    patterns, grad_names = sub_kernels
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = OUT_DIR / f"{trace}_trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    split, grads = {}, 0
    for e in events:
        own = re.search(r"(\w+)(?:<|\()", e["name"])
        key = next((k for pattern, k in patterns if pattern in e["name"]),
                   own.group(1) if own else e["name"])
        if key == "dx":
            grads = 0
        elif key == "grad_tn":
            key = grad_names[min(grads, 1)]
            grads += 1
        split[key] = split.get(key, 0.0) + e["dur"] / 1e3 / iters
    return split


def composite_attention_half(p, windowed: bool):
    """The unfused route's computation of the attention half (the
    yardstick of the two attention-half rows, forward and backward): F.linear qkv in
    bf16, the packed tensor-core window attention
    (``window_attention_packed``), F.linear proj, F.layer_norm with f32
    statistics; on the NHWC map also the roll, partition, reverse, roll
    back and the residual x + dp·branch. Same leaves as
    ``fused_backward_cases``' halves."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import window_attention as wa
    from hvt_torch.ops import window_attention_cuda as wac

    c, heads, grid, shift, mask = p["c"], p["heads"], p["grid"], p["shift"], p["mask"]

    def branch(xw, wq, bq, ls, bias, wp, bp, lns, lnb):
        qkv = F.linear(xw, wq.to(xw.dtype), bq.to(xw.dtype))
        out = wac.window_attention_packed(qkv, ls, bias, mask, num_heads=heads)
        proj = F.linear(out, wp.to(xw.dtype), bp.to(xw.dtype))
        return F.layer_norm(proj.float(), (c,), lns, lnb, 1e-5).to(xw.dtype)

    if windowed:
        return branch

    def nhwc(xm, *params):
        xs = torch.roll(xm, (-shift, -shift), (1, 2)) if shift else xm
        y = wa.window_reverse(branch(wa.window_partition(xs, WINDOW), *params), WINDOW, grid, grid)
        y = torch.roll(y, (shift, shift), (1, 2)) if shift else y
        return xm + p["dp"].to(xm.dtype).reshape(-1, 1, 1, 1) * y

    return nhwc


def split_line(kernels_ms: dict) -> str:
    return "; ".join(f"{k} {v:.4f}" for k, v in sorted(kernels_ms.items(), key=lambda kv: -kv[1]))


def composite_mlp_half(p, resid: bool):
    """The unfused route's computation of the MLP half (the yardstick of the
    MLP rows, forward and backward): F.linear fc1 in bf16, F.gelu, F.linear fc2,
    F.layer_norm with f32 statistics and, where ``resid``, the residual x +
    dp·branch over each image's tokens (``hvt_torch/models/swinv2.py``'s
    Mlp, _layer_norm and drop_path). Same leaves as ``fused_backward_cases``'
    MLP half."""
    import torch.nn.functional as F

    tpi = p["grid"] ** 2

    def half(xt, w1, b1, w2, b2, lns, lnb):
        h = F.gelu(F.linear(xt, w1.to(xt.dtype), b1.to(xt.dtype)))
        y = F.linear(h, w2.to(xt.dtype), b2.to(xt.dtype))
        branch = F.layer_norm(y.float(), (xt.shape[-1],), lns, lnb, 1e-5).to(xt.dtype)
        if not resid:
            return branch
        return xt + p["dp"].to(xt.dtype).repeat_interleave(tpi)[:, None] * branch

    return half


def kernel_counters():
    from hvt_torch.ops import bn_stats_cuda as bsc
    from hvt_torch.ops import flash_attention as fa
    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import swin_block_cuda as sbc
    from hvt_torch.ops import window_attention_cuda as wac

    return {"flash_attention_fwd": fa.FWD_KERNEL, "flash_attention_bwd_dkv": fa.BWD_DKV_KERNEL,
            "flash_attention_bwd_dq": fa.BWD_DQ_KERNEL,
            "window_attention_packed_fwd": wac.KERNEL, "mlp_half_fwd": fh.MLP_KERNEL,
            "attention_half_nhwc_fwd": fh.ATTN_KERNEL, BWD_KERNEL: wac.BWD_KERNEL,
            "mlp_half_bwd": fh.MLP_BWD_KERNEL, "attention_half_nhwc_bwd": fh.ATTN_BWD_KERNEL,
            "mlp_half_chunked_fwd": fh.MLP_CHUNKED_KERNEL,
            "mlp_half_chunked_bwd": fh.MLP_CHUNKED_BWD_KERNEL,
            "bn_channel_sums": bsc.SUMS_KERNEL, "bn_normalize": bsc.NORMALIZE_KERNEL,
            "bn_bwd_reduce": bsc.BWD_KERNEL, "bn_dx": bsc.DX_KERNEL,
            "bn_finish": bsc.FINISH_KERNEL,
            "attention_half_fwd": fh.ATTN_WIN_KERNEL, "attention_half_bwd": fh.ATTN_WIN_BWD_KERNEL,
            "window_attention_fwd": wac.SPLIT_KERNEL, "window_attention_bwd": wac.SPLIT_BWD_KERNEL,
            "swin_block_attention_fwd": sbc.ATTN_KERNEL, "swin_block_mlp_fwd": sbc.MLP_KERNEL}


@contextlib.contextmanager
def swapped(module, **plain):
    """Module attributes replaced by ``plain`` for the duration, then put back."""
    saved = {name: getattr(module, name) for name in plain}
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def plain_versions():
    """The model's kernel wrappers swapped for their plain versions: the
    reference the kernel path is held against. Only this script does this.
    The packed attention becomes the plain forward under torch autograd; the
    fused halves, ``bn_train`` and the flash attention keep their autograd
    Functions with the plain versions in the kernels' place."""
    from hvt_torch.ops import flash_attention as fa
    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import window_attention_cuda as wac

    with swapped(wac, window_attention_packed=wac.window_attention_packed_plain), \
            swapped(fa, forward=fa.forward_plain, backward=fa.backward_plain), \
            swapped(fh, mlp_half_forward=fh.mlp_half_plain,
                    attention_half_nhwc_forward=fh.attention_half_nhwc_plain,
                    attention_half_forward=fh.attention_half_plain,
                    mlp_half_chunked_forward=fh.mlp_half_chunked_plain), \
            plain_fused_backward(), plain_bn_steps():
        yield


def plain_bn_steps():
    """bn_train's four steps swapped for their plain versions (torch's
    reductions, the eager formulas): the parent's route with torch's sums."""
    from hvt_torch.ops import bn_stats

    return swapped(bn_stats, **{name: getattr(bn_stats, f"{name}_plain") for name in BN_STEPS})


def exact_bn_reductions():
    """The plain BatchNorm steps with their sums taken in f64 and rounded to
    f32: the plain path with other (exact) sums, which shows how far a
    change of the sums' last bits alone moves the model's gradients."""
    import torch

    from hvt_torch.ops import bn_stats

    def moments(x, eps):
        n = x.shape[0]
        s, q = (t.float() for t in bn_stats.channel_sums_plain(x.double()))
        mean = s / n
        var = torch.clamp_min(q / n - mean * mean, 0.0)
        return mean, var, torch.rsqrt(var + eps)

    def terms(g, x, mean, rstd, scale):
        n = x.shape[0]
        sg, sgx = (t.float() for t in bn_stats.bn_bwd_reduce_plain(
            g.double(), x.double(), mean.double(), rstd.double()))
        return sg, sgx, scale.float() * rstd, sg / n, sgx / n  # bn_dx_plain reads the last three

    return swapped(bn_stats, bn_moments=moments, bn_bwd_terms=terms,
                   bn_normalize=bn_stats.bn_normalize_plain, bn_dx=bn_stats.bn_dx_plain)


def plain_backward():
    """The packed and split backward kernels' wrappers swapped for their plain
    versions inside the attention's autograd Functions, which keep their
    set-up and tail."""
    from hvt_torch.ops import window_attention_cuda as wac

    return swapped(wac, packed_backward=wac.packed_heads_backward,
                   split_backward=wac.split_heads_backward)


def plain_fused_backward():
    """The fused halves' backward wrappers swapped for their plain versions
    inside the autograd Functions, which keep their set-up and tail."""
    from hvt_torch.ops import fused_halves_cuda as fh

    return swapped(fh, mlp_half_backward=fh.mlp_half_backward_plain,
                   attention_half_nhwc_backward=fh.attention_half_nhwc_backward_plain,
                   attention_half_backward=fh.attention_half_backward_plain,
                   mlp_half_chunked_backward=fh.mlp_half_chunked_backward_plain)


# ---------------------------------------------------------------------------
# Phases 3 and 5: kernels against their plain versions at SwinV2-T stage shapes
# ---------------------------------------------------------------------------


def stage_inputs(stage: int, shift: int, seed: int, batch: int = BATCH, stages=STAGES):
    """Seeded random inputs of one stage's block at ``batch``: every
    parameter drawn (res-post-norm scales around 1, not the zero init)."""
    import numpy as np
    import torch

    from hvt_torch.ops import window_attention as wa

    grid, c, heads, _ = stages[stage]
    n = WINDOW * WINDOW
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    p = {
        "x": t(rng.normal(size=(batch, grid, grid, c)), torch.bfloat16),
        "wqkv": t(rng.normal(size=(3 * c, c)) * c ** -0.5),
        "bqkv": t(np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1])),
        "logit_scale": t(np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3),
        "bias": t(16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))),
        "mask": t(wa.shift_attn_mask((grid, grid), WINDOW, shift)) if shift else None,
        "wproj": t(rng.normal(size=(c, c)) * c ** -0.5),
        "bproj": t(rng.normal(size=c) * 0.1),
        "w1": t(rng.normal(size=(4 * c, c)) * c ** -0.5),
        "b1": t(rng.normal(size=4 * c) * 0.1),
        "w2": t(rng.normal(size=(c, 4 * c)) * (4 * c) ** -0.5),
        "b2": t(rng.normal(size=c) * 0.1),
        "lns": t(1.0 + rng.normal(size=c) * 0.1),
        "lnb": t(rng.normal(size=c) * 0.1),
        "dp": t(np.ones(batch)),
    }
    p["grid"], p["c"], p["heads"], p["shift"] = grid, c, heads, shift
    return p


def piece_products(a_pieces: int, b_pieces: int) -> int:
    """Piece products of order at most 2 of operands in 1 or 3 bf16 pieces
    (csrc/swin_block.cu's piece_terms): 1, 3 or 6."""
    return sum(1 for i in range(a_pieces) for j in range(b_pieces) if i + j <= 2)


def retired_product_ops(name: str, tokens: int, c: int, dt) -> dict:
    """{product: operations} of one retired half's launch at width c over
    ``tokens`` (window 7), x and the weights in dt, each product's
    operations times its piece products, as the tensor cores run them: qkv
    and fc1 1 (bf16) or 6 (f32), proj 3 or 6 (the f32 core output against
    the weights), fc2 1 or 6, the core's q·kᵀ 6 and P·v 3 (the f32 qkv)."""
    import torch

    n = WINDOW * WINDOW
    pieces = 3 if dt == torch.float32 else 1
    if name.startswith("swin_block_attention_fwd"):
        return {"qkv": 6 * tokens * c * c * piece_products(pieces, pieces),
                "core": (6 + 3) * 2 * tokens * n * c,
                "proj": 2 * tokens * c * c * piece_products(3, pieces)}
    return {k: 8 * tokens * c * c * piece_products(pieces, pieces) for k in ("fc1", "fc2")}


def retired_ops(name: str, tokens: int, c: int, dt, restated: bool = True) -> dict:
    """Operations of one retired half's launch (see ops_ms). Restated, this
    design's bound: retired_product_ops, all at the bf16 tensor-core rate.
    Else PR 8's count: a product at the bf16 rate where both its operands
    are bf16, every other one and the core at the f32 CUDA-core rate."""
    import torch

    if restated:
        return {"bf16": sum(retired_product_ops(name, tokens, c, dt).values())}
    rate, n = ("f32" if dt == torch.float32 else "bf16"), WINDOW * WINDOW
    if name.startswith("swin_block_attention_fwd"):
        ops = {"f32": 2 * tokens * c * c + 4 * tokens * n * c}
        ops[rate] = ops.get(rate, 0) + 6 * tokens * c * c
        return ops
    return {rate: 16 * tokens * c * c}


def retired_times(rec: dict, name: str, stages, batch: int) -> None:
    """A timed retired half's extras, per forward of the model of ``stages``:
    PR 8's bound beside the restated one (rec["f32_rate_bound_ms"]), and per
    launch the TFLOP/s of each product (st["tflops"], piece products
    counted, from its device ms)."""
    import torch

    dt = torch.bfloat16 if name.endswith("_bf16") else torch.float32
    old_ms = 0.0
    for st in rec["stages"]:
        grid, c = stages[st["stage"] - 1][:2]
        tokens = batch * grid * grid
        old_ms += st["launches_per_forward"] * ops_ms(retired_ops(name, tokens, c, dt, False))
        st["tflops"] = {k: ops / st["kernels_ms"][k] / 1e9
                        for k, ops in retired_product_ops(name, tokens, c, dt).items()
                        if st["kernels_ms"].get(k)}
    rec["f32_rate_bound_ms"] = max(rec["bytes"] / H100_BYTES_PER_S * 1e3, old_ms)


def composite_attention_branch(p, attn):
    """The retired attention branch through torch's library calls, no grad
    (its yardstick): F.linear in f32 (TF32 off) on the window-partitioned
    map, q and k normalised (q also scaled) for F.scaled_dot_product_attention
    in f32 with z as attn_mask, F.linear proj, F.layer_norm, the windows
    reversed, in x's dtype."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import window_attention as wa

    x, wq, bq, scale, z, wp, bp, lns, lnb = attn
    c, heads, grid = p["c"], p["heads"], p["grid"]
    d, n = c // heads, WINDOW * WINDOW
    xw = wa.window_partition(x.float(), WINDOW)
    nwb = xw.shape[0]
    q, k, v = F.linear(xw, wq.float(), bq).reshape(nwb, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24) * scale.reshape(1, heads, 1, 1)
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
    zb = z.expand(nwb // z.shape[0], -1, -1, -1, -1).reshape(nwb, heads, n, n)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=zb, scale=1.0)
    y = F.layer_norm(F.linear(o.transpose(1, 2).reshape(nwb, n, c), wp.float(), bp), (c,), lns,
                     lnb, 1e-5)
    return wa.window_reverse(y, WINDOW, grid, grid).to(x.dtype)


def composite_mlp_branch(mlp):
    """The retired MLP branch through torch's library calls, no grad: F.linear
    in f32 (TF32 off), F.gelu (exact), h rounded to W2's dtype, F.linear in
    f32, F.layer_norm, in x's dtype."""
    import torch.nn.functional as F

    x, w1, b1, w2, b2, lns, lnb = mlp
    h = F.gelu(F.linear(x.float(), w1.float(), b1)).to(w2.dtype).float()
    return F.layer_norm(F.linear(h, w2.float(), b2), (x.shape[-1],), lns, lnb, 1e-5).to(x.dtype)


def kernel_cases(p):
    """(name, kernel call, plain call, library call or None, bytes moved,
    operations) for one stage's inputs, with the arguments the model's
    block passes at that stage. Operations are a number (at the bf16
    tensor-core rate) or {"f32" or "bf16": operations} (see ops_ms). Also
    {name: call} of the composite yardstick of the fused forwards."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import swin_block_cuda as sbc
    from hvt_torch.ops import window_attention as wa
    from hvt_torch.ops import window_attention_cuda as wac

    x, c, heads, grid, shift = p["x"], p["c"], p["heads"], p["grid"], p["shift"]
    b = x.shape[0]
    n = WINDOW * WINDOW
    d = c // heads
    tokens = b * grid * grid
    nwb = tokens // n
    mask = p["mask"]
    xw = wa.window_partition(torch.roll(x, (-shift, -shift), (1, 2)) if shift else x, WINDOW)
    qkv = fh.bf16_linear(xw, p["wqkv"], p["bqkv"]).to(torch.bfloat16).contiguous()
    z = wac.merge_bias_mask(p["bias"], mask)
    scale = wac.attention_scale(p["logit_scale"])
    nwz = z.shape[0]

    # The library yardstick for kernel 1: one F.scaled_dot_product_attention
    # call on q̂·scale, k̂ and v with z as a float mask. Only the call is timed:
    # the normalisation and the mask's broadcast are made here, beforehand.
    q, k, v = qkv.float().reshape(nwb, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q = (q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24) * scale.reshape(1, heads, 1, 1))
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
    q, k, v = (t.bfloat16().contiguous() for t in (q, k, v))
    zb = z.expand(nwb // nwz, -1, -1, -1, -1).reshape(nwb, heads, n, n).bfloat16()

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=zb, scale=1.0)

    # hvt's op on split q, k, v: (nWB, H, N, D) each, split from the same
    # projection, in bf16 and in f32; its SDPA yardstick in each dtype.
    split = {dt: [t.contiguous() for t in wa.split_heads(qkv.to(dt), heads)]
             for dt in (torch.bfloat16, torch.float32)}
    q32, k32, v32, zb32 = q.float(), k.float(), v.float(), zb.float()

    def sdpa_f32():
        return F.scaled_dot_product_attention(q32, k32, v32, attn_mask=zb32, scale=1.0)

    def split_case(name, dt, library):
        sq, sk, sv = split[dt]
        size = 2 if dt == torch.bfloat16 else 4
        return (name,
                lambda: wa.window_attention(sq, sk, sv, p["logit_scale"], p["bias"], mask),
                lambda: wac.split_heads_forward(sq, sk, sv, z, scale),
                library, size * 4 * sq.numel() + z_bytes, 4 * tokens * n * c)

    attn_args = (p["wqkv"], p["bqkv"], p["logit_scale"], p["bias"], mask, p["wproj"],
                 p["bproj"], p["lns"], p["lnb"], WINDOW, heads)
    attn_leaves = [p[k] for k in ("wqkv", "bqkv", "logit_scale", "bias", "wproj", "bproj", "lns",
                                  "lnb")]
    win_args = attn_args[:-2] + (heads,)
    mlp_args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    xt = x.reshape(tokens, c)
    io_bytes = 2 * 2 * tokens * c  # bf16 map read once, written once
    z_bytes = 4 * z.numel()

    # hvt's retired halves on the map its caller rolls, x and every weight in
    # dt; operations as the tensor cores run them (retired_ops).
    def retired_cases(dt):
        xd = (torch.roll(x, (-shift, -shift), (1, 2)) if shift else x).to(dt)
        wq, wp, w1, w2 = (p[k].to(dt) for k in ("wqkv", "wproj", "w1", "w2"))
        attn = (xd, wq, p["bqkv"], scale.reshape(heads, 1, 1), z, wp, p["bproj"], p["lns"],
                p["lnb"])
        mlp = (xd, w1, p["b1"], w2, p["b2"], p["lns"], p["lnb"])
        kw = {"window": WINDOW, "num_heads": heads}
        sfx = "_bf16" if dt == torch.bfloat16 else ""
        xs, ws = xd.element_size(), wq.element_size()
        composites["swin_block_attention_fwd" + sfx] = lambda: composite_attention_branch(p, attn)
        composites["swin_block_mlp_fwd" + sfx] = lambda: composite_mlp_branch(mlp)
        return [
            ("swin_block_attention_fwd" + sfx, lambda: sbc.fused_attention_branch(*attn, **kw),
             lambda: sbc.fused_attention_branch_plain(*attn, **kw), None,
             2 * xs * tokens * c + 4 * ws * c * c + 4 * 6 * c + z_bytes,
             retired_ops("swin_block_attention_fwd", tokens, c, dt)),
            ("swin_block_mlp_fwd" + sfx, lambda: sbc.fused_mlp_branch(*mlp),
             lambda: sbc.fused_mlp_branch_plain(*mlp), None,
             2 * xs * tokens * c + 8 * ws * c * c + 4 * 7 * c,
             retired_ops("swin_block_mlp_fwd", tokens, c, dt)),
        ]

    def packed_case(name, qx, library):
        size = qx.element_size()
        return (name,
                lambda: wac.window_attention_packed(qx, p["logit_scale"], p["bias"], mask,
                                                    num_heads=heads),
                lambda: wac.window_attention_packed_plain(qx, p["logit_scale"], p["bias"], mask,
                                                          num_heads=heads),
                library, size * (qx.numel() + tokens * c) + z_bytes, 4 * tokens * n * c)

    composites = {
        "mlp_half_fwd": lambda: composite_mlp_half(p, True)(xt, *mlp_args),
        "attention_half_nhwc_fwd": lambda: composite_attention_half(p, False)(x, *attn_leaves),
        "attention_half_fwd": lambda: composite_attention_half(p, True)(xw, *attn_leaves),
    }
    return composites, retired_cases(torch.float32) + retired_cases(torch.bfloat16) + [
        packed_case("window_attention_packed_fwd", qkv, sdpa),
        # the same projection in f32 (the f32 forward is checked and timed, not served)
        packed_case("window_attention_packed_fwd_f32", qkv.float(), sdpa_f32),
        ("mlp_half_fwd",
         lambda: fh.mlp_half(xt, *mlp_args, tpi=grid * grid, dp=p["dp"]),
         lambda: fh.mlp_half_plain(xt, *mlp_args, tpi=grid * grid, dp=p["dp"]),
         None, io_bytes + 2 * 8 * c * c, 16 * tokens * c * c),
        ("attention_half_nhwc_fwd",
         lambda: fh.attention_half_nhwc(x, *attn_args, dp=p["dp"], shift=shift),
         lambda: fh.attention_half_nhwc_plain(x, *attn_args, dp=p["dp"], shift=shift),
         None, io_bytes + 2 * 4 * c * c + z_bytes, 8 * tokens * c * c + 4 * tokens * n * c),
        # the windows partitioned from the rolled map, as the model's block does
        ("attention_half_fwd",
         lambda: fh.attention_half(xw, *win_args),
         lambda: fh.attention_half_plain(xw, *win_args),
         None, io_bytes + 2 * 4 * c * c + z_bytes, 8 * tokens * c * c + 4 * tokens * n * c),
        split_case("window_attention_fwd", torch.bfloat16, sdpa),
        split_case("window_attention_fwd_f32", torch.float32, sdpa_f32),
    ]


def block_shapes(stages=STAGES):
    """(stage, shift, blocks of one forward) of every block shape of a model
    (SwinV2-T by default): a stage's blocks alternate unshifted and shifted by
    window // 2, and the 7 x 7 stage is one global window, never shifted."""
    for stage, (grid, _, _, blocks) in enumerate(stages):
        if grid > WINDOW:
            yield stage, 0, blocks // 2
            yield stage, WINDOW // 2, blocks // 2
        else:
            yield stage, 0, blocks


def train_launches(name: str, c: int) -> int:
    """Launches per block of width c in a training step: 0 for the unchunked
    MLP kernels where hvt's routing chunks the block's MLP (SwinV2-B's
    stage 4), else 1."""
    from hvt_torch.ops import fused_halves_cuda as fh

    return 0 if name.startswith("mlp_half_") and fh.mlp_route(c, 4 * c, True) != 1 else 1


FORWARD_NAMES = (*KERNELS, "attention_half_fwd", "window_attention_fwd",
                 "window_attention_fwd_f32", "window_attention_packed_fwd_f32", *RETIRED_CASES)
# The two window-attention forwards in each dtype, timed beside SDPA in that dtype.
WA_FORWARDS = ("window_attention_packed_fwd", "window_attention_packed_fwd_f32",
               "window_attention_fwd", "window_attention_fwd_f32")


def ops_ms(flops) -> float:
    """Milliseconds of ``flops`` at the card's peak: a number counts at the
    bf16 tensor-core rate, a dict {"f32" or "bf16": operations} each part at
    its type's rate."""
    parts = flops if isinstance(flops, dict) else {"bf16": flops}
    return sum(ops / PEAK_OPS[kind] for kind, ops in parts.items()) * 1e3


def kernel_records(timing: bool, stages=STAGES, batch: int = BATCH, names=FORWARD_NAMES,
                   per_block=None) -> dict:
    """Every kernel of ``names`` against its plain version at each block
    shape of ``stages`` (phase 3), or timed (phase 5). Per kernel, the numbers
    of one forward (12 launches of SwinV2-T's), or of one training step with
    ``per_block(name, c)`` launches per block: the block shapes' launches
    summed."""
    import torch

    records = {name: {"max_abs_err": 0.0, "bytes": 0, "flops": 0, "ops_ms": 0.0, "stages": []}
               for name in names}
    for stage, shift, blocks in block_shapes(stages):
        c = stages[stage][1]
        p = stage_inputs(stage, shift, seed=100 + 10 * stage + shift, batch=batch, stages=stages)
        composites, cases = kernel_cases(p)
        for name, kern, plain, library, nbytes, flops in cases:
            n = blocks * (per_block(name, c) if per_block else 1)
            if name not in names or n == 0:
                continue
            rec = records[name]
            st = {"stage": stage + 1, "shift": shift, "launches_per_forward": n,
                  "bytes": nbytes, "flops": flops}
            rec["bytes"] += n * nbytes
            rec["flops"] += n * (sum(flops.values()) if isinstance(flops, dict) else flops)
            rec["ops_ms"] += n * ops_ms(flops)
            if timing:
                st["ms"] = cuda_time_ms(kern)
                st["plain_ms"] = cuda_time_ms(plain, iters=5)
                st["library_ms"] = None if library is None else cuda_time_ms(library, iters=5)
                if name in WA_FORWARDS:  # the wrapper's host time and the kernel's own device time
                    st["host_ms"], st["device_ms"] = host_device_ms(kern, kernels=("attention_fwd",))
                whole = stages is STAGES or name in RETIRED_CASES
                if name in composites and whole:
                    with torch.no_grad():
                        st["composite_ms"] = cuda_time_ms(composites[name], iters=10)
                if name in FWD_SPLITS and whole:
                    # the call's host and device ms, its three kernels' device ms, and the
                    # design's byte floor: its round trips through device memory added
                    sub_kernels, extra = FWD_SPLITS[name]
                    st["host_ms"], st["device_ms"] = host_device_ms(kern)
                    st["kernels_ms"] = kernel_split(kern, sub_kernels, name)
                    st["design_floor_ms"] = max(
                        (nbytes + extra * p["x"].numel()) / H100_BYTES_PER_S * 1e3, ops_ms(flops))
            else:
                got = kern().float()
                torch.cuda.synchronize()
                ref = plain().float()
                err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= TOL[name] * scale
                log(f"  {name:27s} stage {stage + 1} C={c:3d} shift={shift}: max|kernel-plain| "
                    f"{err:.4g} (tol {TOL[name]}·max|plain| = {TOL[name] * scale:.4g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain version at "
                                         f"stage {stage + 1}, shift {shift}")
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                st["max_abs_err"] = err
            rec["stages"].append(st)
        del p
        torch.cuda.empty_cache()
    for name, rec in records.items():
        finish_record(rec, timing)
        if not (timing and rec["stages"]):
            continue
        total = lambda key: sum(st["launches_per_forward"] * st[key] for st in rec["stages"])  # noqa: E731
        if "composite_ms" in rec["stages"][0]:
            rec["composite_ms"] = total("composite_ms")
        if name in FWD_SPLITS and "kernels_ms" in rec["stages"][0]:
            for key in ("host_ms", "device_ms", "design_floor_ms"):
                rec[key] = total(key)
            rec["kernels_ms"] = {}
            for st in rec["stages"]:
                for key, ms in st["kernels_ms"].items():
                    rec["kernels_ms"][key] = (rec["kernels_ms"].get(key, 0.0)
                                              + st["launches_per_forward"] * ms)
    return records


def wide_window_check() -> dict:
    """Phase 3's N = 144 case: both window-attention forwards at window 12
    (swinv2_large_window12_192's stage 1: a 48 x 48 map, C = 192, 6 heads,
    shifted by 6) at batch 8, in bf16 and f32, against their plain versions
    within TOL: the shape the tensor-core forward does not take, which runs
    attention_fwd_kernel. Returns max|kernel-plain| / max|plain| per case."""
    import numpy as np
    import torch

    from hvt_torch.ops import window_attention as wa
    from hvt_torch.ops import window_attention_cuda as wac

    grid, c, heads, window, shift, batch = 48, 192, 6, 12, 6, 8
    n = window * window
    rng = np.random.default_rng(900)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    qkv = t(rng.normal(size=(batch * (grid // window) ** 2, n, 3 * c)))
    ls = t(np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3)
    bias = t(16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n)))))
    mask = t(wa.shift_attn_mask((grid, grid), window, shift))
    z, scale = wac.merge_bias_mask(bias, mask), wac.attention_scale(ls)
    errors = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        x = qkv.to(dt)
        q, k, v = (u.contiguous() for u in wa.split_heads(x, heads))
        cases = {
            "window_attention_packed_fwd": (
                lambda: wac.window_attention_packed(x, ls, bias, mask, num_heads=heads),
                lambda: wac.window_attention_packed_plain(x, ls, bias, mask, num_heads=heads)),
            "window_attention_fwd": (lambda: wa.window_attention(q, k, v, ls, bias, mask),
                                     lambda: wac.split_heads_forward(q, k, v, z, scale)),
        }
        for name, (kern, plain) in cases.items():
            got = kern().float()
            torch.cuda.synchronize()
            ref = plain().float()
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            tol = TOL[name + sfx]
            ok = bool(torch.isfinite(got).all()) and err <= tol * top
            log(f"  {name + sfx:31s} N={n} C={c} shift={shift} batch {batch}: max|kernel-plain| "
                f"{err:.4g} (tol {tol}·max|plain| = {tol * top:.4g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name + sfx} disagrees with its plain version at N = {n}")
            errors[name + sfx] = err / top
    return errors


def finish_record(rec: dict, timing: bool, peak_ops: float = H100_BF16_FLOPS) -> None:
    """The bound of a kernel's launches (its operations at ``peak_ops``, or
    ``ops_ms`` where kernel_records summed them per type), and its times
    summed over them."""
    t_bytes = rec["bytes"] / H100_BYTES_PER_S * 1e3
    t_ops = rec["ops_ms"] if "ops_ms" in rec else rec["flops"] / peak_ops * 1e3
    rec["bound_ms"], rec["bound_by"] = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    if timing:
        total = lambda key: sum(s["launches_per_forward"] * s[key] for s in rec["stages"])  # noqa: E731
        rec["ms"], rec["plain_ms"] = total("ms"), total("plain_ms")
        rec["library_ms"] = None if rec["stages"][0]["library_ms"] is None else total("library_ms")


# ---------------------------------------------------------------------------
# Phase 6: the backward kernel against its plain version at batch 128
# ---------------------------------------------------------------------------


def backward_case(p, dtype=None):
    """qkv, dO, z, scale of one stage's attention at batch TRAIN_BATCH, with
    head 0's logit scale above the log 100 clamp; qkv and dO in ``dtype``
    (bf16 by default)."""
    import torch

    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import window_attention as wa
    from hvt_torch.ops import window_attention_cuda as wac

    x, shift = p["x"], p["shift"]
    p["logit_scale"][0] = 5.0
    xw = wa.window_partition(torch.roll(x, (-shift, -shift), (1, 2)) if shift else x, WINDOW)
    dtype = dtype or torch.bfloat16
    qkv = fh.bf16_linear(xw, p["wqkv"], p["bqkv"]).to(dtype).contiguous()
    gen = torch.Generator("cuda").manual_seed(p["c"] + shift)
    dout = torch.randn(qkv.shape[0], qkv.shape[1], p["c"], device="cuda", generator=gen).to(dtype)
    return qkv, dout, wac.merge_bias_mask(p["bias"], p["mask"]), wac.attention_scale(p["logit_scale"])


def backward_records(timing: bool, dtype=None) -> dict:
    """The backward kernel against packed_heads_backward at every SwinV2-T
    block shape (check, in bf16 or ``dtype``), or timed (bf16) with its bound,
    the plain version and SDPA's backward. Timed as the model runs it
    (``_PackedAttention.backward`` through autograd, its set-up and tail
    included), and the launch wrapper alone. Per training step: the 12
    launches summed."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import window_attention_cuda as wac

    f32 = dtype == torch.float32
    tols = {k: F32_BWD_TOL for k in BWD_TOL} if f32 else BWD_TOL
    name = BWD_KERNEL + (" f32" if f32 else "")
    rec = {"max_abs_err": 0.0, "bytes": 0, "flops": 0, "stages": []}
    for stage, shift, blocks in block_shapes():
        p = stage_inputs(stage, shift, seed=200 + 10 * stage + shift, batch=TRAIN_BATCH)
        qkv, dout, z, scale = backward_case(p, dtype)
        heads, ls = p["heads"], p["logit_scale"]
        nwb, n, c3 = qkv.shape
        d = c3 // 3 // heads
        st = {"stage": stage + 1, "shift": shift, "launches_per_forward": blocks,
              "bytes": 2 * (2 * qkv.numel() + dout.numel()) + 2 * 4 * z.numel(),
              "flops": 10 * heads * n * n * d * nwb}
        rec["bytes"] += blocks * st["bytes"]
        rec["flops"] += blocks * st["flops"]
        if timing:
            q, k, v = qkv.float().reshape(nwb, n, 3, heads, d).permute(2, 0, 3, 1, 4)
            q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24) * scale.reshape(1, heads, 1, 1)
            k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
            q, k, v = (t.bfloat16().contiguous().requires_grad_() for t in (q, k, v))
            zb = z.expand(nwb // z.shape[0], -1, -1, -1, -1).reshape(nwb, heads, n, n).bfloat16()
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=zb, scale=1.0)
            g = dout.reshape(nwb, n, heads, d).transpose(1, 2)
            # the model's backward: _PackedAttention.backward with its bias/scale set-up and tail
            leaves = [qkv.clone().requires_grad_(), ls.clone().requires_grad_(),
                      p["bias"].clone().requires_grad_()]
            wa_out = wac.window_attention_packed(*leaves, p["mask"], num_heads=heads)
            model_bwd = lambda: torch.autograd.grad(wa_out, leaves, dout, retain_graph=True)  # noqa: E731
            wrapper = lambda: wac.packed_backward(qkv, dout, z, scale, heads)  # noqa: E731
            st["ms"] = cuda_time_ms(model_bwd)
            st["wrapper_ms"] = cuda_time_ms(wrapper)
            st["host_ms"], st["device_ms"] = host_device_ms(model_bwd)
            st["wrapper_host_ms"], st["wrapper_device_ms"] = host_device_ms(wrapper)
            with plain_backward():
                st["plain_ms"] = cuda_time_ms(model_bwd, iters=5)
            st["library_ms"] = cuda_time_ms(
                lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), iters=5)
            del out, q, k, v, zb, wa_out, leaves
        else:
            leaves = [qkv.clone().requires_grad_(), ls.clone().requires_grad_(),
                      p["bias"].clone().requires_grad_()]
            wac.window_attention_packed(*leaves, p["mask"], num_heads=heads).backward(dout)
            got = {"dqkv": leaves[0].grad, "dlogit_scale": leaves[1].grad, "dbias": leaves[2].grad}
            rq, rz, rs = wac.packed_heads_backward(qkv, dout, z, scale, heads)
            ref = {"dqkv": rq, "dbias": rz.sum(0),
                   "dlogit_scale": (rs * scale * (ls.reshape(-1) < math.log(100.0))).reshape(ls.shape)}
            torch.cuda.synchronize()
            errs = {}
            for key, tol in tols.items():
                a, b = got[key].float(), ref[key].float()
                err, top = float((a - b).abs().max()), float(b.abs().max())
                errs[key] = err
                ok = bool(torch.isfinite(a).all()) and err <= tol * top
                log(f"  {name} stage {stage + 1} shift={shift} {key:12s}: max|kernel-plain| "
                    f"{err:.4g} (tol {tol}·max|plain| = {tol * top:.4g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{BWD_KERNEL} {key} disagrees with its plain version at "
                                         f"stage {stage + 1}, shift {shift}")
            if float(got["dlogit_scale"][0]) != 0.0:
                raise AssertionError(f"{BWD_KERNEL}: gradient above the logit-scale clamp "
                                     f"{float(got['dlogit_scale'][0])}, not 0")
            st["max_abs_err"] = errs["dqkv"]
            st["errors"] = errs
            rec["max_abs_err"] = max(rec["max_abs_err"], errs["dqkv"])
        rec["stages"].append(st)
        del p, qkv, dout, z
        torch.cuda.empty_cache()
    finish_record(rec, timing)
    return rec


def split_backward_records(timing: bool, dtype=None) -> dict:
    """hvt's op on split q, k, v (``window_attention``, the split kernels)
    against the same autograd Function with the plain versions, at every
    SwinV2-T block shape at batch TRAIN_BATCH in bf16 (or ``dtype``, check
    only), q, k and v split from
    the projection ``backward_case`` gives (check: dq, dk, dv, dbias,
    dlogit_scale, the clamped head's exactly 0); or its backward timed
    through autograd (``_SplitAttention.backward``, set-up and tail
    included), the launch wrapper alone, the plain version and SDPA's
    backward on the same q, k, v. Per training step: 12 launches summed."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import window_attention as wa
    from hvt_torch.ops import window_attention_cuda as wac

    f32 = dtype == torch.float32
    tols = {k: F32_BWD_TOL for k in SPLIT_BWD_TOL} if f32 else SPLIT_BWD_TOL
    name = "window_attention_bwd" + (" f32" if f32 else "")
    rec = {"max_abs_err": 0.0, "bytes": 0, "flops": 0, "stages": []}
    for stage, shift, blocks in block_shapes():
        p = stage_inputs(stage, shift, seed=700 + 10 * stage + shift, batch=TRAIN_BATCH)
        qkv, dout, z, scale = backward_case(p, dtype)
        heads, ls, mask = p["heads"], p["logit_scale"], p["mask"]
        nwb, n, c3 = qkv.shape
        d = c3 // 3 // heads
        q, k, v = (t.contiguous() for t in wa.split_heads(qkv, heads))
        g = dout.reshape(nwb, n, heads, d).transpose(1, 2).contiguous()
        st = {"stage": stage + 1, "shift": shift, "launches_per_forward": blocks,
              "bytes": 2 * 7 * q.numel() + 2 * 4 * z.numel(),
              "flops": 10 * heads * n * n * d * nwb}
        rec["bytes"] += blocks * st["bytes"]
        rec["flops"] += blocks * st["flops"]
        leaves = [t.clone().requires_grad_() for t in (q, k, v, ls, p["bias"])]
        out = wa.window_attention(*leaves, mask)
        model_bwd = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        if timing:
            wrapper = lambda: wac.split_backward(q, k, v, g, z, scale)  # noqa: E731
            st["ms"] = cuda_time_ms(model_bwd)
            st["wrapper_ms"] = cuda_time_ms(wrapper)
            st["host_ms"], st["device_ms"] = host_device_ms(model_bwd)
            st["wrapper_host_ms"], st["wrapper_device_ms"] = host_device_ms(wrapper)
            with plain_backward():
                st["plain_ms"] = cuda_time_ms(model_bwd, iters=5)
            qn = q.float() * torch.rsqrt((q.float() ** 2).sum(-1, keepdim=True) + 1e-24)
            kn = k.float() * torch.rsqrt((k.float() ** 2).sum(-1, keepdim=True) + 1e-24)
            sl = [(qn * scale.reshape(1, heads, 1, 1)).bfloat16().requires_grad_(),
                  kn.bfloat16().requires_grad_(), v.clone().requires_grad_()]
            zb = z.expand(nwb // z.shape[0], -1, -1, -1, -1).reshape(nwb, heads, n, n).bfloat16()
            lib_out = F.scaled_dot_product_attention(*sl, attn_mask=zb, scale=1.0)
            st["library_ms"] = cuda_time_ms(
                lambda: torch.autograd.grad(lib_out, sl, g, retain_graph=True), iters=5)
            del lib_out, sl, zb
        else:
            got = dict(zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), model_bwd()))
            torch.cuda.synchronize()
            with plain_backward():
                ref = dict(zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), model_bwd()))
            errs = {}
            for key, tol in tols.items():
                a, b = got[key].float(), ref[key].float()
                err, top = float((a - b).abs().max()), float(b.abs().max())
                errs[key] = err / top if top else err
                if not (bool(torch.isfinite(a).all()) and err <= tol * top):
                    raise AssertionError(f"{name} {key} disagrees with its plain "
                                         f"version at stage {stage + 1}, shift {shift}: max|Δ| "
                                         f"{err:.4g} vs max|plain| {top:.4g}")
            if float(got["dlogit_scale"].reshape(-1)[0]) != 0.0:
                raise AssertionError(f"{name}: gradient above the logit-scale clamp "
                                     f"{float(got['dlogit_scale'].reshape(-1)[0])}, not 0")
            log(f"  {name} stage {stage + 1} shift={shift}: every gradient within "
                f"its tolerance (max|Δ|/max|plain|: "
                f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}) ok")
            st["max_abs_err"] = max(float((got[k].float() - ref[k].float()).abs().max())
                                    for k in ("dq", "dk", "dv"))
            st["relative_errors"] = errs
            rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
        rec["stages"].append(st)
        del p, qkv, dout, z, q, k, v, g, out, leaves
        torch.cuda.empty_cache()
    finish_record(rec, timing)
    return rec


def fused_backward_cases(p):
    """(name, half, leaves, bytes, operations) of one stage's fused halves
    at TRAIN_BATCH, called as the model's block calls them: the MLP half and
    the NHWC attention half with image 0's drop-path scale 0 and image 1's
    1/keep, the windowed attention half (no residual) on the partitioned
    windows; head 0's logit scale above the log 100 clamp. Bytes: x and g
    read and dx written (bf16), the weights read (bf16), the gradients
    written (f32) and z read and dz written (f32)."""
    import torch

    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import window_attention as wa

    x, c, heads, grid, shift = p["x"], p["c"], p["heads"], p["grid"], p["shift"]
    tokens, n = x.shape[0] * grid * grid, WINDOW * WINDOW
    p["logit_scale"][0] = 5.0
    p["dp"][0], p["dp"][1] = 0.0, 1.0 / KEEP
    nwz = 1 if p["mask"] is None else p["mask"].shape[0]

    def mlp(xt, w1, b1, w2, b2, lns, lnb):
        return fh.mlp_half(xt, w1, b1, w2, b2, lns, lnb, tpi=grid * grid, dp=p["dp"])

    def attn(xm, wq, bq, ls, bias, wp, bp, lns, lnb):
        return fh.attention_half_nhwc(xm, wq, bq, ls, bias, p["mask"], wp, bp, lns, lnb, WINDOW,
                                      heads, dp=p["dp"], shift=shift)

    def windowed(xw, wq, bq, ls, bias, wp, bp, lns, lnb):
        return fh.attention_half(xw, wq, bq, ls, bias, p["mask"], wp, bp, lns, lnb, heads)

    io = 2 * 3 * tokens * c
    attn_params = [p[k] for k in ("wqkv", "bqkv", "logit_scale", "bias", "wproj", "bproj", "lns",
                                  "lnb")]
    attn_bytes = io + 2 * 4 * c * c + 4 * (4 * c * c + 6 * c) + 2 * 4 * nwz * heads * n * n
    xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    return [
        ("mlp_half_bwd", mlp,
         [x.reshape(tokens, c)] + [p[k] for k in ("w1", "b1", "w2", "b2", "lns", "lnb")],
         io + 2 * 8 * c * c + 4 * (8 * c * c + 7 * c), 48 * tokens * c * c),
        ("attention_half_nhwc_bwd", attn, [x] + attn_params, attn_bytes,
         (24 * c * c + 10 * n * c) * tokens),
        # the windows partitioned from the rolled map, as the model's block does
        ("attention_half_bwd", windowed, [wa.window_partition(xs, WINDOW)] + attn_params,
         attn_bytes, (24 * c * c + 10 * n * c) * tokens),
    ]


def fused_backward_records(timing: bool, stages=STAGES) -> dict:
    """The fused halves' backward kernels through their autograd Functions
    against the same Functions with the plain backward in the kernel's
    place, at every block shape of ``stages`` (check), or timed as the model
    runs them (``torch.autograd.grad`` through the Function, its set-up and
    tail included), the launch wrapper alone and the plain version. Per
    training step: the launches of each summed (12 of SwinV2-T's; SwinV2-B's
    stage-4 MLP halves train through the chunked MLP instead)."""
    import torch

    from hvt_torch.ops import fused_halves_cuda as fh
    from hvt_torch.ops import window_attention_cuda as wac

    records = {name: {"max_abs_err": 0.0, "bytes": 0, "flops": 0, "stages": []}
               for name in FUSED_GRADS}
    for stage, shift, blocks in block_shapes(stages):
        p = stage_inputs(stage, shift, seed=300 + 10 * stage + shift, batch=TRAIN_BATCH,
                         stages=stages)
        gen = torch.Generator("cuda").manual_seed(400 + 10 * stage + shift)
        for name, half, leaves, nbytes, flops in fused_backward_cases(p):
            n = blocks * train_launches(name, p["c"])
            if n == 0:
                continue
            rec = records[name]
            st = {"stage": stage + 1, "shift": shift, "launches_per_forward": n,
                  "bytes": nbytes, "flops": flops, "library_ms": None}
            rec["bytes"] += n * nbytes
            rec["flops"] += n * flops
            ls = [t.detach().clone().requires_grad_() for t in leaves]
            out = half(*ls)
            g = torch.randn(out.shape, device="cuda", generator=gen).bfloat16()
            if timing:
                model_bwd = lambda: torch.autograd.grad(out, ls, g, retain_graph=True)  # noqa: E731
                st["ms"] = cuda_time_ms(model_bwd, iters=10)
                z = wac.merge_bias_mask(p["bias"], p["mask"])
                scale = wac.attention_scale(p["logit_scale"])
                weights = (p["wqkv"], p["bqkv"], scale, z, p["wproj"], p["bproj"], p["lns"], g)
                if name == "mlp_half_bwd":
                    wrapper = lambda: fh.mlp_half_backward(  # noqa: E731
                        leaves[0], *leaves[1:6], g, tpi=p["grid"] ** 2, dp=p["dp"])
                elif name == "attention_half_bwd":
                    wrapper = lambda: fh.attention_half_backward(  # noqa: E731
                        leaves[0], *weights, p["heads"])
                else:
                    wrapper = lambda: fh.attention_half_nhwc_backward(  # noqa: E731
                        leaves[0], *weights, WINDOW, p["heads"], dp=p["dp"], shift=shift)
                st["wrapper_ms"] = cuda_time_ms(wrapper, iters=10)
                with plain_fused_backward():
                    st["plain_ms"] = cuda_time_ms(model_bwd, iters=3, warmup=1)
                if name in SPLIT_BWD and stages is STAGES:
                    st["host_ms"], st["device_ms"] = host_device_ms(model_bwd)
                    st["wrapper_host_ms"], st["wrapper_device_ms"] = host_device_ms(wrapper)
                    mlp = name == "mlp_half_bwd"
                    st["kernels_ms"] = kernel_split(wrapper, MLP_SUB_KERNELS, "mlp_half_bwd") \
                        if mlp else kernel_split(wrapper)
                    cs = [t.detach().clone().requires_grad_() for t in leaves]
                    c_out = (composite_mlp_half(p, True) if mlp else
                             composite_attention_half(p, name == "attention_half_bwd"))(*cs)
                    st["composite_ms"] = cuda_time_ms(
                        lambda: torch.autograd.grad(c_out, cs, g, retain_graph=True), iters=10)
                    del c_out, cs
            else:
                got = torch.autograd.grad(out, ls, g, retain_graph=True)
                torch.cuda.synchronize()
                with plain_fused_backward():
                    ref = torch.autograd.grad(out, ls, g)
                errs = {}
                for key, a, b in zip(FUSED_GRADS[name], got, ref):
                    a, b = a.float(), b.float()
                    err, top = float((a - b).abs().max()), float(b.abs().max())
                    errs[key] = err / top if top else err
                    if not (bool(torch.isfinite(a).all()) and err <= FUSED_BWD_TOL * top):
                        raise AssertionError(f"{name} {key} disagrees with its plain version at "
                                             f"stage {stage + 1}, shift {shift}: max|Δ| {err:.4g} "
                                             f"vs max|plain| {top:.4g}")
                if name != "mlp_half_bwd" and float(got[3].reshape(-1)[0]) != 0.0:
                    raise AssertionError(f"{name}: gradient above the logit-scale clamp "
                                         f"{float(got[3].reshape(-1)[0])}, not 0")
                worst = max(errs, key=errs.get)
                log(f"  {name:23s} stage {stage + 1} shift={shift}: every gradient within "
                    f"{FUSED_BWD_TOL}·max|plain| (worst {worst} {errs[worst]:.3g}·max|plain|; "
                    f"dx {errs['dx']:.3g}) ok")
                st["max_abs_err"] = float((got[0].float() - ref[0].float()).abs().max())
                st["relative_errors"] = errs
                rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
            rec["stages"].append(st)
            del out, ls, g
        del p
        torch.cuda.empty_cache()
    for name, rec in records.items():
        finish_record(rec, timing)
        if timing and name in SPLIT_BWD and stages is STAGES:
            rec["composite_ms"] = sum(st["launches_per_forward"] * st["composite_ms"]
                                      for st in rec["stages"])
            rec["kernels_ms"] = {}
            for st in rec["stages"]:
                for key, ms in st["kernels_ms"].items():
                    rec["kernels_ms"][key] = (rec["kernels_ms"].get(key, 0.0)
                                              + st["launches_per_forward"] * ms)
    return records


def chunked_records(timing: bool) -> dict:
    """The chunked MLP's two kernels at SwinV2-B's stage-4 shape in training
    (batch 128: T = 6,272, C = 1,024, K = CHUNKS): the forward's branch and
    pre-LN sum against ``mlp_half_chunked_plain``, and every gradient through
    the autograd Function against the same Function with the plain backward
    in the kernel's place (check); or each timed with its plain version, the
    backward as the model runs it and in its launch wrapper alone, per
    training step (2 blocks). Bytes: each input read and each output written
    once (x, pre, g, dx and the branch in bf16, the weights in bf16 as the
    kernels take them, the gradients in f32); operations 4·T·C·4C forward (fc1
    and fc2) and 10·T·C·4C backward (fc1 recomputed, dh, dx, dW1 and dW2: fc2
    is not recomputed, the saved pre stands in for it)."""
    import torch

    from hvt_torch.ops import fused_halves_cuda as fh

    grid, c, _, blocks = BASE_STAGES[3]
    p = stage_inputs(3, 0, seed=600, batch=TRAIN_BATCH, stages=BASE_STAGES)
    t = TRAIN_BATCH * grid * grid
    x = p["x"].reshape(t, c)
    args = [p[k] for k in ("w1", "b1", "w2", "b2", "lns", "lnb")]
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(601)).bfloat16()
    w_bytes = 2 * 8 * c * c
    cases = {
        "mlp_half_chunked_fwd": (3 * 2 * t * c + w_bytes + 4 * 7 * c, 16 * t * c * c),
        "mlp_half_chunked_bwd": (4 * 2 * t * c + w_bytes + 4 * (8 * c * c + 12 * c),
                                 40 * t * c * c),
    }
    records = {name: {"max_abs_err": 0.0, "bytes": blocks * nb, "flops": blocks * fl,
                      "stages": [{"stage": 4, "shift": 0, "launches_per_forward": blocks,
                                  "bytes": nb, "flops": fl, "library_ms": None}]}
               for name, (nb, fl) in cases.items()}
    fwd, bwd = (records[n]["stages"][0] for n in CHUNKED)
    leaves = [t_.detach().clone().requires_grad_() for t_ in [x] + args]
    out = fh.mlp_half_chunked(*leaves, CHUNKS)
    if timing:
        fwd_call = lambda: fh.mlp_half_chunked_forward(x, *args, CHUNKS)  # noqa: E731
        fwd["ms"] = cuda_time_ms(fwd_call)
        fwd["host_ms"], fwd["device_ms"] = host_device_ms(fwd_call)
        fwd["kernels_ms"] = kernel_split(fwd_call, MLP_FWD_SUB_KERNELS, "mlp_half_chunked_fwd")
        fwd["plain_ms"] = cuda_time_ms(lambda: fh.mlp_half_chunked_plain(x, *args, CHUNKS), iters=5)
        with torch.no_grad():
            fwd["composite_ms"] = cuda_time_ms(lambda: composite_mlp_half(p, False)(x, *args),
                                               iters=10)
        _, pre = fh.mlp_half_chunked_forward(x, *args, CHUNKS)
        model_bwd = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        bwd["ms"] = cuda_time_ms(model_bwd, iters=10)
        wrapper = lambda: fh.mlp_half_chunked_backward(  # noqa: E731
            x, p["w1"], p["b1"], p["w2"], p["lns"], pre, g, CHUNKS)
        bwd["wrapper_ms"] = cuda_time_ms(wrapper, iters=10)
        with plain_fused_backward():
            bwd["plain_ms"] = cuda_time_ms(model_bwd, iters=3, warmup=1)
        bwd["host_ms"], bwd["device_ms"] = host_device_ms(model_bwd)
        bwd["wrapper_host_ms"], bwd["wrapper_device_ms"] = host_device_ms(wrapper)
        bwd["kernels_ms"] = kernel_split(wrapper, MLP_SUB_KERNELS, "mlp_half_chunked_bwd")
        cs = [t_.detach().clone().requires_grad_() for t_ in [x] + args]
        c_out = composite_mlp_half(p, False)(*cs)
        bwd["composite_ms"] = cuda_time_ms(
            lambda: torch.autograd.grad(c_out, cs, g, retain_graph=True), iters=10)
        del c_out, cs
    else:
        got = fh.mlp_half_chunked_forward(x, *args, CHUNKS)
        torch.cuda.synchronize()
        ref = fh.mlp_half_chunked_plain(x, *args, CHUNKS)
        errs = {}
        for key, a, b in zip(("branch", "pre"), got, ref):
            err, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
            errs[key] = err / top
            if not (bool(torch.isfinite(a).all()) and err <= TOL["mlp_half_fwd"] * top):
                raise AssertionError(f"mlp_half_chunked_fwd {key} disagrees with its plain version: "
                                     f"max|Δ| {err:.4g} vs max|plain| {top:.4g}")
        fwd["max_abs_err"] = float((got[0].float() - ref[0].float()).abs().max())
        fwd["relative_errors"] = errs
        grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        with plain_fused_backward():
            ref = torch.autograd.grad(out, leaves, g)
        berrs = {}
        for key, a, b in zip(FUSED_GRADS["mlp_half_bwd"], grads, ref):
            err, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
            berrs[key] = err / top if top else err
            if not (bool(torch.isfinite(a).all()) and err <= FUSED_BWD_TOL * top):
                raise AssertionError(f"mlp_half_chunked_bwd {key} disagrees with its plain version: "
                                     f"max|Δ| {err:.4g} vs max|plain| {top:.4g}")
        bwd["max_abs_err"] = float((grads[0].float() - ref[0].float()).abs().max())
        bwd["relative_errors"] = berrs
        worst = max(berrs, key=berrs.get)
        log(f"  mlp_half_chunked stage 4 C={c} K={CHUNKS}: branch {errs['branch']:.3g}, pre "
            f"{errs['pre']:.3g}·max|plain| (tol {TOL['mlp_half_fwd']}); every gradient within "
            f"{FUSED_BWD_TOL}·max|plain| (worst {worst} {berrs[worst]:.3g}; dx {berrs['dx']:.3g}) ok")
    for name, rec in records.items():
        rec["max_abs_err"] = rec["stages"][0].get("max_abs_err", 0.0)
        finish_record(rec, timing)
    if timing:
        rec = records["mlp_half_chunked_fwd"]
        for key in ("composite_ms", "host_ms", "device_ms"):
            rec[key] = blocks * fwd[key]
        rec["kernels_ms"] = {k: blocks * ms for k, ms in fwd["kernels_ms"].items()}
        rec = records["mlp_half_chunked_bwd"]
        rec["composite_ms"] = blocks * bwd["composite_ms"]
        rec["kernels_ms"] = {k: blocks * ms for k, ms in bwd["kernels_ms"].items()}
    del p, x, g, out, leaves
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# Phase 4: the main path, one InferenceEngine per route
# ---------------------------------------------------------------------------


def serving_config(fuse: bool):
    """configs/pretrain/swinv2_tiny.yaml, the synthetic eval source at
    10,000 classes, and the route."""
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs/pretrain/swinv2_tiny.yaml")])
    return config_lib.loads(config_lib.to_dict(base), {
        "model": {"args": {"fuse": fuse}},
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": BATCH, "global_batch_size": BATCH},
    })


def randomize_(model, seed: int) -> None:
    """Draw every parameter from a seeded generator at a scale that keeps
    activations O(1): LayerNorm scales around 1 (the zero-initialised
    res-post-norm would make every block the identity), logit scales around
    log 10, weights N(0, 1/fan_in), biases N(0, 0.01); an MoE layer's router
    and experts likewise, so that its routing is not a near tie."""
    import torch
    import torch.nn as nn

    from hvt_torch.models.swinv2 import WindowAttention
    from hvt_torch.ops.moe import MoeMlp

    gen = torch.Generator().manual_seed(seed)

    def normal(p, mean=0.0, std=1.0):
        p.copy_(mean + std * torch.randn(p.shape, generator=gen))

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.LayerNorm):
                normal(module.weight, 1.0, 0.1)
                normal(module.bias, 0.0, 0.1)
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                normal(module.weight, 0.0, module.weight[0].numel() ** -0.5)
                if module.bias is not None:
                    normal(module.bias, 0.0, 0.1)
            elif isinstance(module, WindowAttention):
                normal(module.q_bias, 0.0, 0.1)
                normal(module.v_bias, 0.0, 0.1)
                normal(module.logit_scale, math.log(10.0), 0.3)
            elif isinstance(module, MoeMlp):  # the router, each expert's weights by fan-in
                normal(module.router, 0.0, module.router.shape[0] ** -0.5)
                normal(module.w1, 0.0, module.w1.shape[1] ** -0.5)
                normal(module.w2, 0.0, module.w2.shape[1] ** -0.5)
                normal(module.b1, 0.0, 0.1)
                normal(module.b2, 0.0, 0.1)


def ppm(seed: int, size: int = 256) -> bytes:
    import numpy as np

    pixels = np.random.default_rng(seed).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    return b"P6\n%d %d\n255\n" % (size, size) + pixels.tobytes()


def http(port: int, method: str, path: str, body: bytes | None = None) -> tuple[int, dict]:
    """One request on its own connection (http.client: urllib's first burst
    in a process pays a one-time stall of about a second per thread)."""
    conn = http_client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        reply = conn.getresponse()
        return reply.status, json.loads(reply.read())
    finally:
        conn.close()


def get(port: int, path: str) -> dict:
    code, payload = http(port, "GET", path)
    if code != 200:
        raise AssertionError(f"GET {path}: {code} {payload}")
    return payload


def check_record(code: int, rec: dict, k: int) -> None:
    if code != 200 or len(rec.get("class_ids", ())) != k:
        raise AssertionError(f"bad reply {code}: {rec}")
    if not all(0 <= i < CLASSES for i in rec["class_ids"]) or rec["probs"] != sorted(rec["probs"], reverse=True):
        raise AssertionError(f"bad top-k record: {rec}")


def serve_route(fuse: bool) -> dict:
    """Phase 4's main path on one SwinV2-T route (``serve_model``)."""
    route_kernels = [k for k, (_, _, f) in KERNELS.items() if f == fuse]
    return {"fuse": fuse, **serve_model(serving_config(fuse), f"fuse={fuse}",
                                        {k: 12 for k in route_kernels})}


def serve_model(config, label: str, per_forward: dict, draw=None, plain_records=False,
                timing=True) -> dict:
    """Drive a model's serving path through the entry points a user calls:
    InferenceEngine + make_server, HTTP requests, with every launch counter
    set to 0 just before and read just after (each kernel of
    ``per_forward`` launches that many times a forward, no other kernel);
    the whole model's logits held against the plain path; forward ms, the
    engine's img/s. ``draw(model, seed)`` draws the weights (``randomize_``
    by default). With ``plain_records`` the first requests' served records
    are held against the engine's records of the same images on the plain
    path (``records_check``); without ``timing`` no forward or engine step
    is timed after the checks."""
    import numpy as np
    import torch

    from hvt_torch.data import DevicePrep
    from hvt_torch.downstream import serve as serve_lib

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    engine = serve_lib.InferenceEngine(config, batch=BATCH, topk=5)
    setup_s = time.perf_counter() - t0
    (draw or randomize_)(engine.model, seed=7)
    server = serve_lib.make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with ThreadPoolExecutor(REQUESTS) as pool:
            replies = list(pool.map(lambda i: http(port, "POST", "/predict?topk=5", ppm(i)),
                                    range(REQUESTS)))
        for code, rec in replies:
            check_record(code, rec, 5)
        burst = 2 * BATCH  # 32 closed-loop clients: served images/s and latency over HTTP
        bodies = [ppm(1000 + i) for i in range(burst)]

        def timed_post(body):
            t = time.perf_counter()
            reply = http(port, "POST", "/predict", body)
            return reply, time.perf_counter() - t

        with ThreadPoolExecutor(32) as pool:
            t0 = time.perf_counter()
            timed = list(pool.map(timed_post, bodies))
            http_s = time.perf_counter() - t0
        for (code, rec), _ in timed:
            check_record(code, rec, 5)
        latency_ms = sorted(1e3 * dt for _, dt in timed)
        health, stats = get(port, "/healthz"), get(port, "/stats")
    finally:
        server.shutdown()
        server.server_close()
    launches = {name: c.launches for name, c in counters.items()}
    records = records_check(engine, [rec for _, rec in replies], label) if plain_records else None
    forwards = 1 + stats["dispatches"]  # the engine's warm-up forward, then one per dispatch
    log(f"  {label}: {REQUESTS} + {burst} requests answered 200 with top-5 records; "
        f"{stats['dispatches']} dispatches, mean rows {stats['mean_rows_per_dispatch']}; "
        f"launches {launches} over {forwards} forwards")
    if health["classes"] != CLASSES or stats["requests"] != REQUESTS + burst or stats["errors"]:
        raise AssertionError(f"healthz {health} / stats {stats}")
    for name, n in launches.items():
        want = per_forward.get(name, 0) * forwards
        if n != want:
            raise AssertionError(f"{name}: {n} launches on the {label} route, expected {want}")

    # the whole model, kernel path against plain path, on the same weights and batch
    crop = config.eval_dataset.crop_size
    images = np.random.default_rng(11).integers(0, 256, size=(BATCH, crop, crop, 3), dtype=np.uint8)
    norm = DevicePrep.from_config(engine.config.eval_dataset, engine.config.precision)
    experts, flips = {}, {}  # the plain path on the kernel path's routing (MoE layers only)
    with torch.inference_mode():
        x = norm.normalize(torch.from_numpy(images).cuda())
        with recorded_routing(engine.model, experts, flips):
            got = engine.model(x).float()
        with plain_versions(), recorded_routing(engine.model, experts, flips):
            ref = engine.model(x).float()
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOP1_MARGIN
        same = got.argmax(-1) == ref.argmax(-1)
        agree = int((same & decided).sum())
        log(f"  {label}: logits kernel vs plain path max|Δ| {err:.4g} "
            f"(tol {LOGIT_TOL}·max|plain| = {LOGIT_TOL * scale:.4g}); top-1 equal on "
            f"{agree}/{int(decided.sum())} rows with top-2 margin > {TOP1_MARGIN} "
            f"({int(same.sum())}/{BATCH} overall)"
            + (f"; the plain path on the kernel path's routing, its own argmax routing "
               f"elsewhere {flips}" if flips else ""))
        if not (bool(torch.isfinite(got).all()) and err <= LOGIT_TOL * scale
                and agree == int(decided.sum())):
            raise AssertionError(f"{label}: kernel-path logits disagree with the plain path")

        # forward time on the card and images/s through the engine (phase 5 for a route)
        fwd_ms = fwd_plain_ms = step_s = math.nan
        if timing:
            fwd_ms = cuda_time_ms(lambda: engine.model(x), iters=10)
            with plain_versions():
                fwd_plain_ms = cuda_time_ms(lambda: engine.model(x), iters=5, warmup=1)
    if timing:
        for _ in range(2):
            engine._step(images)
        t0 = time.perf_counter()
        steps = 10
        for _ in range(steps):
            engine._step(images)  # returns host numpy: ends in a synchronize
        step_s = (time.perf_counter() - t0) / steps
    engine.close()
    del engine
    torch.cuda.empty_cache()
    return {
        "launches": launches, "forwards": forwards, "requests": REQUESTS + burst,
        "dispatches": stats["dispatches"], "engine_setup_s": setup_s,
        "http_images_per_s": burst / http_s, "http_clients": 32,
        "http_latency_ms_p50": latency_ms[len(latency_ms) // 2],
        "http_latency_ms_p90": latency_ms[int(0.9 * len(latency_ms))],
        "step_images_per_s": BATCH / step_s,
        "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
        "logits_max_abs_err": err, "logits_max_abs": scale,
        "top1_equal": int(same.sum()), "top1_decided": int(decided.sum()),
        "records": records,
    }


def records_check(engine, served: list, label: str) -> dict:
    """The engine's records of the first len(``served``) request images
    (``ppm(i)``, decoded as ``predict_image`` decodes them, top-5) from one
    step of the engine on the plain path, on the routing the kernel path
    takes on the same batch (``recorded_routing``: MoE layers only; see
    ``moe_gradient_check``), against the served ones: each record's classes
    up to its first pair of probabilities closer than TOP1_MARGIN of the
    largest (a closer pair may swap on a bf16 rounding) in the same order,
    and every probability within RECORD_PROB_TOL of the largest."""
    import io

    import numpy as np
    from PIL import Image

    from hvt_torch.downstream import predict as predict_lib

    images = np.zeros((engine.batch, engine._crop, engine._crop, 3), np.uint8)
    for i in range(len(served)):
        with Image.open(io.BytesIO(ppm(i))) as img:
            images[i] = engine.transform(img.convert("RGB"))
    experts, flips = {}, {}
    with recorded_routing(engine.model, experts, flips):
        engine._step(images)
    with plain_versions(), recorded_routing(engine.model, experts, flips):
        out = engine._step(images)
    plain = [predict_lib.topk_record(engine.classes, i, *out, 5) for i in range(len(served))]
    held = []
    for got, ref in zip(served, plain):
        p = ref["probs"]
        # the classes before the first close pair (the fifth may swap with the unseen sixth)
        n = next((j for j in range(len(p) - 1) if (p[j] - p[j + 1]) / p[0] <= TOP1_MARGIN),
                 len(p) - 1)
        if got["class_ids"][:n] != ref["class_ids"][:n] or max(
                abs(a - b) for a, b in zip(got["probs"], p)) > RECORD_PROB_TOL * p[0]:
            raise AssertionError(f"{label}: served record {got} against the plain path's {ref}")
        held.append(n)
    identical = sum(g["class_ids"] == r["class_ids"] for g, r in zip(served, plain))
    log(f"  {label}: served records against the engine's plain path: classes held in order up "
        f"to the first close pair ({held} of 5 a record), probabilities within "
        f"{RECORD_PROB_TOL} of the largest; {identical}/{len(served)} records identical in "
        f"their five classes; tokens the plain path's own argmax routes elsewhere {flips}")
    return {"requests": len(served), "classes_held": held, "identical": identical,
            "routed_apart": flips}


def profile_route(fuse: bool) -> list:
    """Device time by kernel name over 3 forwards of the route (--profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hvt_torch.downstream import serve as serve_lib

    engine = serve_lib.InferenceEngine(serving_config(fuse), batch=BATCH, topk=5)
    randomize_(engine.model, seed=7)
    x = torch.randn(BATCH, 224, 224, 3, device="cuda").bfloat16()
    with torch.inference_mode():
        engine.model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                engine.model(x)
            torch.cuda.synchronize()
    engine.close()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append({"name": e.key[:90], "calls": e.count // 3, "ms_per_forward": dev_us / 3e3})
    rows.sort(key=lambda r: -r["ms_per_forward"])
    return rows


def retired_op_run() -> dict:
    """Phase 12: hvt's retired fused halves (``swin_block_cuda``) as their
    caller composes them (hvt/ops/swin_block_pallas.py's docstring): per
    block, the map rolled by -shift, the attention branch rolled back and
    added, then the MLP branch added; each of SwinV2-T's 7 block shapes at
    batch BATCH chains its blocks (12 in all) on the residual stream, in f32
    and in bf16 (x and every weight). The launch counts are zeroed just
    before and read just after: 12 of each branch per dtype and none of any
    other kernel. Each shape's stream is held against the same chain on the
    plain versions (TOL of the branch in that dtype). The chains then run
    once more under torch.profiler: every device kernel of the hvt library
    they launch must be one of RETIRED_DEVICE_KERNELS."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hvt_torch.ops import swin_block_cuda as sbc
    from hvt_torch.ops import window_attention_cuda as wac

    def chain(p, dt, blocks, attention, mlp):
        shift, heads = p["shift"], p["heads"]
        w = {k: p[k].to(dt) for k in ("wqkv", "wproj", "w1", "w2")}
        scale = wac.attention_scale(p["logit_scale"]).reshape(heads, 1, 1)
        z = wac.merge_bias_mask(p["bias"], p["mask"])
        x = p["x"].to(dt)
        for _ in range(blocks):
            xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
            a = attention(xs, w["wqkv"], p["bqkv"], scale, z, w["wproj"], p["bproj"], p["lns"],
                          p["lnb"], window=WINDOW, num_heads=heads)
            x = x + (torch.roll(a, (shift, shift), (1, 2)) if shift else a)
            x = x + mlp(x, w["w1"], p["b1"], w["w2"], p["b2"], p["lns"], p["lnb"])
        return x

    counters = kernel_counters()
    shapes = [(stage, shift, blocks, stage_inputs(stage, shift, seed=900 + 10 * stage + shift))
              for stage, shift, blocks in block_shapes()]
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = [(dt, stage, shift, blocks, p, chain(p, dt, blocks, sbc.fused_attention_branch,
                                                    sbc.fused_mlp_branch))
                for dt in (torch.float32, torch.bfloat16)
                for stage, shift, blocks, p in shapes]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    log(f"  launches: {launches} in {seconds:.2f} s")
    want = {name: 24 if name in RETIRED else 0 for name in counters}
    if launches != want:
        raise AssertionError(f"the retired halves' run launched {launches}, not {want}")
    stages = []
    for dt, stage, shift, blocks, p, got in outs:
        ref = chain(p, dt, blocks, sbc.fused_attention_branch_plain, sbc.fused_mlp_branch_plain)
        tol = max(TOL[name + ("_bf16" if dt == torch.bfloat16 else "")] for name in RETIRED)
        err, scale = float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())
        ok = bool(torch.isfinite(got).all()) and got.shape == ref.shape and err <= tol * scale
        log(f"  stage {stage + 1} shift {shift} x{blocks} {dt}: max|kernel-plain| {err:.4g} "
            f"(tol {tol}·max|plain| = {tol * scale:.4g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the retired halves' chain disagrees with the plain chain at "
                                 f"stage {stage + 1}, shift {shift}, {dt}")
        stages.append({"stage": stage + 1, "shift": shift, "blocks": blocks, "dtype": str(dt),
                       "max_abs_err": err})
    # the same chains once more under the profiler: the device kernels the
    # branches ran, none of them an FFMA product or the CUDA-core core
    # (attention_fwd_kernel, which SwinV2's head dim 32 and N = 49 never take)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for dt, stage, shift, blocks, p, _ in outs:
            chain(p, dt, blocks, sbc.fused_attention_branch, sbc.fused_mlp_branch)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        name = re.search(r"hvt::(\w+)", e.key)
        if name:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            kernels[name.group(1)] = kernels.get(name.group(1), 0.0) + us / 1e3
    stray = sorted(set(kernels) - set(RETIRED_DEVICE_KERNELS))
    if stray:
        raise AssertionError(f"the retired halves' chain ran {stray}, not only "
                             f"{RETIRED_DEVICE_KERNELS}")
    return {"launches": {name: launches[name] for name in RETIRED}, "seconds": seconds,
            "stages": stages, "device_kernels_ms": kernels}


# ---------------------------------------------------------------------------
# Phase 7: the training path
# ---------------------------------------------------------------------------


def training_config(name: str = "swinv2_tiny", grad_accum=1, steps: int = TRAIN_STEPS,
                    **model_args):
    """configs/pretrain/swinv2_tiny.yaml (adamw at lr 1e-3, wd 0.05, cosine
    schedule, smoothing 0.1, clip 5.0, drop path 0.2, fuse unset, grad_accum
    1) with model ``name`` on the synthetic train source at 10,000 classes,
    batch TRAIN_BATCH, for ``steps`` steps with a 5-step warmup; evaluated
    (one synthetic batch of TRAIN_BATCH) before the first step and after the
    last (``eval_interval: 1dur``), outside the timed steps."""
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs/pretrain/swinv2_tiny.yaml")])
    return config_lib.loads(config_lib.to_dict(base), {
        "max_duration": f"{steps}ba",
        "eval_interval": "1dur",
        "machine": {"save_root": str(runs_root())},
        "save": {"wandb": False},  # the card's machine has the wandb package, and no network
        "grad_accum": grad_accum,
        "scheduler": {"args": {"t_warmup": "5ba"}},
        "model": {"name": name, "args": model_args},
        "train_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                          "synthetic_num_samples": TRAIN_BATCH * steps,
                          "global_batch_size": TRAIN_BATCH},
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": TRAIN_BATCH, "global_batch_size": TRAIN_BATCH},
    })


def split_op_run() -> dict:
    """Phase 11 (d): hvt's op on split q, k, v as a user calls it,
    ``hvt_torch.ops.window_attention.window_attention``, forward and backward
    once for each of SwinV2-T's 12 blocks at batch TRAIN_BATCH (q, k, v split
    from the block's projection, its bias and shift mask), with every launch
    counter set to 0 just before and read just after: 12 launches of each
    split kernel, none of any other; finite outputs and gradients."""
    import torch

    from hvt_torch.ops import window_attention as wa

    counters = kernel_counters()
    cases = []
    for stage, shift, blocks in block_shapes():
        p = stage_inputs(stage, shift, seed=800 + 10 * stage + shift, batch=TRAIN_BATCH)
        qkv, dout, _, _ = backward_case(p)
        q, k, v = (t.contiguous() for t in wa.split_heads(qkv, p["heads"]))
        g = dout.reshape(q.shape[0], q.shape[2], p["heads"], -1).transpose(1, 2).contiguous()
        cases.append((blocks, [q, k, v, p["logit_scale"], p["bias"]], p["mask"], g))
        del p, qkv, dout
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    for blocks, tensors, mask, g in cases:
        for _ in range(blocks):
            leaves = [t.clone().requires_grad_() for t in tensors]
            out = wa.window_attention(*leaves, mask)
            out.backward(g)
            if out.shape != g.shape or not all(bool(torch.isfinite(t).all()) for t in
                                               [out] + [x.grad for x in leaves]):
                raise AssertionError(f"window_attention: output {tuple(out.shape)} or its "
                                     "gradients not finite")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    log(f"  window_attention (split q, k, v) forward and backward at SwinV2-T's 12 block shapes, "
        f"batch {TRAIN_BATCH}: launches { {k: v for k, v in launches.items() if v} }, "
        f"{wall_s:.2f} s")
    for name, n in launches.items():
        if n != (12 if name in SPLIT else 0):
            raise AssertionError(f"{name}: {n} launches driving window_attention, expected "
                                 f"{12 if name in SPLIT else 0}")
    del cases
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall_s}


def train_run(config, per_step: dict, label: str, eval_per_forward: dict):
    """Drive a training path through the entry point a user calls:
    hvt_torch.main.main(config), with every launch counter set to 0 just
    before and read just after; each kernel of ``per_step`` must launch that
    many times a step, and each of ``eval_per_forward`` that many times a
    batch of the two evaluations (before the first step and after the last),
    every other kernel never. With grad_accum auto the Trainer's memory
    probe, one forward and backward at the batch, launches as one more
    step. A CUDA event after each step times it; the losses are read back
    after the run. Returns the record and the Trainer that ran."""
    import torch

    from hvt_torch import main as main_lib

    counters = kernel_counters()
    events, losses, trainers, evals = [], [], [], []

    class RecordingTrainer(main_lib.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

        def _evaluate_at(self, step):
            evals.append(step)
            return super()._evaluate_at(step)

    def on_step(step, stats):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(stats["loss_sum"])

    steps = int(config.max_duration.removesuffix("ba"))
    batch = config.train_dataset.global_batch_size
    gc.collect()  # what earlier phases left in reference cycles is not this run's
    torch.cuda.empty_cache()
    start_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with swapped(main_lib, Trainer=RecordingTrainer), trainer_output():
        metrics = main_lib.main(config, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    clear_runs()
    launches = {name: c.launches for name, c in counters.items()}
    losses = [float(v) for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]  # step 2 onwards
    steady = sorted(step_ms[4:])  # the steps after the first 5
    median_ms = steady[len(steady) // 2]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label}: {len(losses)} steps: loss {losses[0]:.4f} → {losses[-1]:.4f}; step {median_ms:.2f} ms "
        f"median after the first 5 ({batch / median_ms * 1e3:.1f} img/s); launches "
        f"{ {k: v for k, v in launches.items() if v} }; peak memory {peak_gib:.2f} GiB "
        f"({start_gib:.2f} allocated before the run); {wall_s:.1f} s in all")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: training losses {losses}")
    probes = 1 if config.grad_accum == "auto" else 0
    eval_batches = len(evals) * trainers[0].eval_loader.batches_per_epoch
    if evals != [0, steps]:
        raise AssertionError(f"{label}: evaluations at steps {evals}, expected [0, {steps}]")
    for name, n in launches.items():
        want = (per_step.get(name, 0) * (steps + probes)
                + eval_per_forward.get(name, 0) * eval_batches)
        if n != want:
            raise AssertionError(f"{name}: {n} launches in {steps} training steps "
                                 f"(+{probes} probe) and {eval_batches} eval batches of {label}, "
                                 f"expected {want}")
    return {"label": label, "steps": steps, "batch": batch, "launches": launches,
            "eval_steps": evals, "eval_batches": eval_batches,
            "probes": probes, "grad_accum": trainers[0].grad_accum, "losses": losses,
            "step_ms": step_ms, "step_ms_median": median_ms,
            "images_per_s": batch / median_ms * 1e3, "wall_s": wall_s,
            "peak_memory_gib": peak_gib, "start_memory_gib": start_gib, "metrics": metrics}, trainers[0]


def train_batch(seed: int, batch: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(batch, 224, 224, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, size=batch)
    return (torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
            torch.ones(batch, device="cuda"))


def gradient_check(config, label: str, randomize: bool = True, hold_gradients: bool = True,
                   path=contextlib.nullcontext, prepare=None) -> dict:
    """One step's loss and parameter gradients from the same seeded weights
    and batch on the kernel path (or under ``path()``) and on the plain path,
    with cuDNN deterministic so that only the kernels tell the paths apart;
    ``randomize`` draws every SwinV2 parameter (its res-post-norm starts at
    zero). Without ``hold_gradients`` only the loss is held and the
    gradients' agreement is recorded. ``prepare(images, labels)`` → (model
    input, targets), computed once for both paths, stands in for
    normalize and the smoothed targets (phase 15: the train step's
    augmentations with fixed draws)."""
    import torch

    from hvt_torch import objectives
    from hvt_torch.data import DevicePrep
    from hvt_torch.data import device as device_prep
    from hvt_torch.models import build_model
    from hvt_torch.train import algorithms

    model = build_model(config, CLASSES).cuda().train()
    if randomize:
        randomize_(model, seed=13)
    prep = DevicePrep.from_config(config.train_dataset, config.precision)
    smoothing = algorithms.parse_algorithms(config).label_smoothing
    images, labels, mask = train_batch(17, config.train_dataset.global_batch_size)
    if prepare is None:
        x, targets = prep.normalize(images), device_prep.prepare_targets(labels, CLASSES, smoothing)
    else:
        x, targets = prepare(images, labels)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = objectives.soft_cross_entropy(model(x), targets, mask)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone() for n, p in model.named_parameters()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with path():
            loss, grads = loss_and_grads()
        with plain_versions():
            ref_loss, ref = loss_and_grads()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"  {label}: loss {loss:.6f}, plain path {ref_loss:.6f}")
    if abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss):
        raise AssertionError(f"{label}: kernel-path loss {loss} vs the plain path's {ref_loss}")
    held = compare_gradients(grads, ref, label, GRAD_COSINE if hold_gradients else -1.0,
                             GRAD_NORM_RTOL if hold_gradients else math.inf)
    del model, grads, ref
    torch.cuda.empty_cache()
    return {"dtype": config.precision.compute_dtype, "gradients_held": hold_gradients,
            "loss": loss, "plain_loss": ref_loss, **held}


def compare_gradients(grads: dict, ref: dict, label: str, cosine: float,
                      norm_rtol: float = GRAD_NORM_RTOL, zero=()) -> dict:
    """Each tensor's cosine and norm ratio against ``ref``; raises where a
    cosine falls below ``cosine`` or a norm ratio strays past ``norm_rtol``
    (-1 and inf record without holding). The tensors named in ``zero``,
    whose gradient is 0 in exact arithmetic, are rounding noise on both
    sides: each must stay within ZERO_GRAD_TOL of the largest gradient."""
    noise = 0.0
    if zero:
        top = max(float(r.abs().max()) for r in ref.values())
        noise = max(float(t[n].abs().max()) / top for n in zero for t in (grads, ref))
    if noise > ZERO_GRAD_TOL:
        raise AssertionError(f"{label}: a gradient that is 0 in exact arithmetic reaches "
                             f"{noise:.3g} of the largest")
    rows = []
    for name, g in grads.items():
        if name in zero:
            continue
        r = ref[name]
        cos = float((g * r).sum() / (g.norm() * r.norm()).clamp_min(1e-30))
        rows.append((cos, float(g.norm() / r.norm().clamp_min(1e-30)), name))
    worst = min(rows)
    worst_norm = max(rows, key=lambda row: abs(row[1] - 1.0))
    bad = [r for r in rows if r[0] < cosine or abs(r[1] - 1.0) > norm_rtol]
    log(f"    {label}: {len(rows)} gradient tensors, worst cosine {worst[0]:.6f} ({worst[2]}), "
        f"worst norm ratio {worst_norm[1]:.5f} ({worst_norm[2]})")
    if bad:
        raise AssertionError(f"{label}: gradients disagree: {bad[:5]}")
    return {"tensors": len(rows), "worst_cosine": worst[0], "worst_cosine_tensor": worst[2],
            "worst_norm_ratio": worst_norm[1], "worst_norm_tensor": worst_norm[2],
            "zero_tensors": len(zero), "zero_noise": noise}


def profile_train_step(config, names: dict) -> dict:
    """Device time by kernel over one training step of ``config`` (--profile),
    after two warm-up steps, through the Trainer's own step; ``names`` picks
    the backward and forward kernels' rows. Only kernel rows are summed: an
    operator's row repeats the time of the kernels it launched, and a user
    annotation's (``Optimizer.step#...``) the time it spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hvt_torch.train.loop import Trainer

    with trainer_output():
        trainer = Trainer(config)
    trainer.close()  # only its train step runs here
    clear_runs()
    batch = next(trainer.train_loader.epoch(0))
    for _ in range(2):
        trainer.train_step(*trainer._to_device(batch), trainer.generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(*trainer._to_device(batch), trainer.generator)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    rows, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        annotation = getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer.")
        if dev_us > 0:
            kernel = str(e.device_type).endswith("CUDA") and not annotation
            (rows if kernel else ops).append(
                {"name": e.key[:90], "calls": e.count, "ms_per_step": dev_us / 1e3})
    rows.sort(key=lambda r: -r["ms_per_step"])
    ops.sort(key=lambda r: -r["ms_per_step"])
    total = sum(r["ms_per_step"] for r in rows)
    bwd = sum(r["ms_per_step"] for r in rows if any(k in r["name"] for k in names["backward"]))
    fwd = sum(r["ms_per_step"] for r in rows if any(k in r["name"] for k in names["forward"]))
    optimizer = optimizer_times(trainer.optimizer)
    del trainer
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "device_ms": total, "busy_share": total / step_ms,
            "backward_kernel_ms": bwd, "forward_kernel_ms": fwd,
            "backward_kernel_share": bwd / total if total else None, "optimizer": optimizer,
            "rows": rows, "ops": ops}


def optimizer_times(opt, iters: int = 5) -> dict:
    """The optimizer's update alone, on the gradients the last step left,
    from an idle card: host ms of ``step()``, the device span from its first
    launch to its last kernel's end (CUDA events), and the kernel time in it
    (torch.profiler), each the median of ``iters`` updates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host, span, kernel = [], [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        opt.step()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        span.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt.step()
            torch.cuda.synchronize()
        kernel.append(sum(
            (getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)) / 1e3
            for e in prof.key_averages()
            if not (getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer."))))
    median = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {"host_ms": median(host), "span_ms": median(span), "kernel_ms": median(kernel)}


# ---------------------------------------------------------------------------
# Phase 8: the BatchNorm reduction kernels at ResNet-50's shapes
# ---------------------------------------------------------------------------


def bn_inputs(grid: int, c: int, seed: int, batch: int = RESNET_BATCH):
    """x and g (rows, C) bf16, the (rows, C) views of NHWC maps at
    ``batch``, x with channel means away from 0; scale ~ U(0, 1) as hvt's
    init draws it, and a drawn bias."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    rows = batch * grid * grid
    x = torch.randn(rows, c, device="cuda", generator=gen).mul_(1.5).add_(
        torch.randn(c, device="cuda", generator=gen)).bfloat16()
    g = torch.randn(rows, c, device="cuda", generator=gen).bfloat16()
    scale = torch.rand(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
    return x, g, scale, bias


def sums_error(got, terms, what: str) -> float:
    """max over channels of |got − Σ terms| / Σ|terms|, the sums in f64; raises
    beyond BN_SUM_TOL."""
    import torch

    ref, mag = terms.sum(0), terms.abs().sum(0)
    rel = float(((got.double() - ref).abs() / mag.clamp_min(1e-300)).max())
    if not (bool(torch.isfinite(got).all()) and rel <= BN_SUM_TOL):
        raise AssertionError(f"{what}: |kernel − f64| / Σ|terms| = {rel:.3g} > {BN_SUM_TOL}")
    return rel


def bn_train_check(x, g, scale, bias, what: str) -> dict:
    """bn_train's forward and backward through the kernels against the same
    Function with the plain reductions, on the same inputs."""
    import torch

    from hvt_torch.ops import bn_stats

    def run():
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y, _, _ = bn_stats.bn_train(*leaves, 1e-5, torch.bfloat16)
        y.backward(g)
        return y.detach(), *(t.grad for t in leaves)

    got = run()
    torch.cuda.synchronize()
    with plain_bn_steps():
        ref = run()
    errs = {}
    for name, a, b in zip(("y", "dx"), got[:2], ref[:2]):
        err, top = float((a.float() - b.float()).abs().max()), float(b.float().abs().max())
        errs[name] = err / top
        if not (bool(torch.isfinite(a).all()) and err <= BN_BF16_TOL * top):
            raise AssertionError(f"bn_train {name} {what}: max|Δ| {err:.4g} > {BN_BF16_TOL}·{top:.4g}")
    # dscale = Σg·x̂, dbias = Σg: each side an f32 sum within BN_SUM_TOL of the exact
    xh = (x.double() - x.double().mean(0)) / x.double().var(0, unbiased=False).add(1e-5).sqrt()
    for name, a, b, mag in zip(("dscale", "dbias"), got[2:], ref[2:],
                               ((g.double() * xh).abs().sum(0), g.double().abs().sum(0))):
        rel = float(((a.double() - b.double()).abs() / mag).max())
        errs[name] = rel
        if rel > 2 * BN_SUM_TOL:
            raise AssertionError(f"bn_train {name} {what}: |Δ| / Σ|terms| = {rel:.3g}")
    return errs


def bn_cases(x, g, scale, bias, batch: int, grid: int) -> dict:
    """bn_train's four calls on one shape: {name: (kernel call, plain call,
    library call, bytes, operations)}, the bytes each must move (each input
    read once, each output written once) and its f32 operations. The
    library calls are torch's SyncBatchNorm pieces on the channels-last
    view: batch_norm_stats, batch_norm_elemt, batch_norm_backward_reduce,
    batch_norm_backward_elemt."""
    import torch

    from hvt_torch.ops import bn_stats

    rows, c = x.shape
    mean, _, rstd = bn_stats.bn_moments(x, 1e-5)
    terms = bn_stats.bn_bwd_terms(g, x, mean, rstd, scale)
    sg, sgx = terms[0], terms[1]
    x4 = x.view(batch, grid, grid, c).permute(0, 3, 1, 2)  # channels-last views
    g4 = g.view(batch, grid, grid, c).permute(0, 3, 1, 2)
    count = torch.full((1,), rows, dtype=torch.int32, device="cuda")
    sgxmu = sgx / rstd  # Σg·(x − mean), the library's second sum
    mc = rows * c
    return {
        "bn_channel_sums": (lambda: bn_stats.bn_moments(x, 1e-5),
                            lambda: bn_stats.bn_moments_plain(x, 1e-5),
                            lambda: torch.batch_norm_stats(x4, 1e-5), 2 * mc + 20 * c, 3 * mc),
        "bn_normalize": (lambda: bn_stats.bn_normalize(x, mean, rstd, scale, bias, torch.bfloat16),
                         lambda: bn_stats.bn_normalize_plain(x, mean, rstd, scale, bias,
                                                             torch.bfloat16),
                         lambda: torch.batch_norm_elemt(x4, scale, bias, mean, rstd, 1e-5),
                         4 * mc + 16 * c, 4 * mc),
        "bn_bwd_reduce": (lambda: bn_stats.bn_bwd_terms(g, x, mean, rstd, scale),
                          lambda: bn_stats.bn_bwd_terms_plain(g, x, mean, rstd, scale),
                          lambda: torch.batch_norm_backward_reduce(g4, x4, mean, rstd, scale, True,
                                                                   True, True),
                          4 * mc + 32 * c, 5 * mc),
        "bn_dx": (lambda: bn_stats.bn_dx(g, x, mean, rstd, terms),
                  lambda: bn_stats.bn_dx_plain(g, x, mean, rstd, terms),
                  lambda: torch.batch_norm_backward_elemt(g4, x4, mean, rstd, scale, sg, sgxmu,
                                                          count),
                  6 * mc + 20 * c, 7 * mc),
    }


def bn_check(name: str, x, g, scale, bias, what: str) -> tuple[float, float | None]:
    """One call against its plain version: the reductions' sums against f64
    sums of the same inputs (BN_SUM_TOL·Σ|terms|) and their finishes against
    the plain formulas on those sums (BN_FINISH_TOL·max|plain|); the passes
    bit-equal to their plain versions on the same per-channel vectors.
    Returns (max|kernel − plain| of the sums or the pass's output, the sums'
    worst |Δ|/Σ|terms| against f64 or None)."""
    import torch

    from hvt_torch.ops import bn_stats

    rows = x.shape[0]
    mean, var, rstd = bn_stats.bn_moments(x, 1e-5)
    xd = x.double()
    if name == "bn_channel_sums":
        s, q = bn_stats.channel_sums(x)
        rel = max(sums_error(a, t, f"{name} {what}") for a, t in zip((s, q), (xd, xd * xd)))
        ref_mean = s / rows
        ref_var = torch.clamp_min(q / rows - ref_mean * ref_mean, 0.0)
        finish = {"mean": (mean, ref_mean), "var": (var, ref_var),
                  "rstd": (rstd, torch.rsqrt(ref_var + 1e-5))}
        plain = bn_stats.channel_sums_plain(x)
        err = max(float((a - b).abs().max()) for a, b in zip((s, q), plain))
    elif name == "bn_bwd_reduce":
        sg, sgx, k, m1, m2 = bn_stats.bn_bwd_terms(g, x, mean, rstd, scale)  # the (5, C) rows
        gd = g.double()
        terms = (gd, gd * ((xd - mean.double()) * rstd.double()))
        rel = max(sums_error(a, t, f"{name} {what}") for a, t in zip((sg, sgx), terms))
        finish = {"scale·rstd": (k, scale * rstd), "Σg/n": (m1, sg / rows),
                  "Σg·x̂/n": (m2, sgx / rows)}
        plain = bn_stats.bn_bwd_reduce_plain(g, x, mean, rstd)
        err = max(float((a - b).abs().max()) for a, b in zip((sg, sgx), plain))
    else:
        if name == "bn_normalize":
            got = bn_stats.bn_normalize(x, mean, rstd, scale, bias, torch.bfloat16)
            ref = bn_stats.bn_normalize_plain(x, mean, rstd, scale, bias, torch.bfloat16)
        else:
            terms = bn_stats.bn_bwd_terms(g, x, mean, rstd, scale)
            got = bn_stats.bn_dx(g, x, mean, rstd, terms)
            ref = bn_stats.bn_dx_plain(g, x, mean, rstd, terms)
        err = float((got.float() - ref.float()).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} {what}: not bit-equal to its plain version "
                                 f"(max|Δ| {err:.3g})")
        return err, None
    for key, (a, b) in finish.items():
        gap, top = float((a - b).abs().max()), float(b.abs().max())
        if not (bool(torch.isfinite(a).all()) and gap <= BN_FINISH_TOL * top):
            raise AssertionError(f"{name} {what}: {key} max|Δ| {gap:.3g} > "
                                 f"{BN_FINISH_TOL}·{top:.3g}")
    return err, rel


def bn_records(timing: bool, shapes=RESNET_BN_SHAPES, batch: int = RESNET_BATCH,
               host: bool = False, plain_iters: int = 5) -> dict:
    """bn_train's four calls at every ResNet-50 BatchNorm shape (``shapes``:
    (H = W, channels, layers); 224 px by default) at ``batch``: checked
    (bn_check, and bn_train against the plain path), or timed with their
    plain versions (``plain_iters`` calls each) and library calls, and with
    ``host`` each call's host ms and device ms from an idle card
    (host_device_ms). Per training step: each shape's launches summed."""
    import torch

    records = {name: {"max_abs_err": 0.0, "bytes": 0, "flops": 0, "stages": []}
               for name in BN_KERNELS}
    for i, (grid, c, layers) in enumerate(shapes):
        x, g, scale, bias = bn_inputs(grid, c, seed=500 + i, batch=batch)
        rows = x.shape[0]
        for name, (kern, plain, library, nbytes, flops) in bn_cases(x, g, scale, bias, batch,
                                                                     grid).items():
            rec = records[name]
            st = {"shape": [rows, c], "launches_per_forward": layers, "bytes": nbytes,
                  "flops": flops}
            rec["bytes"] += layers * nbytes
            rec["flops"] += layers * flops
            if timing:
                st["ms"] = cuda_time_ms(kern)
                st["plain_ms"] = cuda_time_ms(plain, iters=plain_iters, warmup=1)
                st["library_ms"] = cuda_time_ms(library, iters=10)
                if host:
                    st["host_ms"], st["device_ms"] = host_device_ms(kern)
            else:
                st["max_abs_err"], rel = bn_check(name, x, g, scale, bias, f"({rows}, {c})")
                if rel is not None:
                    st["relative_to_f64"] = rel
                rec["max_abs_err"] = max(rec["max_abs_err"], st["max_abs_err"])
            rec["stages"].append(st)
        if not timing:
            errs = bn_train_check(x, g, scale, bias, f"({rows}, {c})")
            records["bn_bwd_reduce"]["stages"][-1]["bn_train"] = errs
            worst = max(records[n]["stages"][-1]["relative_to_f64"]
                        for n in ("bn_channel_sums", "bn_bwd_reduce"))
            log(f"  ({rows:7d}, {c:4d}) x{layers:2d}: Σx, Σx², Σg, Σg·x̂ within {worst:.2g}·Σ|terms| "
                f"of f64 (tol {BN_SUM_TOL}), finishes within {BN_FINISH_TOL}·max|plain|, "
                f"normalize and dx bit-equal to their plain versions; bn_train vs plain path: y "
                f"{errs['y']:.2g}, dx {errs['dx']:.2g}·max|plain|, dscale {errs['dscale']:.2g}, "
                f"dbias {errs['dbias']:.2g}·Σ|terms| ok")
        del x, g
        torch.cuda.empty_cache()
    for rec in records.values():
        finish_record(rec, timing, H100_F32_FLOPS)  # f32 adds and multiplies on CUDA cores
        if timing and host:
            for key in ("host_ms", "device_ms"):
                rec[key] = sum(st["launches_per_forward"] * st[key] for st in rec["stages"])
    return records


def bn_train_times(shapes=RESNET_BN_SHAPES, batch: int = RESNET_BATCH,
                   plain_iters: int = 5) -> dict:
    """bn_train's forward (the sums and the normalize) and backward (the
    reduce and dx) a step, each shape's calls as the Function makes them
    times its layers: through the kernels; through the plain versions (the
    parent's eager formulas, with torch's sums); and torch.native_batch_norm
    forward and backward on the channels-last view, the library's whole
    BatchNorm. Bounds: the four calls' bytes (2 + 4 and 4 + 6 B an element
    in bf16) and a single pass's each way (4 and 6 B: x read, y written;
    g and x read, dx written)."""
    import torch

    from hvt_torch.ops import bn_stats

    out = {d: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "one_pass_bound_ms": 0.0} for d in ("forward", "backward")}
    for i, (grid, c, layers) in enumerate(shapes):
        x, g, scale, bias = bn_inputs(grid, c, seed=700 + i, batch=batch)
        mean, _, rstd = bn_stats.bn_moments(x, 1e-5)
        x4 = x.view(batch, grid, grid, c).permute(0, 3, 1, 2)
        g4 = g.view(batch, grid, grid, c).permute(0, 3, 1, 2)
        _, save_mean, save_invstd = torch.native_batch_norm(x4, scale, bias, None, None, True, 0.0,
                                                            1e-5)

        def forward(moments, normalize):
            m_, _, r_ = moments(x, 1e-5)
            return normalize(x, m_, r_, scale, bias, torch.bfloat16)

        def backward(terms, dx):
            return dx(g, x, mean, rstd, terms(g, x, mean, rstd, scale))

        calls = {
            "forward": (lambda: forward(bn_stats.bn_moments, bn_stats.bn_normalize),
                        lambda: forward(bn_stats.bn_moments_plain, bn_stats.bn_normalize_plain),
                        lambda: torch.native_batch_norm(x4, scale, bias, None, None, True, 0.0,
                                                        1e-5), 6, 4),
            "backward": (lambda: backward(bn_stats.bn_bwd_terms, bn_stats.bn_dx),
                         lambda: backward(bn_stats.bn_bwd_terms_plain, bn_stats.bn_dx_plain),
                         lambda: torch.ops.aten.native_batch_norm_backward(
                             g4, x4, scale, None, None, save_mean, save_invstd, True, 1e-5,
                             [True, True, True]), 10, 6),
        }
        for d, (kern, plain, library, nbytes, one_pass) in calls.items():
            rec = out[d]
            rec["ms"] += layers * cuda_time_ms(kern)
            rec["plain_ms"] += layers * cuda_time_ms(plain, iters=plain_iters, warmup=1)
            rec["library_ms"] += layers * cuda_time_ms(library, iters=10)
            rec["bound_ms"] += layers * nbytes * x.numel() / H100_BYTES_PER_S * 1e3
            rec["one_pass_bound_ms"] += layers * one_pass * x.numel() / H100_BYTES_PER_S * 1e3
        del x, g, x4, g4
        torch.cuda.empty_cache()
    out["forward_and_backward"] = {key: out["forward"][key] + out["backward"][key]
                                   for key in out["forward"]}
    return out


def bn_train_line(rec: dict) -> str:
    return "; ".join(
        f"{d} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, native_batch_norm "
        f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f}, one pass "
        f"{r['one_pass_bound_ms']:.3f})" for d, r in rec.items())


# ---------------------------------------------------------------------------
# Phase 9: the ResNet-50 training path
# ---------------------------------------------------------------------------


def resnet_config(bn_pallas: bool, compute_dtype: str = "bfloat16", steps: int = RESNET_STEPS):
    """configs/pretrain/inat21.yaml less ProgressiveResizing, with bench.py's
    R50 settings (bench.py:285-338): batch RESNET_BATCH, stem_s2d,
    DecoupledSGDW at lr 2.048, momentum 0.875, wd 5e-4, EMA 100ba/20ba,
    smoothing 0.08, clip 2.0 (bench.py's list, which leaves out BlurPool);
    10,000 classes on the synthetic source, ``steps`` steps with a 5-step
    warmup, activations in ``compute_dtype``; evaluated (one synthetic batch
    of RESNET_BATCH) before the first step and after the last."""
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs/pretrain/inat21.yaml")])
    return config_lib.loads(config_lib.to_dict(base), {
        "max_duration": f"{steps}ba",
        "eval_interval": "1dur",
        "machine": {"save_root": str(runs_root())},
        "save": {"wandb": False},
        "scheduler": {"args": {"t_warmup": "5ba"}},
        "model": {"args": {"stem_s2d": True, "bn_pallas": bn_pallas}},
        "optim": {"name": "DecoupledSGDW", "lr": 2.048, "momentum": 0.875, "weight_decay": 5e-4},
        "algorithms": [
            {"cls": "EMA", "args": {"half_life": "100ba", "update_interval": "20ba"}},
            {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}},
            {"cls": "GradientClipping", "args": {"clipping_type": "norm", "clipping_threshold": 2.0}},
        ],
        "train_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                          "synthetic_num_samples": RESNET_BATCH * steps,
                          "global_batch_size": RESNET_BATCH},
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": RESNET_BATCH, "global_batch_size": RESNET_BATCH},
        "precision": {"compute_dtype": compute_dtype},
    })


def check_ema(trainer, label: str) -> dict:
    """The Trainer's EMA after RESNET_STEPS steps at interval 20: updated at
    steps 0 and 20, its weights apart from the live ones, every running
    statistic (live and averaged) finite."""
    import torch

    from hvt_torch.train import ema as ema_lib

    ema = trainer.ema
    live = dict(trainer.model.named_parameters())
    apart = sum(not torch.equal(ema.params[n], p) for n, p in live.items())
    stats = {**ema_lib.batch_stats(trainer.model), **{f"ema {k}": v for k, v in ema.batch_stats.items()}}
    finite = all(bool(torch.isfinite(v).all()) for v in stats.values())
    want = len(range(0, RESNET_STEPS, ema.cfg.update_interval_steps))
    log(f"  {label}: EMA decay {ema.cfg.decay:.6f}, {ema.updates} updates (steps 0 and 20 of "
        f"{RESNET_STEPS}); {apart}/{len(live)} averaged parameters apart from the live ones; "
        f"{len(stats)} running statistics finite: {finite}")
    if ema.updates != want or apart == 0 or not finite:
        raise AssertionError(f"{label}: EMA updates {ema.updates} (want {want}), {apart} tensors "
                             f"apart, finite {finite}")
    return {"decay": ema.cfg.decay, "updates": ema.updates, "params_apart": apart,
            "params": len(live), "stats_finite": finite}


# ---------------------------------------------------------------------------
# Phase 13: evaluation at iNat21's eval batch
# ---------------------------------------------------------------------------


def eval_config(base, is_train: bool):
    """``base`` (a phase 7, 9 or 10 config) with the synthetic eval source at
    CLASSES classes, EVAL_IMAGES images and batch EVAL_BATCH; eval-only, or
    trained for EVAL_TRAIN_STEPS steps and evaluated every 2 steps."""
    from hvt_torch import config as config_lib

    return config_lib.loads(config_lib.to_dict(base), {
        "is_train": is_train,
        "max_duration": f"{EVAL_TRAIN_STEPS}ba",
        "eval_interval": "2ba",
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": EVAL_IMAGES, "global_batch_size": EVAL_BATCH},
    })


def eval_run(config, label: str, per_forward: dict, seed=None):
    """Drive evaluation through the entry point a user calls,
    hvt_torch.main.main(config), every launch counter set to 0 just before
    and read just after: each kernel of ``per_forward`` launches that many
    times an eval batch, plus its training launches where the run trains
    (``train_per_step`` of the label's phase), and no other kernel; every
    evaluation counts exactly EVAL_IMAGES images and finite metrics. ``seed``
    draws every SwinV2 parameter (randomize_) once the Trainer is built.
    CUDA events time each eval step; the host clock each evaluation. Then,
    outside the main path, one more evaluation times the warm path. Returns
    the record and the Trainer."""
    import torch

    from hvt_torch import main as main_lib

    counters = kernel_counters()
    trainers, evals, batches = [], [], []

    class RecordingTrainer(main_lib.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if seed is not None:
                randomize_(self.model, seed)
            step = self.eval_step

            def timed(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args)
                end.record()
                batches.append((start, end, out["count"]))
                return out

            self.eval_step = timed
            trainers.append(self)

        def _evaluate_at(self, step):
            before = {n: c.launches for n, c in counters.items()}
            first = len(batches)
            t0 = time.perf_counter()
            metrics = super()._evaluate_at(step)
            evals.append({"step": step, "wall_s": time.perf_counter() - t0, "metrics": metrics,
                          "batches": (first, len(batches)),
                          "launches": {n: c.launches - before[n] for n, c in counters.items()}})
            return metrics

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with swapped(main_lib, Trainer=RecordingTrainer), trainer_output():
        metrics = main_lib.main(config)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    clear_runs()
    launches = {name: c.launches for name, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trainer = trainers[0]
    n_batches = trainer.eval_loader.batches_per_epoch
    want_steps = [0] if not config.is_train else [0, 2, EVAL_TRAIN_STEPS]
    if [e["step"] for e in evals] != want_steps:
        raise AssertionError(f"{label}: evaluations at {[e['step'] for e in evals]}, "
                             f"expected {want_steps}")
    for e in evals:
        lo, hi = e["batches"]
        e["count"] = sum(float(b[2]) for b in batches[lo:hi])
        e["batch_ms"] = [a.elapsed_time(b) for a, b, _ in batches[lo:hi]]
        if e["count"] != EVAL_IMAGES or hi - lo != n_batches or not all(
                math.isfinite(v) for v in e["metrics"].values()):
            raise AssertionError(f"{label}: evaluation at step {e['step']} counted {e['count']} "
                                 f"images in {hi - lo} batches, metrics {e['metrics']}")
        for name, n in e["launches"].items():
            if n != per_forward.get(name, 0) * n_batches:
                raise AssertionError(f"{name}: {n} launches in the evaluation at step "
                                     f"{e['step']} of {label}, expected "
                                     f"{per_forward.get(name, 0) * n_batches}")
    train_per_step = {"resnet50": {k: RESNET_BN_LAYERS for k in BN_KERNELS},
                      "swinv2_tiny fuse=True": {k: 12 for k in TRAIN_KERNELS[True]}}
    per_step = train_per_step.get(label, {}) if config.is_train else {}
    steps = EVAL_TRAIN_STEPS if config.is_train else 0
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps + per_forward.get(name, 0) * n_batches * len(evals)
        if n != want:
            raise AssertionError(f"{name}: {n} launches in {label} "
                                 f"({'trained' if config.is_train else 'eval only'}), "
                                 f"expected {want}")
    if ("tree-dist" in metrics) == bool(config.is_train):  # an eval-only run's metric
        raise AssertionError(f"{label}: metrics {sorted(metrics)} (eval only: "
                             f"{not config.is_train})")
    # the warm path, timed once more outside the main path
    first = len(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = trainer.evaluate()
    warm_s = time.perf_counter() - t0
    batch_ms = sorted(a.elapsed_time(b) for a, b, _ in batches[first:])
    rec = {"label": label, "is_train": bool(config.is_train), "launches": launches,
           "evals": [{k: v for k, v in e.items() if k != "batches"} for e in evals],
           "metrics": metrics, "warm_metrics": warm, "warm_wall_s": warm_s,
           "images_per_s": EVAL_IMAGES / warm_s, "batch_ms": batch_ms,
           "batch_ms_median": batch_ms[len(batch_ms) // 2],
           "first_wall_s": evals[0]["wall_s"], "wall_s": wall_s, "peak_memory_gib": peak_gib}
    log(f"  {label} ({'4 steps, evaluated at steps 0, 2, 4' if config.is_train else 'eval only'}): "
        + "; ".join(f"step {e['step']}: {e['count']:.0f} images in {len(e['batch_ms'])} batches of "
                    f"{EVAL_BATCH}, " + " ".join(f"{k} {v:.4f}" for k, v in e["metrics"].items())
                    for e in evals)
        + f"; warm evaluation {warm_s:.3f} s ({rec['images_per_s']:.1f} img/s), eval step "
        f"{rec['batch_ms_median']:.2f} ms a batch (device, median of {len(batch_ms)}: "
        + ", ".join(f"{v:.2f}" for v in batch_ms)
        + f"); first evaluation {evals[0]['wall_s']:.3f} s; peak memory {peak_gib:.2f} GiB; launches { {k: v for k, v in launches.items() if v} }; "
        f"{wall_s:.1f} s in all")
    return rec, trainer


def plain_eval_check(trainer, label: str, kernel_metrics: dict) -> dict:
    """The eval path on the kernels (``kernel_metrics``, the Trainer's last
    evaluation) against the plain path (the same eval step with the
    kernels' plain versions, EVAL_CHUNK images at a time) on the Trainer's
    eval weights: the first batch's logits, and the metrics over the whole
    eval set (tolerances at EVAL_CE_RTOL)."""
    import torch

    from hvt_torch import metrics as metrics_lib
    from hvt_torch.train import step as step_lib

    params, stats = trainer.eval_params, trainer.eval_batch_stats
    batches = trainer.eval_loader.epoch(0)
    images, labels, mask = trainer._to_device(next(batches))
    with torch.inference_mode():
        logits = step_lib._eval_forward(trainer.model, params, stats,
                                        trainer.eval_prep.normalize(images)).float()
    sums, worst = {}, 0.0
    with plain_versions():
        for i, (images, labels, mask) in enumerate(
                [(images, labels, mask)] + [trainer._to_device(b) for b in batches]):
            for lo in range(0, EVAL_BATCH, EVAL_CHUNK):
                part = slice(lo, lo + EVAL_CHUNK)
                if i == 0:
                    with torch.inference_mode():
                        ref = step_lib._eval_forward(trainer.model, params, stats,
                                                     trainer.eval_prep.normalize(images[part]))
                    err = float((logits[part] - ref.float()).abs().max())
                    worst = max(worst, err / float(ref.float().abs().max()))
                for k, v in trainer.eval_step(params, stats, images[part], labels[part],
                                              mask[part]).items():
                    sums[k] = sums.get(k, 0.0) + float(v)
    acc = metrics_lib.MetricAccumulator()
    acc.update(sums)
    plain = acc.compute()
    tol = {k: EVAL_ACC_ATOL * (7 if k == "tree-dist" else 1) for k in kernel_metrics}
    tol["cross-entropy"] = EVAL_CE_RTOL * abs(plain["cross-entropy"])
    bad = [k for k in kernel_metrics if abs(kernel_metrics[k] - plain[k]) > tol[k]]
    log(f"  {label}: kernel path vs plain path: first batch's logits within "
        f"{worst:.2g}·max|logit| (tol {LOGIT_TOL}); metrics " + ", ".join(
            f"{k} {kernel_metrics[k]:.5f} / {plain[k]:.5f}" for k in kernel_metrics)
        + f" ({sums['count']:.0f} images on the plain path)")
    if worst > LOGIT_TOL or bad or sums["count"] != EVAL_IMAGES:
        raise AssertionError(f"{label}: the eval path disagrees with the plain path: logits "
                             f"{worst}, metrics {bad}, count {sums['count']}")
    return {"logits_rel_err": worst, "metrics": kernel_metrics, "plain_metrics": plain}


def ema_eval_check(trainer, label: str) -> dict:
    """The Trainer evaluates its EMA copy: with the averaged parameters and
    running statistics replaced by the live ones, the metrics move."""
    from hvt_torch.train import ema as ema_lib

    ema = trainer.ema
    on_ema = trainer.evaluate()
    saved = ema.params, ema.batch_stats
    ema.params, ema.batch_stats = dict(trainer.model.named_parameters()), ema_lib.batch_stats(
        trainer.model)
    try:
        on_live = trainer.evaluate()
    finally:
        ema.params, ema.batch_stats = saved
    moved = abs(on_live["cross-entropy"] - on_ema["cross-entropy"])
    log(f"  {label}: EMA ({ema.updates} updates) cross-entropy {on_ema['cross-entropy']:.5f}, with "
        f"the live weights in its place {on_live['cross-entropy']:.5f}")
    if moved <= 1e-4 * abs(on_ema["cross-entropy"]):
        raise AssertionError(f"{label}: replacing the EMA weights left the metrics at {on_ema}")
    return {"ema": on_ema, "live": on_live}


def evaluation_phase(card: str) -> dict:
    """Phase 13: each model evaluated alone (``is_train: false``, with
    tree-dist), held against the plain path; SwinV2-T on fuse: true and
    ResNet-50 (EMA) also trained for 4 steps and evaluated at steps 0, 2
    and 4; the EMA run's metrics come from the EMA weights."""
    import torch

    out = {}
    models = (("swinv2_tiny fuse=True", lambda: training_config(fuse=True), 13, True),
              ("swinv2_tiny fuse=False", lambda: training_config(fuse=False), 13, False),
              ("resnet50", lambda: resnet_config(True), None, True),
              ("swinv2_base fuse=True", lambda: training_config("swinv2_base", fuse=True), 13,
               False))
    for label, base, seed, trains in models:
        rec, trainer = eval_run(eval_config(base(), False), label, EVAL_PER_FORWARD[label], seed)
        rec["plain_check"] = plain_eval_check(trainer, label, rec["warm_metrics"])
        del trainer
        out[label] = {"eval_only": rec}
        if trains:
            rec, trainer = eval_run(eval_config(base(), True), label, EVAL_PER_FORWARD[label], seed)
            if trainer.ema is not None:
                rec["ema_check"] = ema_eval_check(trainer, label)
            del trainer
            out[label]["trained"] = rec
        gc.collect()
        torch.cuda.empty_cache()
    for label, recs in out.items():
        rec = recs["eval_only"]
        log(f"  {label}: eval {rec['images_per_s']:.1f} img/s (warm, host clock, {EVAL_IMAGES} "
            f"images), {rec['batch_ms_median']:.2f} ms a batch of {EVAL_BATCH} (device), peak "
            f"memory {rec['peak_memory_gib']:.2f} GiB, on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: checkpoints, resume, preemption and weights on the card
# ---------------------------------------------------------------------------


def with_changes(config, **change):
    from hvt_torch import config as config_lib

    return config_lib.loads(config_lib.to_dict(config), change)


def ckpt_run(config, label: str, per_step: dict, eval_per_forward: dict,
             capture_at=None, signal_at=None):
    """Drive ``hvt_torch.main.main(config)`` with every launch counter 0
    just before and read just after: each kernel of ``per_step`` launches
    that many times a step taken, each of ``eval_per_forward`` that many
    times an eval batch, every other kernel never. ``capture_at``: the
    Trainer's state copied to the host after that step (before its save);
    ``signal_at``: a SIGTERM sent to this process after that step. Returns
    the record (each step's loss as a host float), the Trainer (its state
    right after construction, any restore included, in ``initial``) and the
    captured state."""
    import torch

    from hvt_torch import main as main_lib
    from hvt_torch.train import checkpoint as ckpt_lib

    counters = kernel_counters()
    trainers, losses, evals, captured = [], [], [], {}

    class RecordingTrainer(main_lib.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.initial = ckpt_lib.to_host(self.state_dict())
            trainers.append(self)

        def _evaluate_at(self, step):
            evals.append(step)
            return super()._evaluate_at(step)

    def on_step(step, stats):
        losses.append(stats["loss_sum"])
        if step == capture_at:
            captured.update(ckpt_lib.to_host(trainers[0].state_dict()))
        if step == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)

    gc.collect()
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with swapped(main_lib, Trainer=RecordingTrainer), trainer_output():
        metrics = main_lib.main(config, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    trainer = trainers[0]
    start = trainer.initial["step"]
    steps = trainer.step - start
    eval_batches = len(evals) * trainer.eval_loader.batches_per_epoch
    losses = [float(v) for v in losses]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: {steps} steps, losses {losses}")
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps + eval_per_forward.get(name, 0) * eval_batches
        if n != want:
            raise AssertionError(f"{name}: {n} launches in {label} ({steps} steps, "
                                 f"{eval_batches} eval batches), expected {want}")
    log(f"  {label}: steps {start} → {trainer.step}, losses "
        + " ".join(f"{v:.6f}" for v in losses) + f"; evaluations at {evals}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {wall_s:.1f} s")
    return ({"label": label, "start_step": start, "end_step": trainer.step, "losses": losses,
             "eval_steps": evals, "eval_batches": eval_batches, "launches": launches,
             "wall_s": wall_s, "metrics": metrics}, trainer, captured)


def state_diff(a: dict, b: dict) -> float:
    """max|a − b| over every tensor of two host checkpoint states:
    parameters, running statistics, EMA copies and optimizer tensors."""
    pairs = []
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        if (a[key] is None) != (b[key] is None) or (a[key] or {}).keys() != (b[key] or {}).keys():
            raise AssertionError(f"states differ in {key}'s names")
        pairs += [(t, b[key][n]) for n, t in (a[key] or {}).items()]
    opt_a, opt_b = a["opt_state"]["state"], b["opt_state"]["state"]
    if opt_a.keys() != opt_b.keys():
        raise AssertionError("states differ in the optimizer's slots")
    pairs += [(t, opt_b[i][slot]) for i, slots in opt_a.items() for slot, t in slots.items()]
    return max((float((x.double() - y.double()).abs().max()) for x, y in pairs if x.numel()),
               default=0.0)


def bit_equal(a: dict, b: dict) -> bool:
    """Two host checkpoint states equal bit for bit, count and generator included."""
    import torch

    return (a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
            and torch.equal(a["rng"], b["rng"]) and a["ema_updates"] == b["ema_updates"]
            and state_diff(a, b) == 0.0)


def resume_check(label: str, tag: str, base, steps: int, at: int, per_step: dict,
                 eval_per_forward: dict) -> tuple:
    """Phase 14 (a) and (b): ``base`` trained ``steps`` steps straight, twice;
    once more saving every ``at`` steps (keep 2), its state captured at
    ``at``; then a new Trainer restored from the step-``at`` checkpoint
    (``load_path: ckpt://...:at``) trains to ``steps``. The restored state
    must equal the captured one bit for bit (parameters, running statistics,
    EMA copies, optimizer tensors, count, generator); the resumed losses and
    final state must lie within SPREAD_FACTOR times the straight runs'
    difference. Each run is named ``<tag>_<run>``. Returns the record, the
    resumed Trainer and the interrupted run's checkpoints directory."""
    from hvt_torch.train import checkpoint as ckpt_lib

    def run(name, **change):
        rec, trainer, captured = ckpt_run(with_changes(base, run_name=f"{tag}_{name}", **change),
                                          f"{label} {name}", per_step, eval_per_forward,
                                          capture_at=at if name == "interrupted" else None)
        state = ckpt_lib.to_host(trainer.state_dict())
        return rec, trainer, state, captured

    s1, t, state1, _ = run("straight1")
    del t
    s2, t, state2, _ = run("straight2")
    del t
    cut, t, _, captured = run("interrupted", save={"interval": f"{at}ba",
                                                   "num_checkpoints_to_keep": 2})
    ckpts = t.checkpointer.directory
    saved_steps = t.checkpointer.steps()
    del t
    if saved_steps != [at, steps]:
        raise AssertionError(f"{label}: checkpoints at {saved_steps}, expected [{at}, {steps}]")
    resumed, trainer, state_r, _ = run("resumed", load_path=f"ckpt://{ckpts}:{at}")
    restored_equal = bit_equal(trainer.initial, captured)
    if not restored_equal or resumed["start_step"] != at or resumed["end_step"] != steps:
        raise AssertionError(f"{label}: the restore from step {at} is not the saved state "
                             f"(bit-equal: {restored_equal}; steps {resumed['start_step']} → "
                             f"{resumed['end_step']})")
    loss_spread = max(abs(a - b) for a, b in zip(s1["losses"], s2["losses"]))
    loss_diff = max(abs(a - b) for a, b in zip(resumed["losses"], s1["losses"][at:]))
    cut_diff = max(abs(a - b) for a, b in zip(cut["losses"], s1["losses"]))
    state_spread = state_diff(state1, state2)
    state_r_diff = state_diff(state_r, state1)
    noisy = loss_spread > 0 or state_spread > 0
    scale = max(abs(v) for v in s1["losses"])
    loss_bound = SPREAD_FACTOR * max(loss_spread, LOSS_FLOOR * scale) if noisy else 0.0
    state_bound = SPREAD_FACTOR * state_spread
    rec = {"straight": [s1, s2], "interrupted": cut, "resumed": resumed,
           "restored_bit_equal": restored_equal, "checkpoints": saved_steps,
           "loss_spread": loss_spread, "loss_diff": loss_diff, "interrupted_loss_diff": cut_diff,
           "state_spread": state_spread, "state_diff": state_r_diff,
           "straight_runs_bit_equal": bit_equal(state1, state2),
           "resumed_bit_equal": bit_equal(state_r, state1),
           "loss_bound": loss_bound, "state_bound": state_bound}
    log(f"  {label}: restore from step {at} bit-equal to the saved state: {restored_equal}; "
        f"straight runs apart by {loss_spread:.3g} in loss (steps 1-{steps}) and "
        f"{state_spread:.3g} "
        f"in any state element (bit-equal: {rec['straight_runs_bit_equal']}); resumed run apart "
        f"from straight run 1 by {loss_diff:.3g} in loss (steps {at + 1}-{steps}; bound "
        f"{loss_bound:.3g}) and {state_r_diff:.3g} in state (bound {state_bound:.3g}; bit-equal: "
        f"{rec['resumed_bit_equal']}); the interrupted run by {cut_diff:.3g} in loss")
    if loss_diff > loss_bound or state_r_diff > state_bound or cut_diff > loss_bound:
        raise AssertionError(f"{label}: the resumed run left the straight runs' spread: {rec}")
    return rec, trainer, ckpts


def sigterm_check() -> dict:
    """Phase 14 (c): SwinV2-T as in (a) with ``auto_resume``; a SIGTERM to
    this process after step SIGTERM_AT: ``fit`` returns, the checkpoint of
    that step exists, the previous handler is back; the same config again
    resumes there and trains to CKPT_STEPS."""
    config = with_changes(training_config(fuse=True, steps=CKPT_STEPS), run_name="preempted",
                          auto_resume=True)
    per_step = {k: 12 for k in TRAIN_KERNELS[True]}
    per_eval = EVAL_PER_FORWARD["swinv2_tiny fuse=True"]
    before = signal.getsignal(signal.SIGTERM)
    first, trainer, _ = ckpt_run(config, "SIGTERM run", per_step, per_eval, signal_at=SIGTERM_AT)
    ckpts = trainer.checkpointer.directory
    saved, restored = trainer.checkpointer.steps(), signal.getsignal(signal.SIGTERM) == before
    del trainer
    second, trainer, _ = ckpt_run(config, "resubmitted", per_step, per_eval)
    del trainer
    ok = (first["end_step"] == SIGTERM_AT and saved == [SIGTERM_AT] and restored
          and second["start_step"] == SIGTERM_AT and second["end_step"] == CKPT_STEPS)
    log(f"  SIGTERM after step {SIGTERM_AT}: fit returned at step {first['end_step']}, "
        f"checkpoints {saved} under {ckpts.name}/, handler restored: {restored}; the "
        f"resubmission trained {second['start_step']} → {second['end_step']}")
    if not ok:
        raise AssertionError(f"SIGTERM round trip: {first}, {saved}, {restored}, {second}")
    return {"first": first, "checkpoints": saved, "handler_restored": restored,
            "resubmitted": second}


def weights_check(swin_ckpts, resnet_trainer) -> dict:
    """Phase 14 (d): (a)'s step-CKPT_STEPS checkpoint exported by
    ``hvt_torch.tools.export_torch`` as a swin:// file and loaded through a
    strict PretrainedBackbone into a SwinV2-T with 1,000 classes, evaluated
    (eval only) through the fused kernels: backbone equal to the
    checkpoint's, head at its seeded init. Then ``InferenceEngine`` with
    ``load_path`` at (b)'s resumed checkpoint: logits within
    LOGIT_TOL·max|logit| of the Trainer's eval forward on its EMA weights,
    and with ``use_ema=False`` on its live weights."""
    import torch

    from hvt_torch import config as config_lib
    from hvt_torch.downstream import serve as serve_lib
    from hvt_torch.models import build_model
    from hvt_torch.tools import export_torch
    from hvt_torch.train import checkpoint as ckpt_lib
    from hvt_torch.train import ema as ema_lib
    from hvt_torch.train import step as step_lib

    out = runs_root() / "swinv2_tiny_step6.pt"
    uri = f"ckpt://{swin_ckpts}:{CKPT_STEPS}"
    info = export_torch.export(uri, str(out))
    base = training_config(fuse=True)
    backbone = {"cls": "PretrainedBackbone",
                "args": {"checkpoint": f"swin://{out}", "strict": True}}
    classes = {"synthetic_num_classes": 1000}
    config = with_changes(base, run_name="from_swin", is_train=False,
                          train_dataset=classes, eval_dataset=classes,
                          algorithms=[*config_lib.to_dict(base)["algorithms"], backbone])
    rec, trainer, _ = ckpt_run(config, "SwinV2-T, 1,000 classes, PretrainedBackbone swin://", {},
                               EVAL_PER_FORWARD["swinv2_tiny fuse=True"])
    saved = ckpt_lib.load_raw(uri)["params"]
    init = build_model(config, 1000).state_dict()
    live = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
    backbone_equal = all(torch.equal(t, saved[n]) for n, t in live.items()
                         if not n.startswith("head."))
    head_init = all(torch.equal(t, init[n]) for n, t in live.items() if n.startswith("head."))
    del trainer
    log(f"  export_torch wrote {info['keys']} tensors ({info['family']}, {info['source']}, "
        f"{out.stat().st_size / 1e6:.1f} MB); backbone equal to the checkpoint's: "
        f"{backbone_equal}; head ({live['head.weight'].shape[0]} classes) at its init: {head_init}")
    if not (backbone_equal and head_init):
        raise AssertionError("the swin:// backbone did not load as saved")

    serve_config = with_changes(resnet_trainer.config, run_name="serve",
                                load_path=f"ckpt://{resnet_trainer.checkpointer.directory}:"
                                          f"{resnet_trainer.step}")
    batch = next(resnet_trainer.eval_loader.epoch(0))
    images = torch.from_numpy(batch.images[:BATCH]).cuda()
    x = resnet_trainer.eval_prep.normalize(images)
    serving = {}
    for use_ema, params, stats in (
            (True, resnet_trainer.ema.params, resnet_trainer.ema.batch_stats),
            (False, dict(resnet_trainer.model.named_parameters()),
             ema_lib.batch_stats(resnet_trainer.model))):
        with trainer_output():
            engine = serve_lib.InferenceEngine(serve_config, batch=BATCH, use_ema=use_ema)
        try:
            with torch.inference_mode():
                got = engine.model(x).float()
                ref = step_lib._eval_forward(resnet_trainer.model, params, stats, x).float()
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            rec_engine = engine.predict_image(ppm(5))
        finally:
            engine.close()
        serving[f"use_ema={use_ema}"] = {"logits_rel_err": err, "record": rec_engine}
        log(f"  InferenceEngine, ResNet-50 from load_path (step {resnet_trainer.step}), use_ema="
            f"{use_ema}: logits within {err:.3g}·max|logit| of the Trainer's eval forward "
            f"(tol {LOGIT_TOL}); a served record: {rec_engine['class_ids'][:3]}")
        if err > LOGIT_TOL:
            raise AssertionError(f"serving use_ema={use_ema}: logits {err} apart")
    return {"export": info, "pretrained": rec, "backbone_equal": backbone_equal,
            "head_at_init": head_init, "serving": serving}


def checkpoint_cost(trainer, label: str) -> dict:
    """Phase 14 (e): one more save of the Trainer's state at its step: the
    bytes on disk, ``save``'s blocking time (the host copy; CUDA events
    around it and the host clock), the background write's seconds (from
    ``save``'s return to the joined write) and ``restore``'s (reading the
    file, then copying it onto the card)."""
    import torch

    from hvt_torch.train import checkpoint as ckpt_lib

    step = trainer.step
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trainer.save_checkpoint(step)
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    trainer.checkpointer.wait()
    t2 = time.perf_counter()
    path = trainer.checkpointer.directory / str(step)
    nbytes = (path / ckpt_lib.STATE_FILE).stat().st_size
    t3 = time.perf_counter()
    raw = ckpt_lib.load_raw(str(path))
    t4 = time.perf_counter()
    trainer.restore(raw)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    params = sum(p.numel() for p in trainer.model.parameters())
    rec = {"label": label, "params": params, "bytes": nbytes, "bytes_per_param": nbytes / params,
           "save_ms_host": (t1 - t0) * 1e3, "save_ms_events": start.elapsed_time(end),
           "write_s": t2 - t1, "restore_s": t5 - t3, "read_s": t4 - t3, "to_card_s": t5 - t4,
           "host_copy_gb_per_s": nbytes / (t1 - t0) / 1e9}
    log(f"  checkpoint of {label}: {params / 1e6:.2f} M params, {nbytes / 1e9:.3f} GB on disk "
        f"({rec['bytes_per_param']:.2f} B a param); save blocks {rec['save_ms_host']:.1f} ms (host "
        f"clock) / {rec['save_ms_events']:.1f} ms (CUDA events), {rec['host_copy_gb_per_s']:.2f} "
        f"GB/s; background write {rec['write_s']:.2f} s; restore {rec['restore_s']:.2f} s (read "
        f"{rec['read_s']:.2f}, onto the card {rec['to_card_s']:.2f})")
    return rec


def checkpoint_phase(card: str) -> dict:
    """Phase 14: (a) SwinV2-T fuse: true resumed from step CKPT_AT, (b)
    ResNet-50 with EMA and bn_pallas resumed from RESNET_CKPT_AT, (c) the
    SIGTERM round trip, (d) weights through export_torch, swin:// and
    serving's load_path, (e) the cost of a checkpoint for SwinV2-T,
    ResNet-50 and SwinV2-B. Each run under the temporary save_root, emptied
    at the end."""
    import torch

    from hvt_torch.train.loop import Trainer

    out = {}
    swin, swin_trainer, swin_ckpts = resume_check(
        "SwinV2-T fuse=True", "swinv2_tiny", training_config(fuse=True, steps=CKPT_STEPS),
        CKPT_STEPS, CKPT_AT,
        {k: 12 for k in TRAIN_KERNELS[True]}, EVAL_PER_FORWARD["swinv2_tiny fuse=True"])
    out["swinv2_tiny"] = swin
    resnet, resnet_trainer, _ = resume_check(
        "ResNet-50 EMA bn_pallas", "resnet50", resnet_config(True, steps=RESNET_CKPT_STEPS),
        RESNET_CKPT_STEPS, RESNET_CKPT_AT, {k: RESNET_BN_LAYERS for k in BN_KERNELS},
        EVAL_PER_FORWARD["resnet50"])
    out["resnet50"] = resnet
    out["sigterm"] = sigterm_check()
    out["weights"] = weights_check(swin_ckpts, resnet_trainer)
    costs = [checkpoint_cost(swin_trainer, "SwinV2-T"),
             checkpoint_cost(resnet_trainer, "ResNet-50 with EMA")]
    del swin_trainer, resnet_trainer
    gc.collect()
    torch.cuda.empty_cache()
    with trainer_output():
        base = Trainer(with_changes(training_config("swinv2_base", fuse=True),
                                    run_name="base_cost"))
    base.train_step(*base._to_device(next(base.train_loader.epoch(0))), base.generator)
    costs.append(checkpoint_cost(base, "SwinV2-B"))
    base.close()
    del base
    out["costs"] = costs
    clear_runs()
    gc.collect()
    torch.cuda.empty_cache()
    for c in costs:
        log(f"  {c['label']}: {c['bytes'] / 1e9:.3f} GB, save {c['save_ms_host']:.1f} ms blocking, "
            f"write {c['write_s']:.2f} s, restore {c['restore_s']:.2f} s, on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 1's host facts and phase 15: training from JPEG folders
# ---------------------------------------------------------------------------


def host_facts() -> dict:
    """The host the loader runs on: CPU count and affinity, whether g++
    exists, whether jpeglib.h is found and -ljpeg links (one tiny program
    compiled and linked), whether sklearn imports."""
    import importlib

    facts = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
             "gxx": shutil.which("g++"), "jpeglib_h": False, "ljpeg_links": False}
    if facts["gxx"]:
        with tempfile.TemporaryDirectory(prefix="hvt-chip-jpeg-") as tmp:
            src = pathlib.Path(tmp) / "probe.cc"
            src.write_text("#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
                           "int main() { jpeg_error_mgr e; jpeg_std_error(&e); return 0; }\n")
            facts["jpeglib_h"] = subprocess.run(
                ["g++", "-E", str(src), "-o", os.devnull], capture_output=True, timeout=60,
            ).returncode == 0
            facts["ljpeg_links"] = subprocess.run(
                ["g++", str(src), "-o", str(pathlib.Path(tmp) / "probe"), "-ljpeg"],
                capture_output=True, timeout=60).returncode == 0
    try:
        importlib.import_module("sklearn")
        facts["sklearn"] = True
    except ImportError:
        facts["sklearn"] = False
    facts["libjpeg"] = facts["jpeglib_h"] and facts["ljpeg_links"]
    return facts


FIXTURE_TRAIN = 2560  # ten ResNet-50 batches of 256: an epoch of (c)
FIXTURE_VAL = 256
# Phases 15 and 16 run fewer steps, iterations, requests and eval images than
# they did before phase 22 (20 and 20 folder steps for (c) and (d), 4 loader
# batches, 10 bench steps, plain timings of 5 calls, 4 resume steps, 512 val
# JPEGs; 10 CPU probe iterations, 5 shots at iNat21's width, 25 requests), so
# that phase 22 fits in the script's time limit; every check stays.
FOLDER_STEPS = 10  # (c): one epoch, across every progressive bucket
FOLDER_SWIN_STEPS = 7  # (d): the fewest with a median after the first 5
FOLDER_RESUME_STEPS = 3  # (g): resumed from RESNET_CKPT_AT
LOADER_BATCH = 64  # (b)
LOADER_BATCHES = 1
INPUT_BENCH_STEPS = 3  # (e), each rate
FOLDER_PLAIN_ITERS = 2  # (c): calls of each plain version timed at the smaller buckets
AUG_CHECK_BATCH = 32  # (f): the batch both devices augment
_FIXTURES: list[pathlib.Path] = []  # removed at exit


def write_fixture() -> dict:
    """(a) hvt's fixture at iNat21's width: 10,000 class directories, 2,560
    train and 256 val JPEGs of seeded noise, 500x375, written by Pillow
    on every core."""
    from hvt_torch.tools import loader_bench

    root = pathlib.Path(tempfile.mkdtemp(prefix="hvt-chip-folder-"))
    _FIXTURES.append(root)
    fx = loader_bench.make_fixture(root, FIXTURE_TRAIN, FIXTURE_VAL, classes=CLASSES,
                                   workers=os.cpu_count() or 1)
    log(f"  (a) fixture: {fx['images']} JPEGs (500x375, quality 85) over {CLASSES} classes in "
        f"{fx['seconds']:.1f} s, mean file {fx['mean_bytes'] / 1e3:.1f} kB")
    return fx


def loader_rates(root: str, native: bool, cpus: int) -> list:
    """(b) the Loader alone (the ported loader_bench): img/s on each route at
    1, 4, 8 and every thread of the host, train (bare and with host
    RandAugment + ColOut) and eval."""
    from hvt_torch.data import native as native_lib
    from hvt_torch.tools import loader_bench

    rows = []
    for threads in sorted({1, 4, 8, cpus}):
        for mode, augment in (("train", "none"), ("train", "host"), ("eval", "none")):
            for route in ("native", "pillow"):
                r = loader_bench.bench_pipeline(root, LOADER_BATCH, LOADER_BATCHES, threads, route,
                                                mode == "train", augment)
                if "skipped" in r:
                    if native or route != "native":
                        raise AssertionError(f"loader_bench {route}: {r['skipped']}")
                    continue
                rows.append(r)
    if not native:
        log("  (b) native route skipped (no libjpeg on this host): "
            f"{native_lib.unavailable_reason()}")
    for r in rows:
        log(f"  (b) {r['route']:6s} {r['mode']:5s} augment {r['augment']:4s} threads "
            f"{r['threads']:3d}: {r['images_per_sec']:8.1f} img/s ({r['images_per_sec'] / r['threads']:.1f} "
            f"a thread; {cpus} CPUs)")
    return rows


def folder_layer(root: str, batch: int, eval_batch: int) -> dict:
    return {"machine": {"save_root": str(runs_root()), "datasets": {"inat_fixture": root}},
            "save": {"wandb": False}, "eval_interval": "1dur",
            "train_dataset": {"source": "imagefolder", "path": "inat_fixture",
                              "global_batch_size": batch},
            "eval_dataset": {"source": "imagefolder", "path": "inat_fixture",
                             "global_batch_size": eval_batch}}


def folder_resnet_config(root: str, steps: int = FOLDER_STEPS, extra_algorithms=(),
                         eval_batch=None):
    """(c) configs/pretrain/inat21.yaml as written (BlurPool, EMA 100ba/20ba,
    ProgressiveResizing 0.5/0.4/0.2, smoothing 0.08, clip 2.0, its optimizer
    and schedule), except: batch RESNET_BATCH, bn_pallas, ``steps`` steps,
    the fixture as its train and val folders, evaluated before the first
    step and after the last; ``extra_algorithms`` appended."""
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs/pretrain/inat21.yaml")])
    tree = config_lib.to_dict(base)
    layer = folder_layer(root, RESNET_BATCH, eval_batch or tree["eval_dataset"]["global_batch_size"])
    layer.update({"max_duration": f"{steps}ba", "model": {"args": {"bn_pallas": True}},
                  "algorithms": tree["algorithms"] + list(extra_algorithms)})
    return config_lib.loads(tree, layer)


def folder_swin_config(root: str, extra_algorithms, steps: int = FOLDER_SWIN_STEPS):
    """(d) phase 7's SwinV2-T recipe on fuse: true at batch TRAIN_BATCH from
    the fixture, ``extra_algorithms`` appended."""
    from hvt_torch import config as config_lib

    base = training_config(fuse=True, steps=steps)
    tree = config_lib.to_dict(base)
    layer = folder_layer(root, TRAIN_BATCH, TRAIN_BATCH)
    layer["algorithms"] = tree["algorithms"] + list(extra_algorithms)
    layer["eval_dataset"]["resize_size"] = 256
    return config_lib.loads(tree, layer)


def resident_step_ms(trainer, scale: float, iters: int = 5) -> float:
    """The Trainer's step alone at ``scale`` on one batch already on the card
    (CUDA events, after two warm steps): its device time a step."""
    import torch

    batch = trainer._to_device(next(trainer.train_loader.epoch(0)))
    for _ in range(2):
        trainer.train_step(*batch, trainer.generator, scale)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        trainer.train_step(*batch, trainer.generator, scale)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bn_shapes_at(model, size: int) -> tuple:
    """(H = W, channels, layers) of every BatchNorm input of ``model`` at a
    ``size`` px image: forward hooks over one eval forward of one image."""
    import collections

    import torch

    from hvt_torch.models.common import PallasBatchNorm

    seen = collections.Counter()
    hooks = [m.register_forward_hook(lambda _m, args, _out: seen.update([tuple(args[0].shape[1:])]))
             for m in model.modules() if isinstance(m, PallasBatchNorm)]
    training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros((1, size, size, 3), device="cuda", dtype=torch.bfloat16))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return tuple((h, c, n) for (h, _w, c), n in sorted(seen.items(), key=lambda kv: (-kv[0][0], kv[0][2])))


def bucket_steps(trainer, steps: int) -> dict:
    """Step indices (0-based) of each progressive bucket's image size."""
    from hvt_torch.data import device as device_prep

    crop = trainer.config.train_dataset.crop_size
    out: dict = {}
    for k in range(steps):
        scale = trainer._scale_for_step(k)
        size = crop if scale >= 1.0 else device_prep.resized_size(crop, scale)
        out.setdefault(size, {"scale": scale, "steps": []})["steps"].append(k)
    return out


def folder_resnet(root: str, native: bool, card: str) -> dict:
    """(c), and (e) for its model."""
    import torch

    from hvt_torch.data import device as device_prep
    from hvt_torch.train import step as step_lib

    per_step = {k: RESNET_BN_LAYERS for k in BN_KERNELS}
    rec, trainer = train_run(folder_resnet_config(root), per_step, "resnet50 inat21.yaml folder", {})
    decoder = trainer.train_loader.decoder
    if native and decoder != "native":
        raise AssertionError(f"phase 1 found libjpeg, but the train loader decoded with {decoder}")
    buckets = bucket_steps(trainer, rec["steps"])
    if sorted(buckets) != [112, 136, 168, 192, 224]:
        raise AssertionError(f"progressive buckets {sorted(buckets)}")
    for size, b in buckets.items():
        loop = [rec["step_ms"][k - 1] for k in b["steps"] if k >= 1]  # event gaps: step k's
        later = sorted(loop[1:]) if len(loop) > 1 else loop
        b["loop_ms"] = loop
        b["loop_ms_median"] = later[len(later) // 2]
        b["first_step_only"] = len(loop) <= 1
        b["device_ms"] = resident_step_ms(trainer, b["scale"])
        b["busy_share"] = b["device_ms"] / b["loop_ms_median"]
        log(f"  (c) {size} px (scale {b['scale']}, steps {b['steps']}): loop {b['loop_ms_median']:.2f} ms "
            f"a step{' (its only step, the first)' if b['first_step_only'] else ' (median after the first)'}, "
            f"the step alone on a resident batch {b['device_ms']:.2f} ms: busy {100 * b['busy_share']:.1f}%")
    rec["decoder"], rec["buckets"] = decoder, buckets
    rec["bn_launches_per_step"] = {k: rec["launches"][k] / rec["steps"] for k in BN_KERNELS}
    log(f"  (c) decoder {decoder}; BatchNorm launches a step {rec['bn_launches_per_step']}")
    bench = train_input_bench_row(trainer, "resnet50")
    model = trainer.model
    del trainer
    rec["bn"] = {}
    for size in (112, 136, 168, 192):
        shapes = bn_shapes_at(model, size)
        if sum(n for _, _, n in shapes) != RESNET_BN_LAYERS:
            raise AssertionError(f"{size} px: BatchNorm shapes {shapes}")
        log(f"  (c) bn_train's four calls vs f64 and plain versions at {size} px: maps "
            f"{sorted({h for h, _, _ in shapes}, reverse=True)}")
        checked = bn_records(False, shapes)
        timed = bn_records(True, shapes, plain_iters=FOLDER_PLAIN_ITERS)
        rec["bn"][size] = {"shapes": shapes, **{k: {
            "max_abs_err": checked[k]["max_abs_err"], "ms": timed[k]["ms"],
            "plain_ms": timed[k]["plain_ms"], "bound_ms": timed[k]["bound_ms"],
            "library_ms": timed[k]["library_ms"],
            "stages": {"check": checked[k]["stages"], "timed": timed[k]["stages"]}}
            for k in BN_KERNELS},
            "bn_train": bn_train_times(shapes, plain_iters=FOLDER_PLAIN_ITERS)}
        for k in BN_KERNELS:
            r = rec["bn"][size][k]
            log(f"  (c) {k} at {size} px: {r['ms']:.4f} ms a step ({RESNET_BN_LAYERS} calls), "
                f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library {r['library_ms']:.4f} "
                f"on {card}")
        log(f"  (c) bn_train at {size} px: {bn_train_line(rec['bn'][size]['bn_train'])}")
    del model
    torch.cuda.empty_cache()
    scale = 0.625  # 136 px: odd maps 17, 9, 5
    rec["gradients"] = {}
    for dtype, hold in (("bfloat16", False), ("float32", True)):
        cfg = with_changes(folder_resnet_config(root), precision={"compute_dtype": dtype})
        prep = device_prep.DevicePrep.from_config(cfg.train_dataset, cfg.precision)
        settings = step_lib.StepSettings(num_classes=CLASSES, smoothing=0.08)
        rec["gradients"][dtype] = gradient_check(
            cfg, f"resnet50 folder recipe at 136 px, {dtype}", randomize=False,
            hold_gradients=hold,
            prepare=lambda im, la: step_lib.augment(im, la, prep, settings, scale, {}))
    rec["input_bench"] = bench
    return rec


def train_input_bench_row(trainer, label: str) -> dict:
    """(e) the ported train_input_bench on a Trainer that has trained."""
    from hvt_torch.tools import train_input_bench

    row = train_input_bench.measure(trainer, INPUT_BENCH_STEPS)
    log(f"  (e) {label}: host {row['host_only_img_s']:.1f}, device {row['device_only_img_s']:.1f}, "
        f"combined {row['combined_img_s']:.1f} img/s; overlap predicts "
        f"{row['predicted_overlap_img_s']:.1f}, serial {row['predicted_serial_img_s']:.1f}; "
        f"overlap efficiency {row['overlap_efficiency']:.3f} ({row['workers']} workers, "
        f"decoder {row['decoder']}); host ms of a step call: {row['step_call_ms_alone']:.2f} "
        f"alone, {row['step_call_ms_in_loop']:.2f} in the loop (median)")
    return row


SWIN_HOST_AUG = ({"cls": "RandAugment", "args": {"depth": 1, "severity": 9}},
                 {"cls": "ColOut", "args": {"p_row": 0.05, "p_col": 0.05}},
                 {"cls": "MixUp", "args": {"alpha": 0.2}})
SWIN_DEVICE_AUG = ({"cls": "RandAugment", "args": {"depth": 1, "severity": 9, "device": True}},
                   {"cls": "ColOut", "args": {"p_row": 0.05, "p_col": 0.05, "device": True}},
                   {"cls": "CutMix", "args": {"alpha": 1.0}})


def folder_swin(root: str, native: bool) -> dict:
    """(d), and (e) for its model."""
    out = {}
    for label, algos in (("host RandAugment + ColOut, MixUp", SWIN_HOST_AUG),
                         ("device RandAugment + ColOut, CutMix", SWIN_DEVICE_AUG)):
        rec, trainer = train_run(folder_swin_config(root, algos),
                                 {k: 12 for k in TRAIN_KERNELS[True]}, f"swinv2_tiny fuse=True {label}",
                                 EVAL_PER_FORWARD["swinv2_tiny fuse=True"])
        if native and trainer.train_loader.decoder != "native":
            raise AssertionError(f"(d) {label}: decoder {trainer.train_loader.decoder}")
        rec["device_ms"] = resident_step_ms(trainer, 1.0)
        rec["busy_share"] = rec["device_ms"] / rec["step_ms_median"]
        log(f"  (d) {label}: {rec['step_ms_median']:.2f} ms a step in the loop "
            f"({rec['images_per_s']:.1f} img/s), the step alone {rec['device_ms']:.2f} ms: busy "
            f"{100 * rec['busy_share']:.1f}%")
        rec["input_bench"] = train_input_bench_row(trainer, f"swinv2_tiny {label}")
        out[label] = rec
        del trainer
    return out


def _uint8_close(a, b, what: str, exact: bool) -> dict:
    d = (a.cpu().int() - b.int()).abs()
    share = float((d > 0).float().mean())
    if (exact and share > 0) or int(d.max()) > 1 or share >= 0.01:
        raise AssertionError(f"{what}: card vs CPU max |Δ| {int(d.max())} on {share:.4%} of pixels")
    return {"max": int(d.max()), "share": share}


def _float_close(a, b, what: str, bf16: bool) -> float:
    import torch

    a, b = a.cpu().float(), b.float()
    if bf16:  # one ulp at the CPU's value plus one ulp of max|x| (an intermediate rounded apart)
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
        ulp = ulp + 2.0 ** (math.floor(math.log2(float(b.abs().max()))) - 7)
        ok = bool(((a - b).abs() <= ulp).all())
    else:
        ok = float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    if not ok:
        raise AssertionError(f"{what}: card vs CPU max |Δ| {float((a - b).abs().max()):.3g}")
    return float((a - b).abs().max())


def augment_checks(card: str) -> dict:
    """(f) every device augmentation on the card against the same function on
    the CPU, the same draws (made on the card, copied), at 224 px: each
    RandAugment op (pointwise equal, geometric within 1 on under 1% of
    pixels), both policies and ColOut (within 1 on under 1%), MixUp and
    CutMix (f32 within 1e-5·max, bf16 within an ulp), progressive_resize at
    every bucket (f32 within 1e-5·max|x|, bf16 within one ulp of the value
    plus one of max|x|); then each timed on the card at the batches the
    recipes train (ResNet-50 256, SwinV2-T 128)."""
    import numpy as np
    import torch

    from hvt_torch.data import device as dp
    from hvt_torch.data import randaugment as ra

    rng = np.random.default_rng(41)
    b = AUG_CHECK_BATCH
    gy, gx = np.mgrid[0:224, 0:224]
    base = np.stack([gx, gy, (gx + gy) // 2], -1)
    host = (base[None] + rng.integers(0, 64, (b, 224, 224, 3))).clip(0, 255).astype(np.uint8)
    x_cpu = torch.from_numpy(host)
    x = x_cpu.cuda()
    gen = torch.Generator("cuda").manual_seed(43)
    out = {"ops": {}, "policies": {}, "resize": {}}
    coin = torch.rand(b, generator=gen, device="cuda")
    sign = torch.where(coin < 0.5, 1.0, -1.0)
    factor = ra._factor(sign, 9)
    for name in ra.OP_NAMES:
        got = ra._apply_op_static(name, x, sign, factor, 9)
        ref = ra._apply_op_static(name, x_cpu, sign.cpu(), factor.cpu(), 9)
        out["ops"][name] = _uint8_close(got, ref, f"RandAugment {name}",
                                        exact=name not in ("rotate", "shear_x", "shear_y",
                                                           "translate_x", "translate_y"))
    for stratified in (True, False):
        draws = ra.draw_rand_augment(gen, b, 1, stratified, "cuda")
        got = ra.rand_augment(x, draws, 9, stratified)
        ref = ra.rand_augment(x_cpu, [(c.cpu(), s.cpu()) for c, s in draws], 9, stratified)
        out["policies"]["stratified" if stratified else "iid"] = _uint8_close(
            got, ref, f"RandAugment stratified={stratified}", exact=False)
    draws = dp.draw_colout(gen, b, 224, 224, 0.05, 0.05, "cuda")
    out["colout"] = _uint8_close(dp.colout(x, draws), dp.colout(x_cpu, tuple(d.cpu() for d in draws)),
                                 "ColOut", exact=False)
    xf = torch.randn((b, 224, 224, 3), generator=gen, device="cuda")
    onehot = dp.prepare_targets(torch.randint(0, 100, (b,), generator=gen, device="cuda"), 100, 0.1)
    lam = dp.draw_beta(gen, 0.2, "cuda")
    cut = dp.draw_cutmix(gen, 1.0, 224, 224, "cuda")
    for dtype in (torch.float32, torch.bfloat16):
        xd = xf.to(dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, fn, args in (("mixup", dp.mixup, (lam,)), ("cutmix", dp.cutmix, cut)):
            gi, gt = fn(xd, onehot, *args)
            ri, rt = fn(xd.cpu(), onehot.cpu(), *(a.cpu() for a in args))
            out[f"{name}_{tag}"] = max(_float_close(gi, ri, f"{name} {tag}", dtype == torch.bfloat16),
                                       _float_close(gt, rt, f"{name} targets {tag}", False))
        for scale in (0.5, 0.625, 0.75, 0.875):
            got = dp.progressive_resize(xd, scale)
            out["resize"][f"{scale} {tag}"] = _float_close(
                got, dp.progressive_resize(xd.cpu(), scale), f"resize {scale} {tag}",
                dtype == torch.bfloat16)
    log(f"  (f) card vs CPU, the same draws, batch {b} at 224 px: RandAugment ops "
        + ", ".join(f"{k} {v['max']}/{100 * v['share']:.3f}%" for k, v in out["ops"].items())
        + "; policies " + ", ".join(f"{k} {v['max']}/{100 * v['share']:.3f}%"
                                    for k, v in out["policies"].items())
        + f"; ColOut {out['colout']['max']}/{100 * out['colout']['share']:.3f}% (max |Δ| / share of "
        f"pixels); MixUp, CutMix, resize max |Δ| " + ", ".join(
            f"{k} {v:.3g}" for k, v in {**{k: v for k, v in out.items() if k.startswith(('mixup', 'cutmix'))},
                                        **out["resize"]}.items()))
    times = {}
    for batch in (RESNET_BATCH, TRAIN_BATCH):
        xb = torch.from_numpy(np.concatenate([host] * (batch // b))).cuda()
        xn = torch.randn((batch, 224, 224, 3), device="cuda", dtype=torch.bfloat16)
        oh = dp.prepare_targets(torch.zeros(batch, dtype=torch.long, device="cuda"), CLASSES, 0.1)
        t = times[batch] = {}
        for stratified in (True, False):
            d = ra.draw_rand_augment(gen, batch, 1, stratified, "cuda")
            t[f"randaugment {'stratified' if stratified else 'iid'}"] = cuda_time_ms(
                lambda: ra.rand_augment(xb, d, 9, stratified), iters=5, warmup=1)
        d = dp.draw_colout(gen, batch, 224, 224, 0.05, 0.05, "cuda")
        t["colout"] = cuda_time_ms(lambda: dp.colout(xb, d), iters=5, warmup=1)
        t["mixup"] = cuda_time_ms(lambda: dp.mixup(xn, oh, lam), iters=5, warmup=1)
        t["cutmix"] = cuda_time_ms(lambda: dp.cutmix(xn, oh, *cut), iters=5, warmup=1)
        for scale in (0.5, 0.625, 0.75, 0.875):
            t[f"resize {scale}"] = cuda_time_ms(lambda: dp.progressive_resize(xn, scale),
                                                iters=5, warmup=1)
        log(f"  (f) device ms at batch {batch} (224 px, bf16 after normalize) on {card}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
        del xb, xn
    out["ms"] = times
    torch.cuda.empty_cache()
    return out


def folder_resume(root: str) -> dict:
    """(g) ResNet-50 from the fixture with every augmentation on (device
    RandAugment and ColOut, MixUp, CutMix, the recipe's ProgressiveResizing
    crossing buckets): resumed from step RESNET_CKPT_AT of
    FOLDER_RESUME_STEPS, as phase 14's check."""
    algos = ({"cls": "RandAugment", "args": {"depth": 1, "severity": 9, "device": True}},
             {"cls": "ColOut", "args": {"p_row": 0.05, "p_col": 0.05, "device": True}},
             {"cls": "MixUp", "args": {"alpha": 0.2}}, {"cls": "CutMix", "args": {"alpha": 1.0}})
    cfg = folder_resnet_config(root, FOLDER_RESUME_STEPS, algos, eval_batch=RESNET_BATCH)
    rec, trainer, _ = resume_check("resnet50 folder, every augmentation", "augmented", cfg,
                                   FOLDER_RESUME_STEPS, RESNET_CKPT_AT,
                                   {k: RESNET_BN_LAYERS for k in BN_KERNELS}, {})
    del trainer
    clear_runs()
    return rec


def input_phase(card: str, host: dict) -> dict:
    """Phase 15 (a)-(g)."""
    fx = write_fixture()
    root = fx["root"]
    native = host["libjpeg"]
    if not native:
        log("  phase 15 runs on Pillow: phase 1 found no libjpeg on this host")
    out = {"fixture": fx, "native_expected": native}
    out["loader"] = loader_rates(root, native, host["cpu_count"] or 1)
    log(f"  (c) ResNet-50, configs/pretrain/inat21.yaml from the fixture (batch 256, bn_pallas, "
        f"{FOLDER_STEPS} steps)")
    out["resnet50"] = folder_resnet(root, native, card)
    clear_runs()
    log("  (d) SwinV2-T fuse: true from the fixture, batch 128, twice")
    out["swinv2_tiny"] = folder_swin(root, native)
    clear_runs()
    log("  (f) the device augmentations on the card against the CPU")
    out["augment"] = augment_checks(card)
    log("  (g) resume with every augmentation on")
    out["resume"] = folder_resume(root)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the downstream entry points on the card
# ---------------------------------------------------------------------------

FEATURE_TRAIN = 20_480  # (a): the synthetic train split, about 2 images of each class
FEATURE_EVAL = 4_096
RESNET_FEATURE_BATCH = 4_096  # configs/simpleshot/r50_base.yaml's
SWIN_FEATURE_BATCH = EVAL_BATCH  # the fused kernels' row tiles take at most 2,675 images at 224 px
FEATURE_CHECK_ROWS = 256
FEATURE_COSINE = 0.999
TIE_RTOL = 1e-9  # (b): nearest centroids closer than this are a tie within f64 rounding
PROBE_CLASSES = 1_000  # (c): rand_species_10shot's shape at a tenth of iNat21's classes
PROBE_SHOTS, PROBE_TEST_SHOTS = 10, 2
INAT_PROBE_SHOTS = 3  # (c): one fit of one alpha at iNat21's 10,000 classes
INAT_PROBE_MAX_ITER = 300
PROBE_AGREE = 0.995
PROBE_OBJECTIVE_RTOL = 1e-4
CPU_PROBE_ITERS = 5  # (c): the CPU's f64 fit against the card's, iterations
CPU_PROBE_RTOL = 1e-8
DOWNSTREAM_FIXTURE = (40, 400, 80)  # (d): classes, train and val JPEGs
BENCH_CLIENTS, BENCH_REQUESTS, BENCH_BATCH = 8, 12, 8  # (f)
SWIN_FEATURE_PER_BATCH = {"mlp_half_fwd": 12, "attention_half_nhwc_fwd": 12}


def exp_file(layer: dict) -> str:
    """``layer`` as a YAML file under the run root: the layers given to
    ``config.load`` merge before ``${...}`` interpolations resolve."""
    import yaml

    fd, path = tempfile.mkstemp(suffix=".yaml", dir=runs_root())
    with os.fdopen(fd, "w") as f:
        yaml.safe_dump(layer, f)
    return path


def downstream_config(exps, layer: dict):
    """configs/machines/local.yaml, the repository's ``exps`` and ``layer``,
    with the run root as save_root and no wandb."""
    from hvt_torch import config as config_lib

    base = {"machine": {"save_root": str(runs_root())}, "save": {"wandb": False}}
    layer = {**layer, "machine": {**base["machine"], **layer.get("machine", {})}}
    return config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs" / e) for e in exps]
                           + [exp_file({**base, **layer})])


def synthetic_splits(train: int, evaluate: int, batch: int) -> dict:
    return {f"{split}_dataset": {"source": "synthetic", "path": "", "synthetic_num_classes": CLASSES,
                                 "synthetic_num_samples": n, "global_batch_size": batch}
            for split, n in (("train", train), ("eval", evaluate))}


def write_backbone(name: str) -> str:
    """A seeded model's weights as a torch:// file (SwinV2 drawn with
    randomize_, ResNet at its seeded init), the PretrainedBackbone of
    phase 16's configs."""
    from hvt_torch import config as config_lib
    from hvt_torch.models import build_model
    from hvt_torch.models import torch_compat
    from hvt_torch.train import ema as ema_lib

    model = build_model(config_lib.loads({"model": {"name": name}}), CLASSES)
    path = runs_root() / f"{name}.pt"
    if name.startswith("swinv2"):
        randomize_(model, seed=16)
        torch_compat.save_swin_checkpoint(dict(model.named_parameters()), str(path))
    else:
        torch_compat.save_resnet_checkpoint(dict(model.named_parameters()),
                                            ema_lib.batch_stats(model), str(path))
    return f"torch://{path}"


@contextlib.contextmanager
def recorded_feature_steps():
    """``build_feature_step`` wrapped: each step built is recorded with its
    model and prep, and each of its calls timed with CUDA events."""
    import torch

    from hvt_torch.train import step as step_lib

    built, calls = [], []
    build_feature_step = step_lib.build_feature_step

    def build(model, prep):
        step = build_feature_step(model, prep)
        built.append((model, prep))

        def timed(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*args)
            end.record()
            calls.append((start, end))
            return out

        return timed

    with swapped(step_lib, build_feature_step=build):
        yield built, calls


def feature_run(label: str, config, batch: int, per_batch: dict):
    """(a) ``extract_features`` on both splits, the launch counters set to 0
    just before and read just after (``per_batch`` launches of each kernel a
    feature batch, no other kernel); ms a batch (CUDA events), img/s (host
    clock, the model's build and weights included), peak memory; one batch
    through the kernels against the plain path; a second call that hits
    the cache builds no step and launches nothing. → (record, {split:
    (features, labels)}, (model, prep))."""
    import numpy as np
    import torch

    from hvt_torch.downstream import features as features_lib

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec, data = {}, {}
    with recorded_feature_steps() as (built, calls):
        for split, is_train, n in (("train", True, FEATURE_TRAIN), ("eval", False, FEATURE_EVAL)):
            first = len(calls)
            t0 = time.perf_counter()
            feats, labels = features_lib.extract_features(config, is_train, "simpleshot")
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            ms = sorted(s.elapsed_time(e) for s, e in calls[first:])
            if feats.shape[0] != n or labels.shape != (n,) or not np.isfinite(feats).all():
                raise AssertionError(f"{label} {split}: features {feats.shape}, labels {labels.shape}")
            rec[split] = {"images": n, "batches": len(ms), "seconds": seconds,
                          "images_per_s": n / seconds, "batch_ms_median": ms[len(ms) // 2],
                          "device_images_per_s": batch / ms[len(ms) // 2] * 1e3}
            data[split] = (feats, labels)
    rec["dim"] = int(data["train"][0].shape[1])
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: c.launches for name, c in counters.items()}
    batches = rec["train"]["batches"] + rec["eval"]["batches"]
    for name, n in launches.items():
        if n != per_batch.get(name, 0) * batches:
            raise AssertionError(f"{label}: {name} launched {n} times over {batches} feature "
                                 f"batches, expected {per_batch.get(name, 0)} a batch")
    rec["launches"] = {k: v for k, v in launches.items() if v}

    model, prep = built.pop(0)
    images = np.random.default_rng(16).integers(0, 256, (FEATURE_CHECK_ROWS, 224, 224, 3), np.uint8)
    with torch.inference_mode():
        x = prep.normalize(torch.from_numpy(images).cuda())
        got = model(x, features_only=True).float()
        with plain_versions():
            ref = model(x, features_only=True).float()
        cosine = float(torch.nn.functional.cosine_similarity(got, ref, dim=1).min())
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (cosine >= FEATURE_COSINE and err <= LOGIT_TOL * scale):
        raise AssertionError(f"{label}: features through the kernels against the plain path: worst "
                             f"cosine {cosine:.6f}, max|Δ| {err:.4g} (scale {scale:.4g})")
    rec["plain_check"] = {"rows": FEATURE_CHECK_ROWS, "min_cosine": cosine, "max_abs_err": err,
                          "max_abs": scale}
    del got, ref, x

    for c in counters.values():
        c.launches = 0
    with recorded_feature_steps() as (built, calls):
        t0 = time.perf_counter()
        feats, labels = features_lib.extract_features(config, True, "simpleshot")
        hit_s = time.perf_counter() - t0
    if built or calls or any(c.launches for c in counters.values()) or not (
            np.array_equal(feats, data["train"][0]) and np.array_equal(labels, data["train"][1])):
        raise AssertionError(f"{label}: a cache hit ran a forward or returned other features")
    rec["cache_hit_s"] = hit_s
    log(f"  (a) {label}: {rec['dim']}-d features of {FEATURE_TRAIN} + {FEATURE_EVAL} images in "
        f"{rec['train']['batches']} + {rec['eval']['batches']} batches of {batch}: "
        f"{rec['train']['images_per_s']:.1f} / {rec['eval']['images_per_s']:.1f} img/s (host clock, "
        f"model build included), {rec['train']['batch_ms_median']:.2f} ms a batch on the card "
        f"({rec['train']['device_images_per_s']:.1f} img/s); peak {rec['peak_memory_gib']:.2f} GiB; "
        f"launches {rec['launches'] or 'none (no kernel in this eval path)'}; against the plain path "
        f"on {FEATURE_CHECK_ROWS} images: worst cosine {cosine:.6f}, max|Δ| {err:.4g} (tol "
        f"{LOGIT_TOL}·{scale:.4g}); the cache hit {hit_s:.2f} s, no forward")
    return rec, data, (model, prep)


def simpleshot_check(label: str, train, test, exact: bool) -> dict:
    """(b) flat SimpleShot (cl2n, l2n) on the card against the same fit on
    the CPU in f64: predictions equal; with ``exact`` false a row may
    differ only where the CPU's two nearest centroids tie within TIE_RTOL
    (hvt's synthetic source repeats 64 images, so its classes share
    centroids)."""
    import numpy as np
    import torch

    from hvt_torch.downstream import centroid as centroid_lib
    from hvt_torch.downstream import features as features_lib

    (x_train, y_train), (x_test, y_test) = train, test
    out = {}
    for variant in ("cl2n", "l2n"):
        xs = [x_train, x_test]
        if variant == "cl2n":
            xs = [features_lib.center(x) for x in xs]
        xs = [features_lib.l2_normalize(x) for x in xs]
        t0 = time.perf_counter()
        card = centroid_lib.NearestCentroid(device="cuda").fit(xs[0], y_train)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds = card.predict(xs[1])
        predict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = centroid_lib.NearestCentroid().fit(xs[0], y_train)
        cpu_preds = cpu.predict(xs[1])
        cpu_s = time.perf_counter() - t0
        differ = np.flatnonzero(preds != cpu_preds)
        ties = 0
        if differ.size:
            d = torch.cdist(torch.from_numpy(xs[1][differ]).double(), cpu.centroids_)
            two = d.topk(2, dim=1, largest=False).values
            ties = int(((two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 0]).sum())
        if (exact and differ.size) or ties != differ.size:
            raise AssertionError(f"{label} {variant}: the card's SimpleShot predicts {differ.size} "
                                 f"rows otherwise than the CPU's f64 fit ({ties} of them ties)")
        acc = float(np.mean(preds == y_test))
        out[variant] = {"acc@1": acc, "fit_s": fit_s, "predict_s": predict_s, "cpu_s": cpu_s,
                        "rows": int(len(y_test)), "classes": int(card.classes_.size),
                        "differ_at_ties": int(differ.size)}
        log(f"  (b) {label} {variant}: {card.classes_.size} centroids, acc@1 {acc:.4f}; card fit "
            f"{fit_s * 1e3:.1f} ms, predict {predict_s * 1e3:.1f} ms ({len(y_test)} rows); the CPU "
            f"(f64) {cpu_s:.2f} s; predictions equal"
            + (f" but on {differ.size} rows whose nearest centroids tie" if differ.size else ""))
    return out


def clustered_features(model, prep, classes: int, shots: int, draw: int, pattern_seed: int = 16):
    """ResNet-50 features of seeded class images: each class a 7x7 colour
    pattern (``pattern_seed``), bilinear to 224 px, plus noise (``draw``),
    through the feature step, rows in a seeded order → (features f32
    numpy, labels)."""
    import numpy as np
    import torch

    from hvt_torch.train import ema as ema_lib
    from hvt_torch.train import step as step_lib

    gen = torch.Generator(device="cuda").manual_seed(pattern_seed)
    patterns = 128 + 40 * torch.randn((classes, 3, 7, 7), generator=gen, device="cuda")
    gen.manual_seed(1000 * pattern_seed + draw)
    labels = np.random.default_rng(draw).permutation(np.repeat(np.arange(classes), shots))
    step = step_lib.build_feature_step(model, prep)
    params, stats = dict(model.named_parameters()), ema_lib.batch_stats(model)
    feats = []
    for start in range(0, labels.size, RESNET_FEATURE_BATCH):
        rows = torch.from_numpy(labels[start:start + RESNET_FEATURE_BATCH]).cuda()
        img = torch.nn.functional.interpolate(patterns[rows], size=(224, 224), mode="bilinear")
        img = img + 50 * torch.randn(img.shape, generator=gen, device="cuda")
        images = img.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        feats.append(step(params, stats, images).cpu())
    return torch.cat(feats).numpy(), labels


def probe_check(model, prep) -> dict:
    """(c) the linear probe's whole grid search on the card (f32) on
    ResNet-50 features of PROBE_CLASSES seeded classes × PROBE_SHOTS, held
    against the same grid in f64 on the card (alpha, ≥ 99.5% of the test
    predictions, the objective within 1e-4), the card's f64 fit against the
    CPU's over CPU_PROBE_ITERS iterations (within 1e-8), each fold's fit
    timed; then one fit of one alpha at CLASSES classes × INAT_PROBE_SHOTS."""
    import numpy as np
    import torch

    from hvt_torch.downstream import linear as linear_lib

    x, y = clustered_features(model, prep, PROBE_CLASSES, PROBE_SHOTS, draw=1, pattern_seed=161)
    x_test, y_test = clustered_features(model, prep, PROBE_CLASSES, PROBE_TEST_SHOTS, draw=2,
                                        pattern_seed=161)
    out, fits = {}, {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        t0 = time.perf_counter()
        fits[name] = linear_lib.LinearProbe(device="cuda", dtype=dtype).fit(x, y)
        seconds = time.perf_counter() - t0
        probe = fits[name]
        preds = probe.predict(x_test)
        out[name] = {"seconds": seconds, "best_alpha": probe.best_alpha_,
                     "mean_scores": probe.mean_scores_.tolist(), "fold_fits": probe.fold_fits_,
                     "refit": {"objective": probe.model_.objective,
                               "iterations": probe.model_.iterations, "stop": probe.model_.stop},
                     "test_acc": float(np.mean(preds == y_test)), "preds": preds}
        log(f"  (c) {name} grid on the card, {PROBE_CLASSES} classes x {PROBE_SHOTS} shots "
            f"({len(y)} x {x.shape[1]}): {seconds:.2f} s, alpha {probe.best_alpha_} (mean fold "
            f"accuracy {probe.mean_scores_.round(4).tolist()}), test acc@1 "
            f"{out[name]['test_acc']:.4f}; refit {probe.model_.iterations} iterations "
            f"({probe.model_.stop}), objective {probe.model_.objective:.10g}; each fold's fit (s, "
            "iterations, stop): " + "; ".join(
                f"alpha {a}: " + ", ".join(f"{f['seconds']:.2f}/{f['iterations']}/{f['stop'][0]}"
                                           for f in probe.fold_fits_ if f["alpha"] == a)
                for a in linear_lib.ALPHAS))
    agree = float(np.mean(out["f32"]["preds"] == out["f64"]["preds"]))
    obj32, obj64 = out["f32"]["refit"]["objective"], out["f64"]["refit"]["objective"]
    fold_rel = max(abs(a["objective"] - b["objective"]) / b["objective"]
                   for a, b in zip(out["f32"]["fold_fits"], out["f64"]["fold_fits"]))
    if not (out["f32"]["best_alpha"] == out["f64"]["best_alpha"] and agree >= PROBE_AGREE
            and abs(obj32 - obj64) <= PROBE_OBJECTIVE_RTOL * obj64
            and fold_rel <= PROBE_OBJECTIVE_RTOL):
        raise AssertionError(f"(c) f32 probe against f64: alpha {out['f32']['best_alpha']} / "
                             f"{out['f64']['best_alpha']}, predictions agree on {agree:.4f}, "
                             f"objective {obj32} / {obj64}, worst fold {fold_rel:.3g}")
    log(f"  (c) f32 against f64: the same alpha, test predictions equal on {100 * agree:.2f}% of "
        f"{len(y_test)} rows, refit objective within {abs(obj32 - obj64) / obj64:.3g} relative "
        f"(each fold's within {fold_rel:.3g}; tol {PROBE_OBJECTIVE_RTOL})")
    # the CPU's f64 fit against the card's, over the first iterations of the refit
    alpha = out["f64"]["best_alpha"]
    t0 = time.perf_counter()
    cpu = linear_lib.fit_ovr(torch.from_numpy(x).double(), y, alpha, max_iter=CPU_PROBE_ITERS)
    cpu_s = time.perf_counter() - t0
    card = linear_lib.fit_ovr(torch.from_numpy(x).double().cuda(), y, alpha,
                              max_iter=CPU_PROBE_ITERS)
    rel = abs(cpu.objective - card.objective) / cpu.objective
    cpu_agree = float(np.mean(cpu.predict(torch.from_numpy(x_test).double())
                              == card.predict(torch.from_numpy(x_test).double().cuda())))
    if not (rel <= CPU_PROBE_RTOL and cpu_agree >= PROBE_AGREE):
        raise AssertionError(f"(c) the CPU's f64 fit against the card's: objective {cpu.objective} "
                             f"/ {card.objective}, predictions agree on {cpu_agree:.4f}")
    log(f"  (c) the CPU's f64 refit against the card's over {CPU_PROBE_ITERS} iterations: objective "
        f"within {rel:.3g} relative (tol {CPU_PROBE_RTOL}), test predictions equal on "
        f"{100 * cpu_agree:.2f}%; the CPU took {cpu_s:.1f} s")
    out["cpu_f64"] = {"iterations": CPU_PROBE_ITERS, "objective_rel": rel, "agree": cpu_agree,
                      "seconds": cpu_s}
    out["f32_f64_agree"] = agree
    for name in ("f32", "f64"):
        out[name]["preds"] = None
    del fits, x_test

    # one fit of one alpha at iNat21's width
    x, y = clustered_features(model, prep, CLASSES, INAT_PROBE_SHOTS, draw=1, pattern_seed=163)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = linear_lib.fit_ovr(torch.from_numpy(x).cuda(), y, alpha, max_iter=INAT_PROBE_MAX_ITER)
    seconds = time.perf_counter() - t0
    train_acc = float(np.mean(fit.predict(torch.from_numpy(x).cuda()) == y))
    out["inat_width"] = {"classes": CLASSES, "rows": int(len(y)), "alpha": alpha, "seconds": seconds,
                         "iterations": fit.iterations, "stop": fit.stop,
                         "max_iter": INAT_PROBE_MAX_ITER,
                         "ms_per_iteration": seconds / max(fit.iterations, 1) * 1e3,
                         "objective": fit.objective, "train_acc": train_acc,
                         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  (c) one f32 fit at alpha {alpha}, {CLASSES} classes x {INAT_PROBE_SHOTS} shots "
        f"({len(y)} x {x.shape[1]}): {seconds:.2f} s, {fit.iterations} iterations "
        f"(stop: {fit.stop}; "
        f"{out['inat_width']['ms_per_iteration']:.1f} ms an iteration), train acc@1 "
        f"{train_acc:.4f}, peak {out['inat_width']['peak_memory_gib']:.2f} GiB")
    return out


def entry_points(resnet_uri: str, swin_uri: str) -> dict:
    """(d) hvt_torch.simpleshot.main (r50_hierarchical.yaml), linear_probe.main
    (linear_probe/r50_base.yaml) and predict's run (a multitask SwinV2-T on
    fuse: true, flat and --hierarchical, against the plain path's top-1) on
    a JPEG fixture of taxonomy-shaped classes (loader_bench's make_fixture)."""
    import numpy as np

    from hvt_torch import linear_probe, simpleshot
    from hvt_torch.downstream import predict as predict_lib
    from hvt_torch.tools import loader_bench

    classes, n_train, n_val = DOWNSTREAM_FIXTURE
    root = pathlib.Path(tempfile.mkdtemp(prefix="hvt-chip-downstream-"))
    _FIXTURES.append(root)
    loader_bench.make_fixture(root, n_train, n_val, classes=classes, workers=os.cpu_count() or 1)
    data = {"machine": {"save_root": str(runs_root()), "datasets": {"fix": str(root)}},
            "train_dataset": {"source": "imagefolder", "path": "fix"},
            "eval_dataset": {"source": "imagefolder", "path": "fix"}}
    out = {}
    with trainer_output():
        out["simpleshot"] = simpleshot.main(downstream_config(
            ["simpleshot/r50_base.yaml", "simpleshot/r50_hierarchical.yaml"],
            {**data, "model": {"pretrained_checkpoint": resnet_uri}}))
        out["linear_probe"] = linear_probe.main(downstream_config(
            ["linear_probe/r50_base.yaml"], {**data, "model": {"pretrained_checkpoint": resnet_uri}}))
    log(f"  (d) {n_train} + {n_val} JPEGs over {classes} classes: hvt_torch.simpleshot "
        f"(r50_hierarchical.yaml) {out['simpleshot']}; hvt_torch.linear_probe "
        f"(linear_probe/r50_base.yaml) {out['linear_probe']}")
    counters = kernel_counters()
    cfg = downstream_config(["pretrain/swinv2_tiny.yaml"], {
        **data, "model": {"args": {"fuse": True}, "pretrained_checkpoint": swin_uri},
        "hierarchy": {"variant": "multitask"},
        "eval_dataset": {"source": "imagefolder", "path": "fix", "global_batch_size": BATCH}})
    forwards = -(-n_val // BATCH)
    for hierarchical in (False, True):
        label = "hierarchical" if hierarchical else "flat"
        for c in counters.values():
            c.launches = 0
        path = runs_root() / f"predict-{label}.jsonl"
        with trainer_output():
            summary = predict_lib.run(cfg, str(path), topk=5, hierarchical=hierarchical)
        launches = {name: c.launches for name, c in counters.items()}
        with plain_versions():
            plain = list(predict_lib.predict(cfg, topk=5, hierarchical=hierarchical))
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        decided = [len(p["probs"]) < 2 or p["probs"][0] - p["probs"][1] > TOP1_MARGIN for p in plain]
        same = [r["class_ids"][0] == p["class_ids"][0] for r, p in zip(rows, plain)]
        for name, n in launches.items():
            if n != SWIN_FEATURE_PER_BATCH.get(name, 0) * forwards:
                raise AssertionError(f"(d) predict {label}: {name} launched {n} times over "
                                     f"{forwards} forwards")
        if len(rows) != n_val or summary["count"] != n_val or not all(
                s for s, d in zip(same, decided) if d):
            raise AssertionError(f"(d) predict {label}: {len(rows)} rows for {n_val} images, top-1 "
                                 f"equal to the plain path's on {sum(same)}")
        out[f"predict_{label}"] = {**summary, "launches": {k: v for k, v in launches.items() if v},
                                   "top1_equal": int(sum(same)), "top1_decided": int(sum(decided))}
        log(f"  (d) hvt_torch.predict run, multitask SwinV2-T fuse: true, {label}: {len(rows)} JSONL "
            f"rows for {n_val} val images, top1 {summary['top1']:.4f} topk {summary['topk']:.4f}; "
            f"top-1 equal to the plain path's on {sum(same)}/{len(rows)} rows ({sum(decided)} with a "
            f"top-2 margin > {TOP1_MARGIN}, all equal); launches {out[f'predict_{label}']['launches']}"
            + ("; tier ids on every row" if hierarchical and all(len(r["tier_ids"]) == 7
                                                                for r in rows) else ""))
        if hierarchical and not all(len(r["tier_ids"]) == 7 for r in rows):
            raise AssertionError("(d) predict --hierarchical: a row without its 7 tier ids")
    if not (np.isfinite(list(out["simpleshot"].values())).all()
            and np.isfinite(list(out["linear_probe"].values())).all()):
        raise AssertionError(f"(d) metrics not finite: {out}")
    return out


def serve_bench_runs() -> dict:
    """(f) hvt_torch.tools.serve_bench on SwinV2-T fuse: true (10,000 classes),
    engine mode and --http, BENCH_CLIENTS clients × BENCH_REQUESTS requests."""
    from hvt_torch.tools import serve_bench

    exp = exp_file({
        "model": {"args": {"fuse": True}}, "save": {"wandb": False},
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": BATCH, "global_batch_size": BATCH}})
    out = {}
    for mode in ("engine", "http"):
        argv = ["--machine", str(ROOT / "configs/machines/local.yaml"), "--exp",
                str(ROOT / "configs/pretrain/swinv2_tiny.yaml"), exp, "--clients", str(BENCH_CLIENTS),
                "--requests", str(BENCH_REQUESTS), "--batch", str(BENCH_BATCH)]
        rec = serve_bench.main(argv + (["--http"] if mode == "http" else []))  # prints its line
        if rec["failed_requests"] or rec["mode"] != mode:
            raise AssertionError(f"(f) serve_bench {mode}: {rec}")
        out[mode] = rec
    return out


def downstream_phase(card: str) -> dict:
    """Phase 16 (a)-(f)."""
    import torch

    out = {}
    resnet_uri, swin_uri = write_backbone("resnet50"), write_backbone("swinv2_tiny")
    log(f"  (a) features from the synthetic source at {CLASSES} classes through extract_features")
    resnet_cfg = downstream_config(["simpleshot/r50_base.yaml"], {
        "model": {"variant": "simpleshot", "pretrained_checkpoint": resnet_uri},
        **synthetic_splits(FEATURE_TRAIN, FEATURE_EVAL, RESNET_FEATURE_BATCH)})
    out["features_resnet50"], resnet_data, (model, prep) = feature_run(
        "ResNet-50 (simpleshot/r50_base.yaml)", resnet_cfg, RESNET_FEATURE_BATCH, {})
    swin_cfg = downstream_config(["pretrain/swinv2_tiny.yaml"], {
        "model": {"variant": "simpleshot", "pretrained_checkpoint": swin_uri,
                  "args": {"fuse": True}},
        **synthetic_splits(FEATURE_TRAIN, FEATURE_EVAL, SWIN_FEATURE_BATCH)})
    out["features_swinv2_tiny"], _, _ = feature_run("SwinV2-T fuse: true", swin_cfg,
                                                    SWIN_FEATURE_BATCH, SWIN_FEATURE_PER_BATCH)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"  (b) flat SimpleShot on the card against the CPU in f64, {CLASSES} classes")
    out["simpleshot_synthetic"] = simpleshot_check("ResNet-50, synthetic source",
                                                   resnet_data["train"], resnet_data["eval"],
                                                   exact=False)
    del resnet_data
    out["simpleshot_classes"] = simpleshot_check(
        "ResNet-50, seeded class images (2 shots)", clustered_features(model, prep, CLASSES, 2, 1),
        clustered_features(model, prep, CLASSES, 1, 2), exact=True)

    log(f"  (c) the linear probe's grid search on the card; {PROBE_CLASSES} classes x "
        f"{PROBE_SHOTS} shots is rand_species_10shot's shape cut to a tenth of iNat21's classes")
    out["probe"] = probe_check(model, prep)
    del model, prep
    gc.collect()
    torch.cuda.empty_cache()

    log("  (d) the entry points as users run them, on a JPEG fixture")
    out["entry_points"] = entry_points(resnet_uri, swin_uri)

    log(f"  (e) HTTP serving at batch {BATCH}, {CLASSES} classes: ResNet-50 (inat21.yaml) and "
        f"SwinV2-B fuse: true")
    eval_synthetic = {"eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                                       "synthetic_num_samples": BATCH, "global_batch_size": BATCH}}
    out["serving"] = {}
    for label, exps, layer, per_forward in (
            ("resnet50", ["pretrain/inat21.yaml"], {}, {}),
            ("swinv2_base fuse=True", ["pretrain/swinv2_tiny.yaml"],
             {"model": {"name": "swinv2_base", "args": {"fuse": True}}},
             {"mlp_half_fwd": 24, "attention_half_nhwc_fwd": 24})):
        r = out["serving"][label] = serve_model(downstream_config(exps, {**layer, **eval_synthetic}),
                                                label, per_forward)
        log(f"  (e) {label}: forward {r['forward_ms']:.3f} ms on kernels, {r['forward_plain_ms']:.3f} "
            f"ms on plain versions; engine step {r['step_images_per_s']:.1f} img/s; HTTP "
            f"{r['http_images_per_s']:.1f} img/s, latency p50 {r['http_latency_ms_p50']:.1f} ms p90 "
            f"{r['http_latency_ms_p90']:.1f} ms, on {card}")
        gc.collect()
        torch.cuda.empty_cache()

    log(f"  (f) serve_bench, SwinV2-T fuse: true, {BENCH_CLIENTS} clients x {BENCH_REQUESTS} "
        f"requests, batch {BENCH_BATCH}, engine and --http (one JSON line each)")
    out["serve_bench"] = serve_bench_runs()
    clear_runs()
    return out


# ---------------------------------------------------------------------------
# Phase 17: the rest of training (SAM, accumulation, the BatchNorm options,
# recomputation, ape)
# ---------------------------------------------------------------------------

HOT_STEPS = 12  # (a): SAM (rho 0.5, interval 10) fires at steps 0 and 10
# (a) with bn_pallas false: SAM at step 0, scales 0.5 (steps 0-4), 0.625, 0.75, 0.875, then 1.0
# twice (the first step at each scale also meets cuDNN's first choices at its shapes)
HOT_TORCH_BN_STEPS = 10
SWIN_FULL_STEPS = 4  # (b)
BASE_FULL_STEPS = 2  # (c)
GROUPS_STEPS = 2  # (g)
FULL_EVAL_IMAGES = 256  # each evaluation of (a)-(c) and (g): one synthetic batch
EQUIV_BATCH = 256  # (d), and (g)'s bn_custom step
REMAT_BATCH = 128  # (e)
ACCUM_COSINE = 0.999  # (d): accumulation against one pass, each gradient tensor
ACCUM_LOSS_RTOL = 1e-3
BN_PASS = {k: RESNET_BN_LAYERS for k in BN_KERNELS}  # a ResNet-50 pass's launches
SWIN_PASS = {k: 12 for k in TRAIN_KERNELS[True]}  # a fused SwinV2-T pass's


def full_config(exps, steps: int, **layer):
    """The repository's ``exps`` (under configs/) as written, their global
    batch included, with ``grad_accum: auto``, on the synthetic train source
    at CLASSES classes for ``steps`` steps, evaluated on one synthetic batch
    of FULL_EVAL_IMAGES before the first step and after the last; ``layer``
    merged last."""
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs" / e) for e in exps])
    return config_lib.loads(config_lib.to_dict(base), {
        "max_duration": f"{steps}ba",
        "eval_interval": "1dur",
        "grad_accum": "auto",
        "machine": {"save_root": str(runs_root())},
        "save": {"wandb": False},
        "train_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                          "synthetic_num_samples": base.train_dataset.global_batch_size * steps},
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": FULL_EVAL_IMAGES,
                         "global_batch_size": FULL_EVAL_IMAGES},
    }, layer)


def full_run(config, per_pass: dict, label: str, eval_per_forward: dict, sam_steps=()):
    """Train through ``hvt_torch.main.main(config)`` at the config's batch
    with ``grad_accum: auto``. Every launch counter is set to 0 when the
    Trainer is built, after its memory probe (a candidate that runs out of
    memory launches as many kernels as it reached), and read after the run:
    each kernel of ``per_pass`` must launch that many times per microbatch
    of a pass, a step making one pass or, at ``sam_steps``, two (SAM); each
    of ``eval_per_forward`` that many times an eval batch; every other
    kernel never. The launches of each step are read around it too. CUDA
    events around each step time it on the card; peak memory from the
    Trainer's end of construction. Returns the record and the Trainer."""
    import torch

    from hvt_torch import main as main_lib

    counters = kernel_counters()
    rows, losses, trainers, evals, eval_s = [], [], [], [], []

    class RecordingTrainer(main_lib.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)
            inner = self.train_step

            def timed(*a, **k):
                before = {n: c.launches for n, c in counters.items()}
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                stats = inner(*a, **k)
                end.record()
                rows.append((start, end, a[4], {n: c.launches - before[n]
                                                for n, c in counters.items()}))
                return stats

            self.train_step = timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0

        def _evaluate_at(self, step):
            evals.append(step)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = super()._evaluate_at(step)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            return metrics

    steps = int(config.max_duration.removesuffix("ba"))
    batch = config.train_dataset.global_batch_size
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with swapped(main_lib, Trainer=RecordingTrainer), trainer_output():
        metrics = main_lib.main(config, on_step=lambda step, stats: losses.append(stats["loss_sum"]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    clear_runs()
    trainer = trainers[0]
    accum = trainer.grad_accum
    launches = {name: c.launches for name, c in counters.items()}
    losses = [float(v) for v in losses]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_rows = [{"step": i, "scale": scale, "sam": i in sam_steps, "ms": s.elapsed_time(e),
                  "images_per_s": batch / s.elapsed_time(e) * 1e3,
                  "launches": {k: v for k, v in n.items() if v}}
                 for i, (s, e, scale, n) in enumerate(rows)]
    log(f"  {label}: grad_accum auto resolved to {accum} ({batch // accum} images a microbatch) "
        f"for batch {batch}; {len(losses)} steps: loss {losses[0]:.4f} → {losses[-1]:.4f}; peak "
        f"memory {peak_gib:.2f} GiB; {wall_s:.1f} s in all")
    log("    per step (ms on the card, img/s, scale, SAM): " + "; ".join(
        f"{r['step']}: {r['ms']:.1f} ({r['images_per_s']:.0f}, {r['scale']:.3f}"
        f"{', SAM' if r['sam'] else ''})" for r in step_rows))
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: training losses {losses}")
    if evals != [0, steps]:
        raise AssertionError(f"{label}: evaluations at steps {evals}, expected [0, {steps}]")
    for r in step_rows:
        passes = 2 if r["sam"] else 1
        for name in counters:
            if r["launches"].get(name, 0) != per_pass.get(name, 0) * accum * passes:
                raise AssertionError(f"{label} step {r['step']}: {name} launched "
                                     f"{r['launches'].get(name, 0)} times, expected "
                                     f"{per_pass.get(name, 0) * accum * passes}")
    eval_batches = len(evals) * trainer.eval_loader.batches_per_epoch
    passes = steps + len(sam_steps)
    for name, n in launches.items():
        want = per_pass.get(name, 0) * accum * passes + eval_per_forward.get(name, 0) * eval_batches
        if n != want:
            raise AssertionError(f"{name}: {n} launches in {steps} steps ({passes} passes of "
                                 f"{accum} microbatches) and {eval_batches} eval batches of "
                                 f"{label}, expected {want}")
    log(f"    launches {({k: v for k, v in launches.items() if v})} in {passes} passes of "
        f"{accum} microbatches and {eval_batches} eval batches: as expected")
    return {"label": label, "batch": batch, "grad_accum": accum, "steps": steps,
            "sam_steps": list(sam_steps), "losses": losses, "step_rows": step_rows,
            "launches": launches, "eval_batches": eval_batches, "peak_memory_gib": peak_gib,
            "wall_s": wall_s, "eval_s": eval_s, "metrics": metrics}, trainer


def step_gradients(model, config, batch: int, accum: int = 1, sam_rho=None, seed: int = 17):
    """One step's loss and gradients of ``model`` through the train step's
    gradient pass (``hvt_torch.train.step.build_gradients``: ``accum``
    microbatches, SAM's second pass with ``sam_rho``) on a seeded batch and
    a generator seeded 0, every launch counter 0 just before and read just
    after. Returns (loss, {name: f32 gradient}, {name: buffer}, launches,
    the generator's state after)."""
    import torch

    from hvt_torch import objectives
    from hvt_torch.data import DevicePrep
    from hvt_torch.train import algorithms
    from hvt_torch.train import step as step_lib

    settings = step_lib.StepSettings(
        num_classes=CLASSES, smoothing=algorithms.parse_algorithms(config).label_smoothing,
        grad_accum=accum, sam_rho=sam_rho)
    prep = DevicePrep.from_config(config.train_dataset, config.precision)
    gradients = step_lib.build_gradients(model, objectives.soft_cross_entropy, prep, settings)
    images, labels, mask = train_batch(seed, batch)
    generator = torch.Generator(images.device).manual_seed(0)
    counters = kernel_counters()
    model.train()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    loss, _ = gradients(images, labels, mask, generator, sam=sam_rho is not None)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    return float(loss), grads, buffers, launches, generator.get_state()


def expect_launches(launches: dict, want: dict, label: str) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")


def bit_equal_states(got: dict, ref: dict, label: str) -> None:
    """Raises naming every tensor of ``got`` that differs from ``ref``, with its max|Δ|."""
    import torch

    diff = {n: float((t.double() - ref[n].double()).abs().max()) for n, t in got.items()
            if not torch.equal(t, ref[n])}
    if diff:
        raise AssertionError(f"{label}: {len(diff)} tensors differ: "
                             + "; ".join(f"{n} {d:.3g}" for n, d in list(diff.items())[:8]))


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic convolutions and torch's deterministic
    algorithms (warning where an op has none), then the settings as they
    were: what separates two runs of the same work is then the work."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def twin_models(config, change: dict, seed: int = 13, randomize: bool = True):
    """The model of ``config`` on the card, seeded weights (every SwinV2
    parameter drawn with ``randomize``), and the model of ``config`` with
    the model args ``change`` carrying the same weights and buffers."""
    from hvt_torch.models import build_model

    model = build_model(config, CLASSES).cuda()
    if randomize:
        randomize_(model, seed=seed)
    twin = build_model(with_changes(config, model={"args": change}), CLASSES).cuda()
    twin.load_state_dict(model.state_dict())
    return model, twin


def full_batch_runs(card: str) -> dict:
    """Phase 17 (a)-(c): the repository's 2048-image configs at their
    written batch with ``grad_accum: auto``."""
    import torch

    from hvt_torch.data import device as device_prep

    out = {}
    log(f"  (a) ResNet-50: inat21.yaml + recipes/hot_tpu.yaml (176 px crop, progressive "
        f"resizing, BlurPool, EMA, MixUp, device RandAugment and ColOut, stochastic depth, SAM "
        f"rho 0.5 every 10 updates) with bn_pallas, {HOT_STEPS} steps")
    rec, trainer = full_run(full_config(["pretrain/inat21.yaml", "recipes/hot_tpu.yaml"], HOT_STEPS,
                                        model={"args": {"bn_pallas": True}}),
                            BN_PASS, "resnet50 hot_tpu bn_pallas", {}, sam_steps=(0, 10))
    ema = trainer.ema
    rec["ema_updates"] = ema.updates
    finite = all(bool(torch.isfinite(v).all()) for v in [*ema.params.values(),
                                                         *ema.batch_stats.values()])
    log(f"    EMA: {ema.updates} update (step 0; interval {ema.cfg.update_interval_steps}), "
        f"averaged tensors finite: {finite}")
    if ema.updates != 1 or not finite:
        raise AssertionError(f"(a) EMA updates {ema.updates}, finite {finite}")
    sam_ms = [r["ms"] for r in rec["step_rows"] if r["sam"]]
    full = [r["ms"] for r in rec["step_rows"] if r["scale"] >= 1.0 and not r["sam"]]
    log(f"    SAM steps {', '.join(f'{m:.1f}' for m in sam_ms)} ms; non-SAM steps at the crop "
        f"{', '.join(f'{m:.1f}' for m in full)} ms ({rec['batch'] / min(full) * 1e3:.0f} img/s)")
    micro = rec["batch"] // rec["grad_accum"]
    rec["bn_pair"] = {}
    crop = int(trainer.config.train_dataset.crop_size)
    sam_sizes = {crop if s >= 1.0 else device_prep.resized_size(crop, s)
                 for s in (trainer._scale_for_step(k) for k in (0, 10))}
    for size in sorted(sam_sizes):  # the sizes SAM's steps ran at
        shapes = bn_shapes_at(trainer.model, size)
        bn_records(False, shapes, batch=micro)
        timed = bn_records(True, shapes, batch=micro, plain_iters=2)  # plain: ~1 s a step
        rec["bn_pair"][size] = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
                                for k, v in timed.items()}
        rec["bn_pair"][size]["bn_train"] = bn_train_times(shapes, micro, plain_iters=2)
        log(f"    bn_train's four calls at {size} px, microbatch {micro} (53 calls each): "
            + "; ".join(f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, plain "
                        f"{v['plain_ms']:.3f}, library {v['library_ms']:.3f})"
                        for k, v in timed.items()) + f" on {card}")
        log(f"    bn_train at {size} px: {bn_train_line(rec['bn_pair'][size]['bn_train'])}")
    out["resnet50_hot"] = rec
    del trainer, ema
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) the same with bn_pallas: false (torch's batch norm), {HOT_TORCH_BN_STEPS} steps "
        "(SAM at step 0; the last two at the crop)")
    torch_bn, trainer = full_run(
        full_config(["pretrain/inat21.yaml", "recipes/hot_tpu.yaml"], HOT_TORCH_BN_STEPS,
                    model={"args": {"bn_pallas": False}}),
        {}, "resnet50 hot_tpu bn_pallas=false", {}, sam_steps=(0,))
    by_scale = {}
    for tag, run in (("kernels", rec), ("torch", torch_bn)):
        for r in run["step_rows"]:
            if not r["sam"]:
                by_scale.setdefault(r["scale"], {}).setdefault(tag, []).append(r["ms"])
    log("    non-SAM step ms by scale, bn_pallas / torch's batch norm: " + "; ".join(
        f"{scale:.3f}: {'/'.join(f'{m:.1f}' for m in v.get('kernels', []))} / "
        f"{'/'.join(f'{m:.1f}' for m in v.get('torch', []))}"
        for scale, v in sorted(by_scale.items())))
    out["resnet50_hot_torch_bn"] = torch_bn
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    log(f"  (b) SwinV2-T: swinv2_tiny.yaml with fuse: true, {SWIN_FULL_STEPS} steps")
    out["swinv2_tiny"], trainer = full_run(
        full_config(["pretrain/swinv2_tiny.yaml"], SWIN_FULL_STEPS, model={"args": {"fuse": True}}),
        SWIN_PASS, "swinv2_tiny fuse=True", EVAL_PER_FORWARD["swinv2_tiny fuse=True"])
    del trainer
    log(f"  (c) SwinV2-B: phase 10's (swinv2_tiny.yaml's recipe, fuse: true), {BASE_FULL_STEPS} steps")
    out["swinv2_base"], trainer = full_run(
        full_config(["pretrain/swinv2_tiny.yaml"], BASE_FULL_STEPS,
                    model={"name": "swinv2_base", "args": {"fuse": True}}),
        BASE_TRAIN_PER_STEP, "swinv2_base fuse=True", EVAL_PER_FORWARD["swinv2_base fuse=True"])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def equivalence_checks() -> dict:
    """Phase 17 (d): accumulation against one pass, SAM with accumulation
    against the plain path."""
    import torch

    log(f"  (d) SwinV2-T fuse: true, drop path 0, no MixUp, batch {EQUIV_BATCH}: accumulation "
        "against one pass, and SAM (rho 0.05) with 2 microbatches against the plain path")
    config = with_changes(training_config(drop_path_rate=0.0, fuse=True),
                          train_dataset={"global_batch_size": EQUIV_BATCH})
    model, _ = twin_models(config, {})
    loss1, g1, _, n1, _ = step_gradients(model, config, EQUIV_BATCH, accum=1)
    loss2, g2, _, n2, _ = step_gradients(model, config, EQUIV_BATCH, accum=2)
    expect_launches(n1, SWIN_PASS, "(d) grad_accum 1")
    expect_launches(n2, {k: 2 * v for k, v in SWIN_PASS.items()}, "(d) grad_accum 2")
    log(f"    grad_accum 2 loss {loss2:.6f}, grad_accum 1 {loss1:.6f}")
    if abs(loss2 - loss1) > ACCUM_LOSS_RTOL * abs(loss1):
        raise AssertionError(f"(d) accumulated loss {loss2} vs one pass {loss1}")
    out = {"loss": loss2, "loss_one_pass": loss1,
           "gradients": compare_gradients(g2, g1, "grad_accum 2 vs 1", ACCUM_COSINE)}
    del g1, g2
    loss, g, _, n, _ = step_gradients(model, config, EQUIV_BATCH, accum=2, sam_rho=0.05)
    expect_launches(n, {k: 4 * v for k, v in SWIN_PASS.items()}, "(d) SAM grad_accum 2")
    with plain_versions():
        ref_loss, ref, _, _, _ = step_gradients(model, config, EQUIV_BATCH, accum=2, sam_rho=0.05)
    log(f"    SAM, grad_accum 2: loss {loss:.6f}, plain path {ref_loss:.6f}")
    if abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss):
        raise AssertionError(f"(d) SAM loss {loss} vs plain path {ref_loss}")
    out["sam"] = {"loss": loss, "plain_loss": ref_loss,
                  "gradients": compare_gradients(g, ref, "SAM grad_accum 2 vs plain", GRAD_COSINE)}
    del model, g, ref
    torch.cuda.empty_cache()
    return out


def remat_checks() -> dict:
    """Phase 17 (e): recomputation against none, bit for bit."""
    import torch

    from hvt_torch.models.common import _BatchNormBase

    log(f"  (e) recomputation against none, batch {REMAT_BATCH}, same weights, batch and "
        "generator, deterministic settings: gradients and running statistics bit-equal")
    out, cases = {}, []
    for fuse, fwd, bwd in ((False, ("window_attention_packed_fwd",), (BWD_KERNEL,)),
                           (True, tuple(KERNELS)[1:], tuple(FUSED_BWD))):
        cases.append((f"swinv2_tiny fuse={fuse}", training_config(fuse=fuse), {"remat": True},
                      True, {k: 12 for k in fwd + bwd},
                      {**{k: 24 for k in fwd}, **{k: 12 for k in bwd}}))
    r50 = with_changes(resnet_config(True), train_dataset={"global_batch_size": REMAT_BATCH},
                       model={"args": {"stochastic_depth_rate": 0.1}})
    cases.append(("resnet50 bn_pallas", r50, {"remat_stages": [1, 2, 3, 4]}, False, BN_PASS, None))
    for label, config, change, randomize, plain_want, remat_want in cases:
        model, twin = twin_models(config, change, randomize=randomize)
        if remat_want is None:  # each BatchNorm of the recomputed stages runs its forward twice
            staged = sum(isinstance(m, _BatchNormBase) for n in twin.remat_names
                         for m in getattr(twin, n).modules())
            remat_want = {"bn_channel_sums": RESNET_BN_LAYERS + staged,
                          "bn_normalize": RESNET_BN_LAYERS + staged,
                          "bn_bwd_reduce": RESNET_BN_LAYERS, "bn_dx": RESNET_BN_LAYERS}
        peaks, results = [], []
        with deterministic():
            for m in (model, twin):
                torch.cuda.reset_peak_memory_stats()
                results.append(step_gradients(m, config, REMAT_BATCH))
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        (loss, g, buf, n, state), (rloss, rg, rbuf, rn, rstate) = results
        expect_launches(n, plain_want, f"(e) {label}")
        expect_launches(rn, remat_want, f"(e) {label} remat")
        bit_equal_states(rg, g, f"(e) {label} gradients with remat")
        bit_equal_states(rbuf, buf, f"(e) {label} running statistics with remat")
        if rloss != loss or not torch.equal(rstate, state):
            raise AssertionError(f"(e) {label}: loss {rloss} vs {loss}, or the generator moved apart")
        log(f"    {label}: loss {loss:.6f} both; {len(g)} gradients and {len(buf)} buffers "
            f"bit-equal; launches {({k: v for k, v in rn.items() if v})} with remat, "
            f"{({k: v for k, v in n.items() if v})} without; peak {peaks[1]:.2f} GiB with, "
            f"{peaks[0]:.2f} GiB without")
        out[label] = {"loss": loss, "launches_remat": rn, "launches": n,
                      "peak_gib_remat": peaks[1], "peak_gib": peaks[0]}
        del model, twin, results, g, rg
        torch.cuda.empty_cache()
    return out


def bn_option_checks() -> dict:
    """Phase 17 (g): ``bn_custom`` against ``bn_pallas``, and ``bn_groups``
    at the fixed config's batch."""
    import torch

    from hvt_torch.models.common import GroupedBatchNorm

    log(f"  (g) bn_custom against bn_pallas on ResNet-50, batch {EQUIV_BATCH}, same weights and "
        "batch, in bf16 (the loss held, the gradients recorded: as phase 9's, an ulp of the "
        "bf16 outputs moves the first layers' gradients) and f32 (every gradient held)")
    out = {"bn_custom": {}}
    for dtype, hold in (("bfloat16", False), ("float32", True)):
        config = with_changes(resnet_config(True, dtype),
                              train_dataset={"global_batch_size": EQUIV_BATCH})
        model, custom = twin_models(config, {"bn_pallas": False, "bn_custom": True},
                                    randomize=False)
        loss, g, _, n, _ = step_gradients(model, config, EQUIV_BATCH)
        closs, cg, _, cn, _ = step_gradients(custom, config, EQUIV_BATCH)
        expect_launches(n, BN_PASS, f"(g) bn_pallas {dtype}")
        expect_launches(cn, {}, f"(g) bn_custom {dtype}")
        log(f"    {dtype}: bn_custom loss {closs:.6f}, bn_pallas {loss:.6f}; BatchNorm kernel "
            f"launches {({k: cn[k] for k in BN_KERNELS})} with bn_custom, "
            f"{({k: n[k] for k in BN_KERNELS})} with bn_pallas")
        if abs(closs - loss) > LOSS_RTOL * abs(loss):
            raise AssertionError(f"(g) bn_custom loss {closs} vs bn_pallas {loss}")
        out["bn_custom"][dtype] = {
            "loss": closs, "bn_pallas_loss": loss, "launches": cn, "gradients_held": hold,
            "gradients": compare_gradients(cg, g, f"bn_custom vs bn_pallas {dtype}",
                                           GRAD_COSINE if hold else -1.0,
                                           GRAD_NORM_RTOL if hold else math.inf)}
        del model, custom, g, cg
        torch.cuda.empty_cache()
    log("    inat21.yaml + fixed/r50_rand_species_multitask_pretrain_1.yaml (bn_groups 4, "
        f"multitask) at its batch, {GROUPS_STEPS} steps")
    out["bn_groups"], trainer = full_run(
        full_config(["pretrain/inat21.yaml",
                     "pretrain/fixed/r50_rand_species_multitask_pretrain_1.yaml"], GROUPS_STEPS),
        {}, "resnet50 bn_groups=4 multitask", {})
    groups = {m.groups for m in trainer.model.modules() if isinstance(m, GroupedBatchNorm)}
    tiers = trainer.info.num_classes
    log(f"    BatchNorm groups {groups}; multitask tiers {tiers}")
    if groups != {4} or not isinstance(tiers, tuple):
        raise AssertionError(f"(g) bn_groups run: groups {groups}, classes {tiers}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rest_of_training_phase(card: str) -> dict:
    """Phase 17: (a)-(c) the repository's 2048-image configs at their
    written batch with ``grad_accum: auto``, (d) accumulation and SAM
    against one pass and the plain path, (e) recomputation, (f) ``ape``,
    (g) ``bn_custom`` and ``bn_groups``."""
    out = full_batch_runs(card)
    out["equivalence"] = equivalence_checks()
    out["remat"] = remat_checks()
    log(f"  (f) ape: SwinV2-T fuse: true with the absolute position embedding, batch "
        f"{TRAIN_BATCH}, one step against the plain path")
    out["ape"] = gradient_check(training_config(drop_path_rate=0.0, fuse=True, ape=True),
                                "swinv2_tiny ape fuse=True")
    out.update(bn_option_checks())
    return out


# ---------------------------------------------------------------------------
# Phase 18: ViT and DINOv2 through the flash-attention kernels
# ---------------------------------------------------------------------------

_FLASH_SRC = "hvt_torch/ops/csrc/flash_attention.cu"
_JAX_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
FLASH = {  # name: (source, TPU kernel it replaces, the kernel's device symbol, one
    #          instance a tile width)
    "flash_attention_fwd": (_FLASH_SRC, f"{_JAX_FLASH}:758 (hvt/models/vit.py:50 _attend_flash)",
                            "flash_fwd_kernel"),
    "flash_attention_bwd_dkv": (_FLASH_SRC, f"{_JAX_FLASH}:1121 (hvt/models/vit.py:50)",
                                "flash_bwd_dkv_kernel"),
    "flash_attention_bwd_dq": (_FLASH_SRC, f"{_JAX_FLASH}:1456 (hvt/models/vit.py:50)",
                               "flash_bwd_dq_kernel"),
}
# (B, H, N): ViT-B/16 at 224 px, DINOv2-B/14 at 224, ViT-B/16 at 512, DINOv2 at 518
FLASH_SHAPES = ((64, 12, 197), (64, 12, 257), (8, 12, 1025), (4, 12, 1370))
# The edges of the Hopper kernels' plan (flash_attention.flash_plan): one
# 64-key tile, the widest single tiles (208, 224, 256), the first two-tile
# forward and streamed dK/dV (257), seven streamed key tiles (1,025); at
# (3, 4, N) in bf16 and f32.
FLASH_EDGES = (1, 64, 208, 209, 256, 257, 1025)
FLASH_PLAN_N = 1400
FLASH_TIMED = (2048, 12, 197)  # one ViT-B/16 block's launch at vit_b16.yaml's batch
# Kernel against plain version, max|Δ| over max|plain|: the kernel rounds the
# unnormalised p, P and dS·sm_scale to bf16 before their products and o and
# the gradients at the store; the plain version keeps them in f32. The
# log-sum-exp is f32 sums of exact bf16 products on both sides.
FLASH_TOL = {"o": 1e-2, "lse": 1e-4, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2}
# The dQ kernel's D against delta_rows, over the largest row's Σ|dO∘O|: f32
# sums of the same products (exact for bf16) in another order.
D_TOL = 1e-5
FLASH_NEGATIVE = (197, 209)  # N of the all-negative-row case, at (3, 4, N) in bf16
VIT_STEPS = 3
VIT_PASS = {name: 12 for name in FLASH}  # a ViT-B/16 pass: one launch of each a block
VIT_EVAL = {"flash_attention_fwd": 12}
VIT_CHECK_BATCH = 64
DINO_IMAGES = (2048, 512)  # synthetic train and eval images of the feature runs
DINO_CLASSES = 16
DINO_BATCH = 512  # configs/{linear_probe,simpleshot}/dinov2_b14.yaml's


def flash_inputs(b: int, h: int, n: int, seed: int = 0):
    """Seeded packed qkv (B, N, 3·H·64) and dO (B, N, H·64), bf16 on the card,
    at unit variance (logits of unit variance at sm_scale 1/8)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    c = h * 64
    qkv = torch.randn((b, n, 3 * c), generator=gen, device="cuda").bfloat16()
    dout = torch.randn((b, n, c), generator=gen, device="cuda").bfloat16()
    return qkv, dout


def flash_bounds(b: int, h: int, n: int) -> dict:
    """{kernel: (bound ms, "bytes" or "operations", bytes, flop)}: each bf16
    operand (B·H·N·64) and each f32 row vector (lse, D) read or written
    once (dQ reads q, k, v, dO, O and lse and writes dq and D; dK/dV reads
    q, k, v, dO, lse and D and writes dk, dv); the products over the N real
    keys (q·kᵀ and p·v in the forward; dK/dV recomputes q·kᵀ and forms
    dO·vᵀ, Pᵀ·dO and dSᵀ·q, dQ q·kᵀ, dO·vᵀ and dS·k), at the bf16
    tensor-core peak."""
    t, rows, mm = b * h * n * 64 * 2, b * h * n * 4, 2 * b * h * n * n * 64
    out = {}
    for name, nbytes, flop in (("flash_attention_fwd", 4 * t + rows, 2 * mm),
                               ("flash_attention_bwd_dkv", 6 * t + 2 * rows, 4 * mm),
                               ("flash_attention_bwd_dq", 6 * t + 2 * rows, 3 * mm)):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flop / H100_BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flop)
    return out


def flash_case(b: int, h: int, n: int, dtype: str = "bf16", negative_row: bool = False) -> dict:
    """The three kernels against the plain versions on one shape (each held
    to FLASH_TOL; the gradients' scale at least 1e-3·max|plain dqkv|, where
    the exact dq and dk are 0 at N = 1), the dQ kernel's D against
    ``delta_rows`` of the kernel's o (D_TOL); also the kernel path's
    determinism (a rerun bit-equal, D included). ``dtype`` "f32" passes
    flash_inputs' bf16 values as f32 tensors: the f32 route (one bf16 copy
    of qkv and dO for the products, f32 outputs, D from the f32 o and dO) on
    inputs that the rounding to bf16 leaves as they are, so FLASH_TOL holds
    as for bf16. ``negative_row``: query row 3 of image 0 has logits below
    -100 at every key (k's first column 1, that row's q -6,400 there), so a
    padded key would give exp2(-lse·log2 e) = inf unless the kernel masks it."""
    import torch

    from hvt_torch.ops import flash_attention as fa

    qkv, dout = flash_inputs(b, h, n, seed=n)
    if negative_row:
        for head in range(h):
            qkv[:, :, h * 64 + head * 64] = 1.0
            qkv[0, 3, head * 64] = -6400.0
    if dtype == "f32":
        qkv, dout = qkv.float(), dout.float()
    out, lse = fa.forward(qkv, h, 0.125)
    dqkv = fa.backward(qkv, out, lse, dout, h, 0.125)
    ref, ref_lse = fa.forward_plain(qkv, h, 0.125)
    ref_d = fa.backward_plain(qkv, ref, ref_lse, dout, h, 0.125)
    again = fa.backward(qkv, out, lse, dout, h, 0.125)
    deltas = [torch.empty((b, h, n), dtype=torch.float32, device="cuda") for _ in range(2)]
    for delta in deltas:
        fa.backward_dq(qkv, out, dout, lse, delta, torch.empty_like(qkv), h, 0.125)
    torch.cuda.synchronize()
    c = h * 64
    pairs = {"o": (out, ref), "lse": (lse, ref_lse),
             **{g: (dqkv[..., i * c:(i + 1) * c], ref_d[..., i * c:(i + 1) * c])
                for i, g in enumerate(("dq", "dk", "dv"))}}
    floor = 1e-3 * float(ref_d.abs().max())
    rec = {"shape": (b, h, n), "dtype": dtype, "negative_row": negative_row,
           "rerun_bit_equal": bool(torch.equal(dqkv, again) and torch.equal(*deltas))}
    if negative_row:
        rec["negative_row_lse"] = float(ref_lse[0, :, 3].max())
        if not rec["negative_row_lse"] < -100:
            raise AssertionError(f"flash attention {b}x{h}x{n}: the row's lse is "
                                 f"{rec['negative_row_lse']}, not below -100")
    d_ref = fa.delta_rows(out, dout, h)
    d_scale = float((out.float() * dout.float()).abs().view(b, n, h, 64).sum(-1).max())
    err = float((deltas[0] - d_ref).abs().max())
    rec["d"] = {"max_abs_err": err, "max_abs": d_scale, "limit": D_TOL * d_scale,
                "finite": bool(torch.isfinite(deltas[0]).all())}
    if not rec["d"]["finite"] or err > D_TOL * d_scale:
        raise AssertionError(f"flash attention {b}x{h}x{n} {dtype} D: max|Δ| {err:.4g} against "
                             f"{D_TOL * d_scale:.4g}")
    for key, (got, want) in pairs.items():
        got, want = got.float(), want.float()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        limit = FLASH_TOL[key] * (scale if key in ("o", "lse") else max(scale, floor))
        rec[key] = {"max_abs_err": err, "max_abs": scale, "limit": limit,
                    "finite": bool(torch.isfinite(got).all())}
        if not rec[key]["finite"] or err > limit:
            raise AssertionError(f"flash attention {b}x{h}x{n} {dtype} {key}: max|Δ| {err:.4g} "
                                 f"against {limit:.4g}")
    if not rec["rerun_bit_equal"]:
        raise AssertionError(f"flash attention {b}x{h}x{n} {dtype}: a rerun of the backward "
                             "differs")
    del qkv, dout, out, lse, dqkv, ref, ref_lse, ref_d, again, deltas, d_ref
    torch.cuda.empty_cache()
    return rec


def flash_occupancy(n: int) -> tuple[int, int, int]:
    """Blocks an SM of the forward's, dK/dV's and dQ's instance at sequence
    length n, with their plan's shared memory (the occupancy calculator)."""
    import ctypes

    from hvt_torch.ops import _build

    lib = _build.load("flash_attention")
    lib.hvt_flash_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    got = (ctypes.c_int * 3)()
    err = lib.hvt_flash_occupancy(n, got)
    if err:
        raise RuntimeError(f"hvt_flash_occupancy({n}): {lib.hvt_error_string(err).decode()}")
    return got[0], got[1], got[2]


def flash_plan_check() -> int:
    """The kernels' own plan (``hvt_flash_plan``) equal to
    ``flash_attention.flash_plan``, which the CPU tests check, at every N
    from 1 to FLASH_PLAN_N. Returns the count of N checked."""
    import ctypes

    from hvt_torch.ops import _build
    from hvt_torch.ops import flash_attention as fa

    lib = _build.load("flash_attention")
    lib.hvt_flash_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.hvt_flash_plan.restype = None
    got = (ctypes.c_int * 15)()
    for n in range(1, FLASH_PLAN_N + 1):
        lib.hvt_flash_plan(n, got)
        want = [v for p in fa.flash_plan(n)
                for v in (p.inner, p.tiles, p.outer, p.blocks_per_head, p.smem)]
        if list(got) != want:
            raise AssertionError(f"flash plan at N = {n}: kernel {list(got)}, python {want}")
    return FLASH_PLAN_N


def flash_times(b: int, h: int, n: int) -> dict:
    """Each kernel's ms (CUDA events over back-to-back launches), its host
    and device ms (torch.profiler), its plain version's ms (the forward's;
    the plain backward computes dq, dk and dv together, and its ms stands
    beside both backward kernels) and bound; ``delta_rows``' ms (the eager
    D that the parent's dQ read, its yardstick with that dQ); the whole
    CUDA backward (``backward``: dQ with its D, then dK/dV); SDPA's flash
    and efficient backends on the same (B, H, N, 64) bf16 q, k, v: forward,
    and forward plus backward."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from hvt_torch.ops import flash_attention as fa

    qkv, dout = flash_inputs(b, h, n, seed=1)
    out, lse = fa.forward(qkv, h, 0.125)
    delta = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
    dqkv = torch.empty_like(qkv)
    launch = {
        "flash_attention_fwd": lambda: fa.forward(qkv, h, 0.125),
        "flash_attention_bwd_dkv": lambda: fa.backward_dkv(qkv, dout, lse, delta, dqkv, h, 0.125),
        "flash_attention_bwd_dq": lambda: fa.backward_dq(qkv, out, dout, lse, delta, dqkv, h,
                                                         0.125),
    }
    launch["flash_attention_bwd_dq"]()  # D for dK/dV's launches
    plain = {"flash_attention_fwd": cuda_time_ms(lambda: fa.forward_plain(qkv, h, 0.125), 3, 1)}
    plain["flash_attention_bwd_dkv"] = plain["flash_attention_bwd_dq"] = cuda_time_ms(
        lambda: fa.backward_plain(qkv, out, lse, dout, h, 0.125), 3, 1)
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, 64).permute(2, 0, 3, 1, 4))
    go = dout.view(b, n, h, 64).transpose(1, 2).contiguous()
    library = {}
    for label, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                           ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with sdpa_kernel(backend):
            fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))

            def both():
                F.scaled_dot_product_attention(*leaves).backward(go)

            library[label] = {"fwd_ms": fwd, "fwd_bwd_ms": cuda_time_ms(both, 10, 2)}
        library[label]["bwd_ms"] = library[label]["fwd_bwd_ms"] - fwd
    rec = {"shape": (b, h, n), "library": library, "kernels": {},
           "delta_rows_ms": cuda_time_ms(lambda: fa.delta_rows(out, dout, h)),
           "backward_ms": cuda_time_ms(lambda: fa.backward(qkv, out, lse, dout, h, 0.125))}
    for name, (bound, by, nbytes, flop) in flash_bounds(b, h, n).items():
        host, device = host_device_ms(launch[name], 5, kernels=(FLASH[name][2],))
        ms = cuda_time_ms(launch[name])
        rec["kernels"][name] = {
            "ms": ms, "host_ms": host, "device_ms": device, "plain_ms": plain[name],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flop": flop,
            "tflops": flop / ms / 1e9, "roofline_share": bound / ms,
            "library_ms": library["flash"]["fwd_ms"] if name == "flash_attention_fwd" else None}
    del qkv, dout, out, lse, delta, dqkv, q, k, v, go
    torch.cuda.empty_cache()
    return rec


def one_batch_config(exps, steps: int, batch: int | None = None,
                     eval_images: int = FULL_EVAL_IMAGES, **layer):
    """``exps`` at their batch (or ``batch``) with grad_accum auto
    (full_config) for ``steps`` steps on one synthetic batch seen at every
    step, with no warmup, so that the loss falls over the steps; evaluated
    on ``eval_images`` synthetic images in one batch before the first step
    and after the last; ``layer`` merged last."""
    config = full_config(exps, steps, scheduler={"args": {"t_warmup": "0ba"}},
                         eval_dataset={"synthetic_num_samples": eval_images,
                                       "global_batch_size": eval_images})
    batch = batch or config.train_dataset.global_batch_size
    return with_changes(config, train_dataset={"global_batch_size": batch,
                                               "synthetic_num_samples": batch}, **layer)


def vit_config(use_flash: bool, batch: int | None = None):
    """configs/pretrain/vit_b16.yaml at its batch of 2,048 (or ``batch``)
    with grad_accum auto, ``use_flash`` on or off, for VIT_STEPS steps on one
    synthetic batch with no warmup (``one_batch_config``: the config's lr,
    cosine decay, smoothing, clip and drop path as written)."""
    return one_batch_config(["pretrain/vit_b16.yaml"], VIT_STEPS, batch,
                            model={"args": {"use_flash": use_flash}})


def dinov2_feature_runs(card: str) -> dict:
    """(d) ``hvt_torch.linear_probe.main`` and ``hvt_torch.simpleshot.main``
    on configs/{linear_probe,simpleshot}/dinov2_b14.yaml with ``use_flash``,
    seeded weights (no pretrained file in the repository), DINO_IMAGES
    synthetic images of DINO_CLASSES classes: the launch counters set to 0
    before each and read after (12 forward launches a feature batch, no
    other kernel); then one batch of features through the kernel against
    the plain path."""
    import numpy as np
    import torch

    from hvt_torch import linear_probe, simpleshot
    from hvt_torch.data import DevicePrep
    from hvt_torch.models import build_model

    counters = kernel_counters()
    data = {f"{split}_dataset": {"source": "synthetic", "path": "",
                                 "synthetic_num_classes": DINO_CLASSES,
                                 "synthetic_num_samples": n, "global_batch_size": DINO_BATCH}
            for split, n in zip(("train", "eval"), DINO_IMAGES)}
    layer = {**data, "model": {"args": {"use_flash": True}}}
    batches = sum(-(-n // DINO_BATCH) for n in DINO_IMAGES)
    out = {}
    for label, main, exps in (("linear_probe", linear_probe.main, ["linear_probe/dinov2_b14.yaml"]),
                              ("simpleshot", simpleshot.main, ["simpleshot/dinov2_b14.yaml"])):
        config = downstream_config(exps, layer)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        with trainer_output():
            metrics = main(config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items() if c.launches}
        want = {"flash_attention_fwd": 12 * batches}
        log(f"  (d) {label} on {exps[0]} (DINOv2-B/14, use_flash, {DINO_IMAGES[0]} + "
            f"{DINO_IMAGES[1]} synthetic images, {DINO_CLASSES} classes): {metrics}; launches "
            f"{launches} over {batches} feature batches of {DINO_BATCH}; {seconds:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != want:
            raise AssertionError(f"(d) {label}: launches {launches}, expected {want}")
        if not np.isfinite(list(metrics.values())).all():
            raise AssertionError(f"(d) {label}: metrics {metrics}")
        out[label] = {"metrics": metrics, "launches": launches, "seconds": seconds,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        clear_runs()

    model = build_model(config, 2).cuda().eval()
    prep = DevicePrep.from_config(config.eval_dataset, config.precision)
    images = np.random.default_rng(18).integers(0, 256, (FEATURE_CHECK_ROWS, 224, 224, 3), np.uint8)
    with torch.inference_mode():
        x = prep.normalize(torch.from_numpy(images).cuda())
        got = model(x, features_only=True).float()
        ms = cuda_time_ms(lambda: model(x, features_only=True), 5, 1)
        with plain_versions():
            ref = model(x, features_only=True).float()
            plain_ms = cuda_time_ms(lambda: model(x, features_only=True), 5, 1)
    cosine = float(torch.nn.functional.cosine_similarity(got, ref, dim=1).min())
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    log(f"    features of {FEATURE_CHECK_ROWS} images ({got.shape[1]}-d): against the plain path "
        f"worst cosine {cosine:.6f}, max|Δ| {err:.4g} (tol {LOGIT_TOL}·{scale:.4g}); "
        f"{ms:.2f} ms a batch through the kernels, {plain_ms:.2f} ms on the plain path, on {card}")
    if got.shape[1] != 1536 or not (cosine >= FEATURE_COSINE and err <= LOGIT_TOL * scale):
        raise AssertionError(f"(d) DINOv2 features against the plain path: {got.shape}, cosine "
                             f"{cosine}, max|Δ| {err} (scale {scale})")
    out["plain_check"] = {"rows": FEATURE_CHECK_ROWS, "min_cosine": cosine, "max_abs_err": err,
                          "max_abs": scale, "batch_ms": ms, "plain_batch_ms": plain_ms}
    del model, x, got, ref
    torch.cuda.empty_cache()
    return out


def vit_phase(card: str) -> dict:
    """Phase 18: (a) the three flash kernels against their plain versions at
    FLASH_SHAPES; (b) their times beside SDPA and the bound at FLASH_TIMED
    and FLASH_SHAPES; (c) vit_b16.yaml on both routes at 2,048 with
    grad_accum auto, and one step's loss and gradients on each route against
    the plain path at VIT_CHECK_BATCH; (d) DINOv2-B/14's features."""
    import torch

    out = {"checks": [], "plan_checked": flash_plan_check()}
    log(f"  (a) the kernels' plan (hvt_flash_plan) equals flash_attention.flash_plan at N = 1.."
        f"{out['plan_checked']}")
    for shape, dtype, negative in ([(s, "bf16", False) for s in FLASH_SHAPES]
                                   + [((3, 4, n), d, False) for n in FLASH_EDGES
                                      for d in ("bf16", "f32")]
                                   + [((3, 4, n), "bf16", True) for n in FLASH_NEGATIVE]):
        rec = flash_case(*shape, dtype, negative)
        out["checks"].append(rec)
        log(f"  (a) flash attention {shape[0]}x{shape[1]}x{shape[2]} {dtype}"
            + (f" with an all-negative row (lse {rec['negative_row_lse']:.1f})" if negative
               else "") + ", kernel against plain (max|Δ| / its limit): " + "; ".join(
                f"{k} {rec[k]['max_abs_err']:.3g}/{rec[k]['limit']:.3g}" for k in (*FLASH_TOL, "d"))
            + "; all finite; backward rerun bit-equal, D included")
    out["times"] = [flash_times(*shape) for shape in (FLASH_TIMED, *FLASH_SHAPES)]
    for rec in out["times"]:
        lib = rec["library"]
        log(f"  (b) {rec['shape'][0]}x{rec['shape'][1]}x{rec['shape'][2]}: " + "; ".join(
            f"{k.removeprefix('flash_attention_')} {v['ms']:.3f} ms (host {v['host_ms']:.3f}, "
            f"device {v['device_ms']:.3f}; bound {v['bound_ms']:.3f} by {v['bound_by']}, "
            f"{100 * v['roofline_share']:.1f}%; {v['tflops']:.1f} TFLOP/s; plain "
            f"{v['plain_ms']:.3f})" for k, v in rec["kernels"].items())
            + f"; delta_rows {rec['delta_rows_ms']:.3f} ms; the CUDA backward (dQ with D, then "
            f"dK/dV) {rec['backward_ms']:.3f} ms; SDPA flash fwd "
            f"{lib['flash']['fwd_ms']:.3f} / bwd {lib['flash']['bwd_ms']:.3f} "
            f"ms, efficient fwd {lib['efficient']['fwd_ms']:.3f} / bwd "
            f"{lib['efficient']['bwd_ms']:.3f} ms, on {card}")

    out["train"] = {}
    for use_flash in (True, False):
        label = f"vit_base_patch16_224 use_flash={use_flash}"
        log(f"  (c) {label}: pretrain/vit_b16.yaml at 2,048, grad_accum auto, {VIT_STEPS} steps")
        rec, trainer = full_run(vit_config(use_flash), VIT_PASS if use_flash else {}, label,
                                VIT_EVAL if use_flash else {})
        if not rec["losses"][-1] < rec["losses"][0]:
            raise AssertionError(f"(c) {label}: the loss did not fall: {rec['losses']}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        if use_flash:  # the dense route runs no kernel: its plain path is itself
            rec["gradient_check"] = gradient_check(
                with_changes(vit_config(True, VIT_CHECK_BATCH),
                             model={"args": {"drop_path_rate": 0.0}}),
                f"{label} batch {VIT_CHECK_BATCH}", randomize=False)
        out["train"][label] = rec
    out["features"] = dinov2_feature_runs(card)
    return out


# ---------------------------------------------------------------------------
# Phase 19: ConvNeXt, RegNet-Y and EfficientNet (no kernel of the repository)
# ---------------------------------------------------------------------------

FAMILY_CHECK_BATCH = 8  # (a)
FAMILY_LOGIT_TOL = 1e-3  # (a): the card against the CPU, of max|logit|
FAMILY_STATS_TOL = 1e-4  # (a): each running statistic, of its max|CPU value|
FAMILY_COSINE = 0.999  # (a): each gradient tensor
FAMILY_STEPS = 3  # (b)
FAMILY_EVAL_IMAGES = 2048  # (b): one eval batch at the configs' eval batch
FAMILY_CONFIGS = {"convnext_tiny": "pretrain/convnext_tiny.yaml",
                  "regnety_040": "pretrain/regnety_040.yaml"}
EFFNET_BATCH = 256  # (c)
EFFNET_STEPS = 4
FAMILY_REMAT_BATCH = 64  # (d)
FAMILY_CONV_BATCH = 1024  # (f): the microbatch `auto` gives both configs at 2,048
# (f): (label, side, channels, group width, kernel) of a stride-1 conv at each stage
FAMILY_CONVS = (*(("convnext_tiny dwconv 7x7", hw, c, 1, 7)
                  for hw, c in ((56, 96), (28, 192), (14, 384), (7, 768))),
                *(("regnety_040 grouped 3x3", hw, c, 64, 3)
                  for hw, c in ((56, 128), (28, 192), (14, 512), (7, 1088))))


def randomize_family_(model, seed: int) -> None:
    """Every parameter and running statistic of a ConvNeXt, RegNet-Y or
    EfficientNet drawn from a seeded generator, away from init (ConvNeXt's
    gamma is 1e-6 there): norm scales and gamma U(0.5, 1.5), norm biases
    N(0, 0.1²), running means N(0, 0.1²) and variances U(0.5, 1.5), conv and
    Dense weights N(0, 1/fan_in), their biases N(0, 0.1²)."""
    import torch
    import torch.nn as nn

    from hvt_torch.models.common import _BatchNormBase
    from hvt_torch.models.convnext import ConvNeXtBlock

    gen = torch.Generator().manual_seed(seed)

    def normal(t, std):
        t.copy_(std * torch.randn(t.shape, generator=gen))

    def uniform(t):
        t.copy_(0.5 + torch.rand(t.shape, generator=gen))

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.LayerNorm, _BatchNormBase)):
                uniform(module.weight)
                normal(module.bias, 0.1)
                if isinstance(module, _BatchNormBase):
                    normal(module.running_mean, 0.1)
                    uniform(module.running_var)
            elif isinstance(module, (nn.Linear, nn.Conv2d)):
                normal(module.weight, module.weight[0].numel() ** -0.5)
                if module.bias is not None:
                    normal(module.bias, 0.1)
            elif isinstance(module, ConvNeXtBlock):
                uniform(module.gamma)


def family_card_checks(card: str) -> dict:
    """(a) Each family at full width, seeded weights drawn away from init,
    in f32 with TF32 off, batch FAMILY_CHECK_BATCH at 224 px: the card
    against the same model on the CPU (eval and train-mode logits, the
    running statistics after the train forward, one step's gradients of the
    cross-entropy), drop rates 0 (the two devices' generators draw apart),
    cuDNN deterministic. For RegNet-Y and EfficientNet, whose every layer
    computes in the input's dtype (ConvNeXt's LayerNorms run in f32), also
    f32's own floor, recorded: the worst cosine of the CPU's f32 gradients
    against the same model's in f64."""
    import copy

    import numpy as np
    import torch
    import torch.nn.functional as F

    from hvt_torch.models import convnext, efficientnet, regnet

    counters = kernel_counters()
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(FAMILY_CHECK_BATCH, 224, 224, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, FAMILY_CHECK_BATCH))
    out = {}
    for name, build in (("convnext_tiny", convnext.convnext_tiny), ("regnety_040", regnet.regnety_040),
                        ("efficientnet_b0", lambda *a, **k: efficientnet.EfficientNet(
                            *a, drop_connect_rate=0.0, dropout_rate=0.0, **k))):  # B0's geometry
        cpu = build(CLASSES, dtype=torch.float32, seed=19)
        randomize_family_(cpu, seed=19)
        card_model = copy.deepcopy(cpu).cuda()
        f64 = None
        if name != "convnext_tiny":
            f64 = copy.deepcopy(cpu).double()
            f64.dtype = torch.float64
        runs = {}
        for where, model in (("cpu", cpu), ("card", card_model)):
            device = next(model.parameters()).device
            if where == "card":
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
            t0 = time.perf_counter()
            with deterministic():
                with torch.no_grad():
                    eval_logits = model.eval()(x.to(device))
                train_logits = model.train()(x.to(device))
                F.cross_entropy(train_logits, labels.to(device)).backward()
            if where == "card":
                torch.cuda.synchronize()
                expect_launches({k: c.launches for k, c in counters.items()}, {}, f"(a) {name}")
            runs[where] = {"eval": eval_logits.cpu(), "train": train_logits.detach().cpu(),
                           "buffers": {n: b.cpu() for n, b in model.named_buffers()},
                           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
                           "s": time.perf_counter() - t0}
        ref, got = runs["cpu"], runs["card"]
        rec = {"cpu_s": ref["s"], "card_s": got["s"]}
        for key in ("eval", "train"):
            err, scale = float((got[key] - ref[key]).abs().max()), float(ref[key].abs().max())
            rec[f"{key}_logits_err"], rec[f"{key}_logits_max"] = err, scale
            if not (bool(torch.isfinite(got[key]).all()) and err <= FAMILY_LOGIT_TOL * scale):
                raise AssertionError(f"(a) {name} {key} logits: card against CPU max|Δ| {err} "
                                     f"> {FAMILY_LOGIT_TOL}·{scale}")
        stats = [(float((t - ref["buffers"][n]).abs().max())
                  / max(float(ref["buffers"][n].abs().max()), 1e-30), n)
                 for n, t in got["buffers"].items()]
        rec["buffers"], rec["worst_buffer"] = len(stats), max(stats, default=(0.0, None))
        if rec["worst_buffer"][0] > FAMILY_STATS_TOL:
            raise AssertionError(f"(a) {name}: running statistic {rec['worst_buffer'][1]} off by "
                                 f"{rec['worst_buffer'][0]:.3g} of its max, > {FAMILY_STATS_TOL}")
        # EfficientNet's projection BatchNorm biases: each shift reaches a 1×1 conv and
        # the train-mode BatchNorm after it, whose mean removes it, so the gradient is 0
        zero = [n for n in ref["grads"] if n.endswith("project_bn.bias")]
        rec["gradients"] = compare_gradients(got["grads"], ref["grads"], f"(a) {name}",
                                             FAMILY_COSINE, zero=zero)
        floor = ""
        if f64 is not None:
            F.cross_entropy(f64.train()(x.double()), labels).backward()
            exact = {n: p.grad for n, p in f64.named_parameters()}
            rec["f32_floor"] = min(
                (float((g.double() * exact[n]).sum() / (g.double().norm() * exact[n].norm())), n)
                for n, g in ref["grads"].items() if n not in zero)
            floor = (f" (f32's floor on the CPU, f32 against f64: {rec['f32_floor'][0]:.7f}, "
                     f"{rec['f32_floor'][1]})")
        log(f"  (a) {name}, f32, batch {FAMILY_CHECK_BATCH}: card against CPU, logits max|Δ| "
            f"eval {rec['eval_logits_err']:.3g} (of {rec['eval_logits_max']:.3g}), train "
            f"{rec['train_logits_err']:.3g} (of {rec['train_logits_max']:.3g}); {len(stats)} "
            f"running statistics, worst {rec['worst_buffer'][0]:.3g} of its max; worst gradient "
            f"cosine {rec['gradients']['worst_cosine']:.7f}{floor} ({len(zero)} gradients 0 in exact "
            f"arithmetic within {rec['gradients']['zero_noise']:.3g} of the largest); no kernel "
            f"launched; CPU "
            f"{ref['s']:.1f} s, card {got['s']:.2f} s")
        out[name] = rec
        del cpu, card_model, f64, runs, ref, got
        torch.cuda.empty_cache()
    return out


def family_runs(card: str) -> dict:
    """(b) convnext_tiny.yaml and regnety_040.yaml at their 2,048, (c)
    EfficientNet-B0 on inat21.yaml's recipe at EFFNET_BATCH, through
    ``hvt_torch.main.main`` (full_run: no kernel may launch)."""
    import torch

    out = {}
    runs = [(f"(b) {name}", name, one_batch_config([exps], FAMILY_STEPS,
                                                eval_images=FAMILY_EVAL_IMAGES), True)
            for name, exps in FAMILY_CONFIGS.items()]
    runs.append(("(c) efficientnet_b0", "efficientnet_b0",
                 one_batch_config(["pretrain/inat21.yaml"], EFFNET_STEPS, EFFNET_BATCH,
                               model={"name": "efficientnet_b0"}), False))
    for tag, name, config, must_fall in runs:
        log(f"  {tag}: {config.train_dataset.global_batch_size} images a step, grad_accum auto, "
            f"{len(config.algorithms)} algorithms ({', '.join(a.cls for a in config.algorithms)}), "
            f"{config.max_duration}")
        rec, trainer = full_run(config, {}, name, {})
        rows = rec["step_rows"]
        fell = rec["losses"][-1] < rec["losses"][0]
        step_ms = ", ".join("%.1f" % r["ms"] for r in rows)
        rates = ", ".join("%.0f" % r["images_per_s"] for r in rows)
        losses = " → ".join("%.4f" % v for v in rec["losses"])
        evals = ", ".join("%.2f" % v for v in rec["eval_s"])
        log(f"    {name}: grad_accum {rec['grad_accum']}, peak {rec['peak_memory_gib']:.2f} GiB, "
            f"steps {step_ms} ms ({rates} img/s), loss {losses} "
            f"({'falls' if fell else 'does not fall'}); evaluations of "
            f"{config.eval_dataset.global_batch_size} images {evals} s, on {card}")
        if must_fall and not fell:
            raise AssertionError(f"{tag}: the loss did not fall: {rec['losses']}")
        rec["loss_fell"] = fell
        out[name] = rec
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def family_remat_checks() -> dict:
    """(d) ConvNeXt-T and RegNetY-4.0GF at FAMILY_REMAT_BATCH from their
    configs, seeded weights drawn away from init, with ``remat: true``
    against false: the same weights, batch and generator under deterministic
    settings give bit-equal gradients, running statistics, loss and
    generator state; peak memory of each."""
    import torch

    from hvt_torch.models import build_model

    out = {}
    for name, exps in FAMILY_CONFIGS.items():
        config = one_batch_config([exps], 1, FAMILY_REMAT_BATCH)
        model = build_model(config, CLASSES).cuda()
        randomize_family_(model, seed=23)
        twin = build_model(with_changes(config, model={"args": {"remat": True}}), CLASSES).cuda()
        twin.load_state_dict(model.state_dict())
        peaks, results = [], []
        with deterministic():
            for m in (model, twin):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                results.append(step_gradients(m, config, FAMILY_REMAT_BATCH))
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        (loss, g, buf, n, state), (rloss, rg, rbuf, rn, rstate) = results
        expect_launches(n, {}, f"(d) {name}")
        expect_launches(rn, {}, f"(d) {name} remat")
        bit_equal_states(rg, g, f"(d) {name} gradients with remat")
        bit_equal_states(rbuf, buf, f"(d) {name} running statistics with remat")
        if rloss != loss or not torch.equal(rstate, state):
            raise AssertionError(f"(d) {name}: loss {rloss} vs {loss}, or the generator moved apart")
        log(f"  (d) {name} at {FAMILY_REMAT_BATCH}, remat against none: loss {loss:.6f} both; "
            f"{len(g)} gradients and {len(buf)} buffers bit-equal; no kernel launched; peak "
            f"{peaks[1]:.2f} GiB with, {peaks[0]:.2f} GiB without")
        out[name] = {"loss": loss, "peak_gib_remat": peaks[1], "peak_gib": peaks[0]}
        del model, twin, results, g, rg
        torch.cuda.empty_cache()
    return out


def family_conv_times(card: str) -> list:
    """(f) The convolutions cuDNN runs for the families, alone, in bf16 at
    FAMILY_CONV_BATCH: each FAMILY_CONVS case's forward and its forward plus
    backward (dx and dw), on the channels-last layout the models use and on
    contiguous NCHW, beside the forward's bound (input and output read and
    written once, 2·MACs at the bf16 peak)."""
    import torch
    import torch.nn.functional as F

    rows = []
    for label, hw, c, group_width, k in FAMILY_CONVS:
        groups = c // group_width
        gen = torch.Generator(device="cuda").manual_seed(hw)
        nhwc = torch.randn(FAMILY_CONV_BATCH, hw, hw, c, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        weight = torch.randn(c, group_width, k, k, device="cuda", generator=gen,
                             dtype=torch.bfloat16) * group_width ** -0.5
        dy = torch.randn_like(nhwc)
        rec = {"label": label, "shape": [FAMILY_CONV_BATCH, hw, hw, c], "groups": groups}
        for layout, x, w, g in (
                ("channels_last", nhwc.permute(0, 3, 1, 2),
                 weight.contiguous(memory_format=torch.channels_last), dy.permute(0, 3, 1, 2)),
                ("nchw", nhwc.permute(0, 3, 1, 2).contiguous(), weight, dy.permute(0, 3, 1, 2).contiguous())):
            xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()

            def step():
                torch.autograd.grad(F.conv2d(xg, wg, None, 1, k // 2, 1, groups), (xg, wg), g)

            with torch.no_grad():
                rec[f"{layout}_fwd_ms"] = cuda_time_ms(
                    lambda: F.conv2d(x, w, None, 1, k // 2, 1, groups), iters=10)
            rec[f"{layout}_step_ms"] = cuda_time_ms(step, iters=5)
            del xg, wg
        macs = nhwc.numel() * group_width * k * k
        rec["fwd_bound_ms"] = 1e3 * max(2 * nhwc.numel() * 2 / H100_BYTES_PER_S,
                                        2 * macs / H100_BF16_FLOPS)
        log(f"  (f) {label} at {FAMILY_CONV_BATCH}x{hw}x{hw}x{c} ({groups} groups), bf16: forward "
            f"{rec['channels_last_fwd_ms']:.3f} ms channels-last, {rec['nchw_fwd_ms']:.3f} NCHW "
            f"(bound {rec['fwd_bound_ms']:.3f}); forward + dx + dw "
            f"{rec['channels_last_step_ms']:.3f} / {rec['nchw_step_ms']:.3f} ms, on {card}")
        rows.append(rec)
        del nhwc, weight, dy
    torch.cuda.empty_cache()
    return rows


def families_phase(card: str) -> dict:
    """Phase 19: ConvNeXt, RegNet-Y and EfficientNet, which launch no kernel
    of the repository: (a) the card against the CPU, (b) the two configs at
    2,048, (c) EfficientNet-B0, (d) recomputation, (e) HTTP serving, (f) the
    depthwise and grouped convolutions alone."""
    out = {"card_vs_cpu": family_card_checks(card)}
    out["train"] = family_runs(card)
    out["remat"] = family_remat_checks()
    from hvt_torch import config as config_lib

    base = config_lib.load(machine=str(ROOT / "configs/machines/local.yaml"),
                           exps=[str(ROOT / "configs" / FAMILY_CONFIGS["convnext_tiny"])])
    config = config_lib.loads(config_lib.to_dict(base), {
        "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                         "synthetic_num_samples": BATCH, "global_batch_size": BATCH}})
    out["serve"] = rec = serve_model(config, "(e) convnext_tiny served", {},
                                     draw=randomize_family_)
    log(f"  (e) convnext_tiny over HTTP at {BATCH}: {rec['http_images_per_s']:.1f} img/s with "
        f"{rec['http_clients']} clients, p50 {rec['http_latency_ms_p50']:.1f} ms, p90 "
        f"{rec['http_latency_ms_p90']:.1f} ms; engine step {rec['step_images_per_s']:.0f} img/s, "
        f"forward {rec['forward_ms']:.2f} ms, on {card}")
    out["convs"] = family_conv_times(card)
    return out


# ---------------------------------------------------------------------------
# Phase 20: data parallelism, a world of one through NCCL
# ---------------------------------------------------------------------------

DP_STEPS = 3  # each (b) run
DP_CLI_STEPS = 2  # (c)
BN_FINISH = ("hvt_torch/ops/csrc/bn_stats.cu",
             "hvt/ops/bn_stats_pallas.py:94 (psum :138-140, and :181's at :239-241)")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def counted_collectives():
    """torch.distributed's collectives wrapped to count their calls by name
    (what ``hvt_torch.parallel`` calls through the module), then put back."""
    import torch.distributed as dist

    counts: dict[str, int] = {}
    names = ("all_reduce", "all_gather", "broadcast", "barrier")
    saved = {n: getattr(dist, n) for n in names}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counting(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def host_ops(fn, top: int = 12, iters: int = 10) -> list:
    """Where the host's time of a call of ``fn`` goes: torch.profiler's CPU
    ops over ``iters`` calls after a warm-up, each from an idle card, the
    ``top`` of them by self CPU time, as (name, calls a call, self µs a
    call, total µs a call). The profiler's own recording inflates these;
    host_pieces times the pieces without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.key != "cudaDeviceSynchronize"]
    ops = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]
    return [(e.key, e.count / iters, round(e.self_cpu_time_total / iters, 1),
             round(e.cpu_time_total / iters, 1)) for e in ops]


def host_us(fn, iters: int = 20) -> float:
    """The median host µs of one call of ``fn`` from an idle card (the time
    to issue its work; no profiler)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def behind_busy_card(calls: dict) -> dict:
    """Whether a call makes the host wait for the card: each call issued
    behind 40 queued f32 products of 4096² matrices, as (host ms of the
    call, device ms of the queued work). A call that returns in well under the
    queued work's time leaves the host free to run ahead."""
    import torch

    a = torch.randn(4096, 4096, device="cuda")
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(40):
            a @ a
        end.record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        out[name] = (round(host_ms, 3), round(start.elapsed_time(end), 3))
    return out


def dp_bn_check() -> dict:
    """(a): bn_train under the declared group against the one-process
    route at ResNet-50's 12 BatchNorm shapes (53 layers) at batch 256, bf16,
    bit-equal, with each route's launches counted (the grouped route: each
    reduction's rows launch alone and bn_finish on its all-reduced
    partials); each route's ms a step (forward and backward, through
    autograd); bn_finish alone on each shape's partials against its plain
    version (BN_FINISH_TOL·max|plain|), timed, with its byte bound (kind 0
    reads (parts, 2, C) and writes (5, C) f32; kind 1 also reads rstd and
    the scale); at 112x112x64 each route's host and device ms a call and
    the host's ops of one call (host_ops)."""
    import torch
    import torch.distributed as dist

    from hvt_torch import parallel
    from hvt_torch.ops import bn_stats
    from hvt_torch.ops import bn_stats_cuda as bsc

    counted = (bsc.SUMS_KERNEL, bsc.NORMALIZE_KERNEL, bsc.BWD_KERNEL, bsc.DX_KERNEL,
               bsc.FINISH_KERNEL)
    out = {"ms": 0.0, "grouped_ms": 0.0, "finish_ms": 0.0, "finish_plain_ms": 0.0,
           "finish_bound_ms": 0.0, "finish_max_abs_err": 0.0, "shapes": []}
    for i, (grid, c, layers) in enumerate(RESNET_BN_SHAPES):
        x, g, scale, bias = bn_inputs(grid, c, seed=900 + i)

        def route():
            xr = x.detach().requires_grad_()
            s_, b_ = scale.clone().requires_grad_(), bias.clone().requires_grad_()
            y, mean, var = bn_stats.bn_train(xr, s_, b_, 1e-5, torch.bfloat16)
            y.backward(g)
            return y, mean, var, xr.grad, s_.grad, b_.grad

        def launches(group):
            parallel.set_data_group(group)
            before = [k.launches for k in counted]
            res = route()
            return res, [k.launches - n for k, n in zip(counted, before)]

        ref, n_one = launches(None)
        got, n_grouped = launches(dist.group.WORLD)
        # sums, normalize, reduce, dx, finish: each C call is one launch
        # (the finish alone) or two (rows and finish)
        if n_one != [1, 1, 1, 1, 0] or n_grouped != [1, 1, 1, 1, 2]:
            raise AssertionError(f"bn_train at {grid}x{c}: calls {n_one} one process, "
                                 f"{n_grouped} under the group (sums, normalize, reduce, dx, "
                                 "finish)")
        for name, a, b in zip(("y", "mean", "var", "dx", "dscale", "dbias"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"bn_train under the group differs from one process at "
                                     f"{grid}x{c}: {name} max|Δ| "
                                     f"{float((a.double() - b.double()).abs().max()):.3g}")
        parallel.set_data_group(None)
        ms = cuda_time_ms(route, iters=5, warmup=1)
        parallel.set_data_group(dist.group.WORLD)
        grouped_ms = cuda_time_ms(route, iters=5, warmup=1)
        parallel.set_data_group(None)
        # the finish alone, on this shape's partials of each reduction
        mean, _, rstd = bn_stats.bn_moments(x, 1e-5)
        n = x.shape[0]
        err = 0.0
        for kind, part, args, eps in ((0, bsc.channel_partials(x), (), 1e-5),
                                      (1, bsc.bwd_partials(g, x, mean, rstd), (rstd, scale), 0.0)):
            fin = bsc.bn_finish(part, n, eps, kind, *args)
            plain = torch.stack(bn_stats.bn_finish_plain(part, n, eps, kind, *args))
            gap, top = float((fin - plain).abs().max()), float(plain.abs().max())
            if not (bool(torch.isfinite(fin).all()) and gap <= BN_FINISH_TOL * top):
                raise AssertionError(f"bn_finish kind {kind} at {grid}x{c}: max|Δ| {gap:.3g} > "
                                     f"{BN_FINISH_TOL}·{top:.3g}")
            err = max(err, gap)
            out["finish_ms"] += layers * cuda_time_ms(
                lambda: bsc.bn_finish(part, n, eps, kind, *args), iters=20)
            out["finish_plain_ms"] += layers * cuda_time_ms(
                lambda: bn_stats.bn_finish_plain(part, n, eps, kind, *args), iters=20)
            nbytes = part.numel() * 4 + (5 + (0 if kind == 0 else 2)) * c * 4
            out["finish_bound_ms"] += layers * nbytes / H100_BYTES_PER_S * 1e3
        out["finish_max_abs_err"] = max(out["finish_max_abs_err"], err)
        out["ms"] += layers * ms
        out["grouped_ms"] += layers * grouped_ms
        out["shapes"].append({"shape": [x.shape[0], c], "layers": layers, "ms": ms,
                              "grouped_ms": grouped_ms, "finish_max_abs_err": err,
                              "parts": int(part.shape[0])})
        if i == 0:  # where the grouped route's time goes: the host or the card
            for key, group in (("one_process", None), ("grouped", dist.group.WORLD)):
                parallel.set_data_group(group)
                out[f"{key}_host_device_ms"] = host_device_ms(route)
                out[f"{key}_host_ops"] = host_ops(route)
            # the pieces of a reduction, each alone: host µs to issue
            part = bsc.channel_partials(x)
            sums = torch.zeros((2, c), device="cuda")
            out["host_pieces_us"] = {
                "channel_stats (one process: rows and finish)":
                    host_us(lambda: bsc.channel_stats(x, 1e-5)),
                "channel_partials (rows launch)": host_us(lambda: bsc.channel_partials(x)),
                "bn_finish": host_us(lambda: bsc.bn_finish(part, n, 1e-5, 0)),
                f"all_reduce_ of the partials {tuple(part.shape)}":
                    host_us(lambda: parallel.all_reduce_(part)),
                f"all_reduce_ of {tuple(sums.shape)}": host_us(lambda: parallel.all_reduce_(sums)),
                "bn_train forward and backward, one process": None,
            }
            parallel.set_data_group(None)
            out["host_pieces_us"]["bn_train forward and backward, one process"] = host_us(route)
            parallel.set_data_group(dist.group.WORLD)
            out["host_pieces_us"]["bn_train forward and backward, grouped"] = host_us(route)
            out["nccl_host_device_ms"] = host_device_ms(lambda: parallel.all_reduce_(part),
                                                        kernels=("nccl",))
            out["behind_busy_card_ms"] = behind_busy_card({
                "all_reduce_ of the partials": lambda: parallel.all_reduce_(part),
                "bn_finish (one launch)": lambda: bsc.bn_finish(part, n, 1e-5, 0)})
            parallel.set_data_group(None)
        del x, g, ref, got
        torch.cuda.empty_cache()
    # one NCCL all-reduce of (2, 512) f32 at a world of one: the host's µs to
    # issue a call (200 calls, no sync between them) and the card's µs a call
    parallel.set_data_group(dist.group.WORLD)
    sums = torch.zeros((2, 512), device="cuda")
    parallel.all_reduce_(sums)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        parallel.all_reduce_(sums)
    out["all_reduce_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    out["all_reduce_device_us"] = cuda_time_ms(lambda: parallel.all_reduce_(sums), iters=200) * 1e3
    parallel.set_data_group(None)
    (OUT_DIR / "dp_host_ops.json").write_text(json.dumps(
        {k: out[k] for k in ("one_process_host_ops", "grouped_host_ops", "host_pieces_us",
                             "nccl_host_device_ms", "behind_busy_card_ms")}, indent=1))
    return out


def dp_train_run(config, label: str) -> dict:
    """``hvt_torch.main.main(config)`` as train_run drives it, under
    deterministic settings, every launch counter and the collectives counted
    from 0: losses, the final parameters and running statistics (on the
    card), step ms, launches, and the collectives of each step after the
    first (their counts between two ``on_step`` calls); and each step's
    host clock, the CPU time of the main thread and of the whole process
    (every thread: the loader's, NCCL's), to tell a host-bound step and
    where its host time goes."""
    import torch

    from hvt_torch import main as main_lib

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    events, losses, marks, trainers, clocks = [], [], [], [], []

    class Keep(main_lib.Trainer):
        def close(self):
            super().close()
            trainers.append(self)

    with counted_collectives() as counts:
        def on_step(step, stats):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            clocks.append((time.perf_counter(), time.thread_time(), time.process_time()))
            losses.append(stats["loss_sum"])
            marks.append(dict(counts))

        t0 = time.perf_counter()
        with deterministic(), swapped(main_lib, Trainer=Keep), trainer_output():
            main_lib.main(config, on_step=on_step)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    clear_runs()
    trainer = trainers[0]
    state = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    per_step = [{k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}
                for a, b in zip(marks, marks[1:])]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    host = {name: [round((b[j] - a[j]) * 1e3, 2) for a, b in zip(clocks, clocks[1:])]
            for j, name in enumerate(("wall_ms", "main_thread_cpu_ms", "process_cpu_ms"))}
    losses = [float(v) for v in losses]
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    rec = {"label": label, "losses": losses, "step_ms": step_ms, "launches": launches,
           "collectives_a_step": per_step[-1] if per_step else {}, "wall_s": wall_s,
           "world": trainer.world, "declared": trainer._declared, "host": host}
    log(f"  {label}: losses {losses}; step ms {[round(v, 2) for v in step_ms]}; host a step "
        f"{host}; collectives a step {rec['collectives_a_step']}; launches {launches}; "
        f"{wall_s:.1f} s")
    if len(losses) != DP_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    return rec, state


def dp_cli_run() -> dict:
    """(c): torchrun --standalone --nproc_per_node=1 -m hvt_torch.main, 2
    steps of ResNet-50 (phase 9's config) at 256 on the synthetic source,
    one eval batch of 64: world 1 and rank 0 on its stdout, log0.txt and the
    step-2 checkpoint under its save_root."""
    import yaml

    root = runs_root()
    layer = {"max_duration": f"{DP_CLI_STEPS}ba", "eval_interval": "1dur", "grad_accum": 1,
             "machine": {"save_root": str(root)}, "run_name": "dp_cli",
             "save": {"wandb": False, "interval": None, "num_checkpoints_to_keep": 1},
             "model": {"args": {"stem_s2d": True, "bn_pallas": True}},
             "algorithms": [{"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}],
             "train_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                               "synthetic_num_samples": RESNET_BATCH * DP_CLI_STEPS,
                               "global_batch_size": RESNET_BATCH},
             "eval_dataset": {"source": "synthetic", "synthetic_num_classes": CLASSES,
                              "synthetic_num_samples": 64, "global_batch_size": 64}}
    exp = root / "dp_cli.yaml"
    exp.write_text(yaml.safe_dump(layer))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         "-m", "hvt_torch.main", "--machine", str(ROOT / "configs/machines/local.yaml"), "--exp",
         str(ROOT / "configs/pretrain/inat21.yaml"), str(exp)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    (OUT_DIR / "dp_cli.txt").write_text(proc.stdout + "\n--- stderr\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    said = [x for x in lines if "data parallel: rank 0 of world 1 (nccl)" in x]
    run = root / "dp_cli"
    logs = sorted(p.name for p in (run / "logs").iterdir())
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    metrics = [json.loads(x) for x in lines if x.startswith('{"acc@1"')]
    if not said or logs != ["log0.txt"] or ckpts != [str(DP_CLI_STEPS)] or len(metrics) != 1:
        raise AssertionError(f"torchrun run: {said}, logs {logs}, checkpoints {ckpts}, "
                             f"metrics {metrics}")
    log(f"  torchrun --nproc_per_node=1: '{said[0].strip()}'; logs {logs}; checkpoints {ckpts}; "
        f"eval {metrics[0]}; {wall_s:.1f} s")
    clear_runs()
    return {"line": said[0].strip(), "logs": logs, "checkpoints": ckpts, "metrics": metrics[0],
            "wall_s": wall_s}


def data_parallel_phase(card: str) -> dict:
    import torch
    import torch.distributed as dist

    from hvt_torch import parallel

    configs = {"resnet50 inat21.yaml bn_pallas": resnet_config(True, steps=DP_STEPS),
               "swinv2_tiny.yaml fuse=True": training_config(fuse=True, steps=DP_STEPS)}
    plain = {label: dp_train_run(cfg, f"{label}, one process") for label, cfg in configs.items()}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        grouped = {label: dp_train_run(cfg, f"{label}, world of one (nccl)")
                   for label, cfg in configs.items()}
        bn = dp_bn_check()
        # NCCL's all-gather (tensor parallelism's and ZeRO-1's; phase 21 runs gloo)
        x = torch.arange(24, dtype=torch.float32, device="cuda").view(2, 3, 4)
        gathered = parallel.all_gather(x, dist.group.WORLD)
        if gathered.device.type != "cuda" or not torch.equal(gathered, x[None]):
            raise AssertionError(f"NCCL all_gather at a world of one: {gathered}")
        log("  NCCL all_gather_into_tensor at a world of one: the rank's tensor, on the card")
    finally:
        parallel.destroy()
    runs = {}
    for label in configs:
        (a, sa), (b, sb) = plain[label], grouped[label]
        if not b["declared"] or a["declared"]:
            raise AssertionError(f"{label}: the group was declared {a['declared']}/{b['declared']}")
        if a["losses"] != b["losses"]:
            raise AssertionError(f"{label}: losses {b['losses']} under the group, {a['losses']} "
                                 "without")
        bit_equal_states(sb, sa, f"{label} under the group against one process")
        runs[label] = {"one_process": a, "world_of_one": b}
    got = grouped["resnet50 inat21.yaml bn_pallas"][0]
    finish_launches = got["launches"].get("bn_finish", 0)
    if finish_launches != 2 * RESNET_BN_LAYERS * DP_STEPS:
        raise AssertionError(f"bn_finish launched {finish_launches} times in {DP_STEPS} steps")
    bn_reduces = got["collectives_a_step"].get("all_reduce", 0)
    if bn_reduces < 2 * RESNET_BN_LAYERS:
        raise AssertionError(f"{bn_reduces} all-reduces a ResNet-50 step, under the 106 of its "
                             "BatchNorms")
    log(f"  bn_train at ResNet-50's 53 shapes, a step (forward and backward through autograd) on "
        f"{card}: {bn['ms']:.3f} ms one process, {bn['grouped_ms']:.3f} ms under the group; "
        f"bn_finish {bn['finish_ms']:.4f} ms a step (106 launches), plain {bn['finish_plain_ms']:.4f}, "
        f"bound {bn['finish_bound_ms']:.5f}, max|Δ| against plain {bn['finish_max_abs_err']:.3g}; "
        f"at 112x112x64 host / device ms a call: one process "
        f"{bn['one_process_host_device_ms'][0]:.3f} / {bn['one_process_host_device_ms'][1]:.3f}, "
        f"grouped {bn['grouped_host_device_ms'][0]:.3f} / {bn['grouped_host_device_ms'][1]:.3f}; "
        f"an all-reduce of (2, 512) f32: host {bn['all_reduce_host_us']:.1f} µs to issue, "
        f"{bn['all_reduce_device_us']:.1f} µs a call back to back")
    for key in ("one_process_host_ops", "grouped_host_ops"):
        log(f"  host ops of one bn_train at 112x112x64, {key[:-9]}, profiled (name, calls, self "
            f"µs, total µs, a call): {bn[key][:8]}")
    log(f"  host µs to issue each piece alone at 112x112x64: {bn['host_pieces_us']}; an "
        f"all-reduce of the partials, host / NCCL kernel ms: {bn['nccl_host_device_ms']}; "
        f"host ms of a call issued behind queued work, and that work's device ms: "
        f"{bn['behind_busy_card_ms']}")
    cli = dp_cli_run()
    return {"bn_train": bn, "runs": runs, "bn_finish_launches": finish_launches, "cli": cli}


# Phase 21: tensor parallelism and ZeRO-1, two gloo ranks on the one card.
# The script needs one card and NCCL takes one rank a device, so the grid's
# two ranks share it over gloo (the port's collectives stage its
# all-gathers through the host); their step times and the collectives'
# costs are those of two processes sharing one card, not of two cards.
GRID_WORLD = 2
GRID_STEPS = 2  # (a)-(d)
GRID_VIT_STEPS = 2  # (e)
GRID_VIT_BATCH = 64
GRID_RESNET_BATCH = 256
GRID_SEED = 29  # the drawn SwinV2-T backbone of (a), (b) and (d)
GRID_TIMEOUT = 600
ADAM_MAX_STEPS = 2  # after Adam, every element within 2·steps·lr of one process's
ADAM_MEAN = 0.1  # and each tensor's mean |Δ| within 0.1·lr (the fused route's hold)
GRID_PER_STEP = {  # kernels each rank launches a training step, by run
    "a": {"mlp_half_fwd": 12, "mlp_half_bwd": 12},
    "b": {"window_attention_packed_fwd": 12, BWD_KERNEL: 12},
    "c_zero": {"bn_finish": 2 * RESNET_BN_LAYERS},
    "d_zero": {"mlp_half_fwd": 12, "mlp_half_bwd": 12},
    "e": {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12, "flash_attention_bwd_dq": 12},
}
GRID_TWINS = {"c_zero": "c_dp", "d_zero": "d_dp"}  # ZeRO-1 run: its data-parallel twin


def write_grid_backbone(root: pathlib.Path, config=None, name: str = "backbone") -> str:
    """A SwinV2-T at 10,000 classes with every parameter drawn (randomize_,
    GRID_SEED) as a port checkpoint: (a), (b) and (d) start from it through
    PretrainedBackbone, so that no res-post-norm of zeros makes a block's
    gradients 0 at the first step."""
    import torch

    from hvt_torch.models import build_model

    model = build_model(config or training_config(fuse=True, steps=GRID_STEPS), CLASSES)
    randomize_(model, seed=GRID_SEED)
    (root / name).mkdir(parents=True)
    torch.save({"params": {n: p.detach() for n, p in model.named_parameters()},
                "batch_stats": {}}, root / name / "state.pt")
    return f"ckpt://{root / name}"


def grid_plan(backbone: str, root: pathlib.Path) -> dict:
    """The runs of phase 21 as config dicts by key: (a) SwinV2-T fused and
    (b) unfused on model 2; (c) ResNet-50 and (d) SwinV2-T fused on data 2,
    each with and without ZeRO-1; (e) ViT-B/16 on flash with model 2."""
    from hvt_torch import config as config_lib

    def layer(config, key, mesh, **change):
        d = config_lib.to_dict(config)
        d["mesh"] = {**d["mesh"], **mesh}
        d["run_name"] = f"grid_{key}"
        d["machine"]["save_root"] = str(root / "runs")
        d.update(change)
        return d

    def swin(key, fuse, mesh):
        config = training_config(fuse=fuse, steps=GRID_STEPS)
        algos = config_lib.to_dict(config)["algorithms"] + [
            {"cls": "PretrainedBackbone", "args": {"checkpoint": backbone}}]
        return layer(config, key, mesh, algorithms=algos)

    resnet = resnet_config(True, steps=GRID_STEPS)
    vit = one_batch_config(["pretrain/vit_b16.yaml"], GRID_VIT_STEPS, GRID_VIT_BATCH,
                           model={"args": {"use_flash": True}}, grad_accum=1)
    return {"a": swin("a", True, {"model": 2}), "b": swin("b", False, {"model": 2}),
            "c_dp": layer(resnet, "c_dp", {}), "c_zero": layer(resnet, "c_zero", {"zero": True}),
            "d_dp": swin("d_dp", True, {}), "d_zero": swin("d_zero", True, {"zero": True}),
            "e": layer(vit, "e", {"model": 2})}


GRID_FULL = ("a", "b", "e")  # held against one process: full parameters and gradients kept


def grid_train_run(key: str, layer: dict, full: bool | None = None) -> dict:
    """One run of ``layer`` through ``hvt_torch.main.main`` on this process's
    card (in the grid when a group is up), every launch counter at 0 just
    before: losses, step ms (CUDA events between steps), peak memory, the
    optimizer state's bytes on this rank, the kernels launched and the
    collectives issued in a training step (the last step's, no evaluation
    in it), and the final state: with ``full`` (for GRID_FULL by default)
    the full parameters and the step-1 gradients (gathered over the model
    group), else this rank's state with its EMA copy."""
    import torch

    from hvt_torch import config as config_lib
    from hvt_torch import main as main_lib
    from hvt_torch import parallel

    config = config_lib.loads(layer)
    full = key in GRID_FULL if full is None else full
    counters = kernel_counters()
    kept, events, losses, marks, grads = [], [], [], [], {}

    class Kept(main_lib.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

        def close(self):
            params = dict(self.model.named_parameters())
            if full:
                self.final = {n: t.detach().cpu() for n, t in
                              parallel.full_tensors(params).items()}
            else:
                self.final = {n: t.detach().cpu().clone()
                              for n, t in self.model.state_dict().items()}
                if self.ema is not None:
                    self.final.update({f"ema.{n}": t.cpu().clone()
                                       for n, t in self.ema.params.items()})
            self.state_bytes = sum(t.numel() * t.element_size()
                                   for s in self.optimizer.state.values() for t in s.values())
            super().close()

    def on_step(step, stats):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(stats["loss_sum"])
        if step == 1 and full:
            model = kept[0].model
            grads.update({n: g.cpu() for n, g in parallel.full_tensors(
                {n: p.grad for n, p in model.named_parameters()}).items()})
        # after the gradients' gathers: the next step's count is the step's own
        marks.append(({k: c.launches for k, c in counters.items()}, dict(parallel.COUNTS)))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with swapped(main_lib, Trainer=Kept), trainer_output():
        main_lib.main(config, device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    trainer = kept[0]
    (k0, c0), (k1, c1) = marks[-2], marks[-1]
    return {"key": key, "losses": [float(v) for v in losses],
            "step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "state_bytes": trainer.state_bytes, "wall_s": wall_s,
            "grid": (trainer.rank, trainer.data_size, trainer.model_size, trainer.zero),
            "launches_a_step": {k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]},
            "collectives_a_step": {k: c1[k] - c0[k] for k in c1},
            "final": trainer.final, "grads": grads}


def grid_rank(rank: int, port: int, plan: dict, root: str, twins=None, full=None) -> None:
    """One rank of phase 21's world (or 22's): gloo over
    tcp://127.0.0.1:``port`` on cuda:0, every run of ``plan`` in turn, the
    ZeRO-1 runs held bit for bit against their ``twins`` (GRID_TWINS) here,
    the runs of ``full`` (GRID_FULL) kept whole; results to
    ``root``/rank<r>.pt, a traceback to ``root``/rank<r>.err."""
    import traceback

    import torch
    import torch.distributed as dist

    from hvt_torch import parallel

    root = pathlib.Path(root)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=GRID_WORLD)
        twins = GRID_TWINS if twins is None else twins
        full = GRID_FULL if full is None else full
        try:
            with deterministic():
                runs = {key: grid_train_run(key, layer, key in full)
                        for key, layer in plan.items()}
        finally:
            parallel.destroy()
        for key, twin in twins.items():
            got, ref = runs[key]["final"], runs[twin]["final"]
            runs[key]["bit_equal"] = (got.keys() == ref.keys() and runs[key]["losses"]
                                      == runs[twin]["losses"]
                                      and all(torch.equal(t, ref[n]) for n, t in got.items()))
            runs[key]["max_diff"] = max(float((t.double() - ref[n].double()).abs().max())
                                        for n, t in got.items())
        for run in runs.values():
            if run["key"] not in full or rank:
                run["final"], run["grads"] = {}, {}
        torch.save(runs, root / f"rank{rank}.pt")
    except BaseException:
        (root / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def adam_close(got: dict, ref: dict, lr: float, steps: int, label: str) -> dict:
    """Parameters after ``steps`` Adam steps against one process's: every
    element within ADAM_MAX_STEPS·steps·lr, each tensor's mean |Δ| within
    ADAM_MEAN·lr (Adam moves an element by about lr whatever its
    gradient's size, so bf16 rounding can flip an update's sign). The key
    third of a ViT qkv bias is held to the first bound alone, as
    ``tests/test_torch_port_vit.py`` holds it: its gradient is 0 in exact
    arithmetic (q·b_k shifts all of a query's logits alike), so Adam moves
    it by ±lr on rounding noise, on each side its own."""
    import torch

    worst_max, worst_mean = (0.0, ""), (0.0, "")
    for n, t in got.items():
        diff = (t.double() - ref[n].double()).abs()
        worst_max = max(worst_max, (float(diff.max()), n))
        if n.endswith("attn.qkv.bias"):
            d = diff.shape[0] // 3
            diff = torch.cat([diff[:d], diff[2 * d:]])
        worst_mean = max(worst_mean, (float(diff.mean()), n))
    if worst_max[0] > ADAM_MAX_STEPS * steps * lr or worst_mean[0] > ADAM_MEAN * lr:
        raise AssertionError(f"{label}: parameters after {steps} steps: max|Δ| {worst_max} "
                             f"(bound {ADAM_MAX_STEPS * steps * lr:.3g}), worst mean|Δ| "
                             f"{worst_mean} (bound {ADAM_MEAN * lr:.3g})")
    log(f"    {label} parameters after {steps} steps against one process: max|Δ| "
        f"{worst_max[0]:.3g} ({worst_max[1]}), worst mean|Δ| {worst_mean[0]:.3g} ({worst_mean[1]})")
    return {"max_abs_diff": worst_max[0], "max_abs_diff_tensor": worst_max[1],
            "worst_mean_abs_diff": worst_mean[0], "worst_mean_tensor": worst_mean[1]}


def grid_phase(card: str) -> dict:
    """Phase 21: (a)-(e) on two ranks of one card over gloo, the runs held
    against one process (a, b, e) or their data-parallel twins (c, d)."""
    import multiprocessing

    import torch

    root = runs_root() / "grid"
    root.mkdir(parents=True)
    log(f"  every number of phase 21 on {card}, two ranks sharing it over gloo")
    plan = grid_plan(write_grid_backbone(root), root)
    refs = {}
    with deterministic():
        for key in GRID_FULL:
            refs[key] = grid_train_run(key, {**plan[key], "mesh": {**plan[key]["mesh"], "model": 1}})
    shutil.rmtree(root / "runs", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=grid_rank, args=(r, port, plan, str(root)))
             for r in range(GRID_WORLD)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + GRID_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        errs = {r: (root / f"rank{r}.err").read_text()[-3000:] if (root / f"rank{r}.err").exists()
                else f"exit code {procs[r].exitcode}" for r in failed}
        raise AssertionError(f"phase 21 ranks {failed} failed: {errs}")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(GRID_WORLD)]
    out = {"card": card, "ranks_wall_s": ranks_s, "runs": {}}
    for key in plan:
        runs = [rk[key] for rk in ranks]
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError(f"{key}: the ranks' losses differ: {runs[0]['losses']} "
                                 f"{runs[1]['losses']}")
        steps = GRID_VIT_STEPS if key == "e" else GRID_STEPS
        if len(runs[0]["losses"]) != steps or not all(map(math.isfinite, runs[0]["losses"])):
            raise AssertionError(f"{key}: losses {runs[0]['losses']}")
        for name, n in GRID_PER_STEP.get(key, {}).items():
            got = [r["launches_a_step"].get(name, 0) for r in runs]
            if got != [n] * GRID_WORLD:
                raise AssertionError(f"{key}: {name} launched {got} times a step by the ranks, "
                                     f"expected {n} each")
        rec = {k: [r[k] for r in runs] for k in ("grid", "step_ms", "peak_gib", "state_bytes",
                                                   "launches_a_step", "collectives_a_step",
                                                   "wall_s")}
        rec["losses"] = runs[0]["losses"]
        if key in GRID_TWINS:
            rec["bit_equal"] = [r["bit_equal"] for r in runs]
            rec["max_diff"] = [r["max_diff"] for r in runs]
            twin = [rk[GRID_TWINS[key]] for rk in ranks]
            rec["twin_state_bytes"] = [r["state_bytes"] for r in twin]
            if not all(rec["bit_equal"]):
                raise AssertionError(f"{key}: ZeRO-1 against data parallelism: max|Δ| "
                                     f"{rec['max_diff']}")
            if not all(z < d for z, d in zip(rec["state_bytes"], rec["twin_state_bytes"])):
                raise AssertionError(f"{key}: optimizer state {rec['state_bytes']} B a rank, "
                                     f"data parallel {rec['twin_state_bytes']}")
        if key in GRID_FULL:
            ref, got = refs[key], runs[0]
            for a, b in zip(got["losses"], ref["losses"]):
                if abs(a - b) > LOSS_RTOL * abs(b):
                    raise AssertionError(f"{key}: losses {got['losses']} against one process's "
                                         f"{ref['losses']}")
            rec["gradients"] = compare_gradients(got["grads"], ref["grads"],
                                                 f"{key} step-1 gradients against one process",
                                                 GRAD_COSINE)
            lr = float(plan[key]["optim"]["lr"])
            rec["params"] = adam_close(got["final"], ref["final"], lr, steps, key)
            rec["one_process"] = {k: ref[k] for k in ("losses", "step_ms", "peak_gib",
                                                      "state_bytes", "launches_a_step")}
        out["runs"][key] = rec
        log(f"  {key} {rec['grid'][0]}: losses {rec['losses']}; step ms by rank "
            f"{[[round(v, 1) for v in ms] for ms in rec['step_ms']]}; peak GiB "
            f"{[round(v, 2) for v in rec['peak_gib']]}; optimizer state bytes {rec['state_bytes']}"
            + (f" (data parallel {rec['twin_state_bytes']}, bit-equal {rec['bit_equal']})"
               if key in GRID_TWINS else "")
            + (f" (one process: step ms {[round(v, 1) for v in rec['one_process']['step_ms']]}, "
               f"peak {rec['one_process']['peak_gib']:.2f} GiB, state "
               f"{rec['one_process']['state_bytes']} B)" if key in GRID_FULL else "")
            + f"; a step: launches {rec['launches_a_step'][0]}, collectives "
            f"{rec['collectives_a_step']}")
    clear_runs()
    return out


# Phase 22: SwinV2-T with 8 experts (swinv2_tiny.yaml with moe_experts: 8 and
# hvt's other MoE defaults, moe_from_stage 2, moe_every 2, capacity 1.25, aux
# weight 0.01): MoE in stage 2's blocks 1, 3, 5 (C = 384, 14 x 14, s = 196,
# capacity 31) and stage 3's block 1 (C = 768, 7 x 7, s = 49, capacity 8),
# the other 8 blocks dense.
MOE_ARGS = {"moe_experts": 8}
MOE_BLOCKS = ("stage2_block1", "stage2_block3", "stage2_block5", "stage3_block1")
MOE_STEPS = 3  # (a), (b)
MOE_FULL_STEPS = 2  # (c)
MOE_EP_STEPS = 2  # (e)
MOE_TIMED_ITERS = 3
# Launches a pass of a microbatch and an eval forward, by route, from the
# routing: an MoE block takes the unfused route on both (hvt's ``fuse and not
# block_moe``), its attention the packed pair; on fuse: true each of the 8
# dense blocks keeps the NHWC attention half with its residual (every
# SwinV2-T window fits, fuse_attn_train) and the unchunked MLP half.
MOE_PASS = {True: {"window_attention_packed_fwd": 4, BWD_KERNEL: 4, "mlp_half_fwd": 8,
                   "mlp_half_bwd": 8, "attention_half_nhwc_fwd": 8, "attention_half_nhwc_bwd": 8},
            False: {"window_attention_packed_fwd": 12, BWD_KERNEL: 12}}
MOE_EVAL = {fuse: {k: v for k, v in per.items() if not k.endswith("_bwd")}
            for fuse, per in MOE_PASS.items()}
# (e): each MoE block's step makes three model-group all-reduces (the combined
# output; the expert tokens' and the gate's gradients), the clipping's norm one
MOE_EP_ALL_REDUCES = 3 * len(MOE_BLOCKS) + 1


def moe_config(fuse: bool, steps: int = MOE_STEPS):
    """Phase 7's SwinV2-T config (swinv2_tiny.yaml, TRAIN_BATCH) with 8 experts."""
    return training_config(fuse=fuse, steps=steps, **MOE_ARGS)


def moe_layer_times(model, batch: int) -> dict:
    """Each MoE layer of ``model`` alone at its block's input shape at
    ``batch``, bf16, in train mode: forward, and forward with backward (ms on
    the card, CUDA events), and the host's and the card's ms of one
    forward-and-backward call from an idle card (``host_device_ms``)."""
    import torch

    from hvt_torch.ops import moe

    out = {}
    for name, layer in moe.moe_layers(model):
        block = name.removesuffix(".moe")
        c = layer.w1.shape[1]
        grid = 56 // 2 ** int(block[len("stage")])
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(batch, grid, grid, c, device="cuda", generator=gen).bfloat16()
        x.requires_grad_()
        g = torch.randn(batch, grid, grid, c, device="cuda", generator=gen).bfloat16()

        def step():
            x.grad = None
            layer(x).backward(g)

        with torch.no_grad():
            fwd = cuda_time_ms(lambda: layer(x), iters=MOE_TIMED_ITERS, warmup=2)
        both = cuda_time_ms(step, iters=MOE_TIMED_ITERS, warmup=2)
        host, device = host_device_ms(step, iters=MOE_TIMED_ITERS)
        layer.aux = None
        out[block] = {"shape": [batch, grid, grid, c], "capacity": layer.capacity(grid * grid),
                      "fwd_ms": fwd, "fwd_bwd_ms": both, "host_ms": host, "device_ms": device}
        del x, g
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recorded_routing(model, experts: dict, flips: dict):
    """Each MoE layer of ``model`` routes as before and records its choice
    of expert in ``experts`` (empty), or takes the recorded choice and
    counts in ``flips`` the share of tokens its own argmax would send
    elsewhere (given)."""
    from hvt_torch.ops import moe

    replay = bool(experts)
    layers = moe.moe_layers(model)

    def routed(name, layer):
        own = type(layer).route

        def route(tokens, expert=None):
            if not replay:
                out = own(layer, tokens)
                experts[name] = out[1]
                return out
            out = own(layer, tokens, experts[name])
            flips[name] = float((out[0].argmax(-1) != experts[name]).float().mean())
            return out
        return route

    for name, layer in layers:
        layer.route = routed(name, layer)
    try:
        yield
    finally:
        for _, layer in layers:
            del layer.route


def moe_gradient_check(config, label: str) -> dict:
    """One step's loss (the objective plus the MoE layers' aux loss) and
    parameter gradients from the same drawn weights and batch on the kernel
    path and on the plain path, as ``gradient_check``; each path's aux loss
    and dropped-token share per MoE block beside it. The plain path takes
    the kernel path's routing (``recorded_routing``): a top-1 choice is a
    step function of the router's logits, so a token whose top two
    probabilities lie within the paths' rounding of each other goes to
    another expert, and where an image's tokens crowd an expert (drawn
    weights drop 50-60% of them) it moves every later token's slot and
    which of them are dropped, a discontinuity no tolerance bounds. The
    share of tokens that the plain path's own argmax would route elsewhere
    is reported beside it."""
    import torch

    from hvt_torch import objectives
    from hvt_torch.data import DevicePrep
    from hvt_torch.data import device as device_prep
    from hvt_torch.models import build_model
    from hvt_torch.ops import moe
    from hvt_torch.train import algorithms

    model = build_model(config, CLASSES).cuda().train()
    randomize_(model, seed=13)
    prep = DevicePrep.from_config(config.train_dataset, config.precision)
    smoothing = algorithms.parse_algorithms(config).label_smoothing
    images, labels, mask = train_batch(17, config.train_dataset.global_batch_size)
    x, targets = prep.normalize(images), device_prep.prepare_targets(labels, CLASSES, smoothing)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        out = model(x, generator=torch.Generator("cuda").manual_seed(3))  # one drop-path draw
        aux = moe.moe_aux_loss(model)
        loss = objectives.soft_cross_entropy(out, targets, mask) + aux
        loss.backward()
        dropped = {n.removesuffix(".moe"): layer.dropped_share()
                   for n, layer in moe.moe_layers(model)}
        return (float(loss.detach()), float(aux.detach()), dropped,
                {n: p.grad.float().clone() for n, p in model.named_parameters()})

    experts, flips = {}, {}
    with deterministic():
        with recorded_routing(model, experts, flips):
            loss, aux, dropped, grads = loss_and_grads()
        with plain_versions(), recorded_routing(model, experts, flips):
            ref_loss, ref_aux, ref_dropped, ref = loss_and_grads()
    flips = {n.removesuffix(".moe"): v for n, v in flips.items()}
    log(f"  {label}: loss {loss:.6f} (aux {aux:.6f}), plain path on the same routing "
        f"{ref_loss:.6f} (aux {ref_aux:.6f}); dropped-token share by MoE block "
        + ", ".join(f"{b} {dropped[b]:.4f}" for b in dropped)
        + "; tokens the plain path's own argmax routes elsewhere "
        + ", ".join(f"{b} {v:.5f}" for b, v in flips.items()))
    if abs(loss - ref_loss) > LOSS_RTOL * abs(ref_loss) or abs(aux - ref_aux) > LOSS_RTOL * ref_aux:
        raise AssertionError(f"{label}: kernel-path loss {loss} (aux {aux}) vs the plain path's "
                             f"{ref_loss} ({ref_aux})")
    held = compare_gradients(grads, ref, label, GRAD_COSINE)
    del model, grads, ref
    torch.cuda.empty_cache()
    return {"loss": loss, "plain_loss": ref_loss, "aux": aux, "plain_aux": ref_aux,
            "dropped": dropped, "plain_dropped": ref_dropped, "routed_apart": flips, **held}


def moe_train(fuse: bool, card: str, layers_timed=None) -> dict:
    """(a) / (b): MOE_STEPS adamw steps of SwinV2-T MoE-8 through
    ``hvt_torch.main.main`` on one route (``full_run``: every launch counter
    held to MOE_PASS a step and MOE_EVAL an eval batch), the MoE layers'
    last aux loss and dropped-token shares, each MoE layer alone (timed
    here, or ``layers_timed``: the layer is the same module on either
    route) and their share of the median step, and one step's gradients
    against the plain path."""
    import torch

    from hvt_torch.ops import moe

    label = f"swinv2_tiny moe8 fuse={fuse}"
    rec, trainer = full_run(moe_config(fuse), MOE_PASS[fuse], label, MOE_EVAL[fuse])
    layers = moe.moe_layers(trainer.model)
    if tuple(n.removesuffix(".moe") for n, _ in layers) != MOE_BLOCKS:
        raise AssertionError(f"{label}: MoE layers {[n for n, _ in layers]}")
    steady = sorted(r["ms"] for r in rec["step_rows"][1:])
    rec["step_ms_median"] = steady[len(steady) // 2]
    rec["aux"] = {n.removesuffix(".moe"): float(layer.last_aux) for n, layer in layers}
    rec["dropped"] = {n.removesuffix(".moe"): layer.dropped_share() for n, layer in layers}
    rec["layers"] = layers_timed or moe_layer_times(trainer.model, TRAIN_BATCH)
    for key in ("fwd_bwd_ms", "host_ms", "device_ms"):
        rec[f"moe_{key}"] = sum(v[key] for v in rec["layers"].values())
    rec["moe_share"] = rec["moe_fwd_bwd_ms"] / rec["step_ms_median"]
    rec["moe_device_share"] = rec["moe_device_ms"] / rec["step_ms_median"]
    log(f"  {label} on {card}: step {rec['step_ms_median']:.2f} ms (median of steps 2-"
        f"{MOE_STEPS}), peak {rec['peak_memory_gib']:.2f} GiB; aux loss by block "
        + ", ".join(f"{b} {v:.6f}" for b, v in rec["aux"].items())
        + f" (sum {sum(rec['aux'].values()):.6f}); dropped-token share "
        + ", ".join(f"{b} {v:.4f}" for b, v in rec["dropped"].items()))
    reused = " (timed in (a))" if layers_timed else ""
    log(f"    the MoE layers alone at batch {TRAIN_BATCH}{reused} "
        "(router, dispatch, expert products, combine; forward / forward + backward ms, host / "
        "device ms of one forward + backward): "
        + "; ".join(f"{b} {v['fwd_ms']:.3f} / {v['fwd_bwd_ms']:.3f} ({v['host_ms']:.3f} / "
                    f"{v['device_ms']:.3f})" for b, v in rec["layers"].items())
        + f"; the four back to back {rec['moe_fwd_bwd_ms']:.2f} ms, "
        f"{100 * rec['moe_share']:.1f}% of the step; their kernels {rec['moe_device_ms']:.2f} ms "
        f"({100 * rec['moe_device_share']:.1f}%), their host {rec['moe_host_ms']:.2f} ms")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rec["gradients"] = moe_gradient_check(moe_config(fuse, steps=1),
                                          f"{label} one step against the plain path")
    return rec


def moe_ep_run(root: pathlib.Path, card: str) -> dict:
    """(e): phase 21's machinery on (a)'s model: two gloo ranks on the card at
    ``model: 2`` (each holding 4 of each block's 8 experts) against the same
    run in one process, from a drawn backbone, MOE_EP_STEPS steps."""
    import multiprocessing

    import torch

    from hvt_torch import config as config_lib

    base = moe_config(True, steps=MOE_EP_STEPS)
    backbone = write_grid_backbone(root, base, "moe_backbone")
    d = config_lib.to_dict(base)
    d["algorithms"] = d["algorithms"] + [{"cls": "PretrainedBackbone",
                                          "args": {"checkpoint": backbone}}]
    d["run_name"] = "moe_ep"
    d["machine"]["save_root"] = str(root / "runs")
    layer = {**d, "mesh": {**d["mesh"], "model": 2}}
    with deterministic():
        ref = grid_train_run("moe_ep", {**d, "mesh": {**d["mesh"], "model": 1}}, full=True)
    shutil.rmtree(root / "runs", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=grid_rank, args=(r, port, {"moe_ep": layer}, str(root), {},
                                                   ("moe_ep",)))
             for r in range(GRID_WORLD)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + GRID_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        errs = {r: (root / f"rank{r}.err").read_text()[-3000:] if (root / f"rank{r}.err").exists()
                else f"exit code {procs[r].exitcode}" for r in failed}
        raise AssertionError(f"phase 22 (e) ranks {failed} failed: {errs}")
    runs = [torch.load(root / f"rank{r}.pt", weights_only=False)["moe_ep"]
            for r in range(GRID_WORLD)]
    got = runs[0]
    if runs[1]["losses"] != got["losses"] or len(got["losses"]) != MOE_EP_STEPS:
        raise AssertionError(f"(e): the ranks' losses {[r['losses'] for r in runs]}")
    for r in runs:
        if r["launches_a_step"] != MOE_PASS[True]:
            raise AssertionError(f"(e): launches a step {r['launches_a_step']}, expected "
                                 f"{MOE_PASS[True]}")
        if r["collectives_a_step"]["model_all_reduce"] != MOE_EP_ALL_REDUCES:
            raise AssertionError(f"(e): {r['collectives_a_step']} collectives a step, expected "
                                 f"{MOE_EP_ALL_REDUCES} on the model group")
    for a, b in zip(got["losses"], ref["losses"]):
        if abs(a - b) > LOSS_RTOL * abs(b):
            raise AssertionError(f"(e): losses {got['losses']} against one process's "
                                 f"{ref['losses']}")
    rec = {"grid": [r["grid"] for r in runs], "losses": got["losses"],
           "one_process_losses": ref["losses"], "ranks_wall_s": ranks_s,
           "step_ms": [r["step_ms"] for r in runs], "peak_gib": [r["peak_gib"] for r in runs],
           "state_bytes": [r["state_bytes"] for r in runs],
           "one_process": {k: ref[k] for k in ("step_ms", "peak_gib", "state_bytes")},
           "launches_a_step": runs[0]["launches_a_step"],
           "collectives_a_step": [r["collectives_a_step"] for r in runs]}
    rec["gradients"] = compare_gradients(got["grads"], ref["grads"],
                                         "(e) step-1 gradients against one process", GRAD_COSINE)
    lr = float(layer["optim"]["lr"])
    rec["params"] = adam_close(got["final"], ref["final"], lr, MOE_EP_STEPS, "(e)")
    rec["bit_equal"] = (got["losses"] == ref["losses"] and all(
        torch.equal(t, ref["final"][n]) for n, t in got["final"].items()))
    log(f"  (e) model 2 on {card}: losses {got['losses']} (one process {ref['losses']}); "
        f"bit-equal to one process: {rec['bit_equal']}; step ms by rank "
        f"{[[round(v, 1) for v in ms] for ms in rec['step_ms']]} (one process "
        f"{[round(v, 1) for v in ref['step_ms']]}); peak GiB "
        f"{[round(v, 2) for v in rec['peak_gib']]} "
        f"(one process {ref['peak_gib']:.2f}); optimizer state bytes {rec['state_bytes']} (one "
        f"process {ref['state_bytes']}); a step a rank: launches {rec['launches_a_step']}, "
        f"collectives {rec['collectives_a_step'][0]}")
    return rec


def moe_phase(card: str) -> dict:
    """Phase 22: SwinV2-T with 8 experts on the card: (a) fuse: true and (b)
    fuse: false, MOE_STEPS steps each; (c) swinv2_tiny.yaml's 2,048 with
    grad_accum auto; (d) evaluation and HTTP serving; (e) expert
    parallelism on two gloo ranks against one process."""
    import torch

    from hvt_torch import config as config_lib

    root = runs_root() / "moe"
    root.mkdir(parents=True)
    log(f"  every number of phase 22 on {card}")
    out = {"card": card}
    out["fuse=True"] = moe_train(True, card)
    out["fuse=False"] = moe_train(False, card, out["fuse=True"]["layers"])
    log(f"  (c) swinv2_tiny.yaml with moe_experts 8, fuse: true, at its 2,048 with grad_accum "
        f"auto, {MOE_FULL_STEPS} steps")
    rec, trainer = full_run(
        full_config(["pretrain/swinv2_tiny.yaml"], MOE_FULL_STEPS,
                    model={"args": {"fuse": True, **MOE_ARGS}}),
        MOE_PASS[True], "swinv2_tiny moe8 fuse=True 2048", MOE_EVAL[True])
    rec["step_ms"] = [r["ms"] for r in rec["step_rows"]]
    out["batch_2048"] = rec
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log("  (d) evaluation (is_train: false, eval-only) and HTTP serving with the MoE model")
    out["eval"], trainer = eval_run(eval_config(moe_config(True), is_train=False),
                                    "swinv2_tiny moe8 fuse=True", MOE_EVAL[True], seed=7)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    served = config_lib.loads(config_lib.to_dict(serving_config(True)),
                              {"model": {"args": MOE_ARGS}})
    out["serve"] = serve_model(served, "swinv2_tiny moe8 fuse=True served", MOE_EVAL[True],
                               plain_records=True, timing=False)
    log("  (e) expert parallelism: two gloo ranks sharing the card at model: 2")
    out["expert_parallel"] = moe_ep_run(root, card)
    clear_runs()
    return out


INT8_SOURCE = "hvt_torch/ops/csrc/int8_conv.cu"
INT8_KERNELS = {  # name: (what hvt computes in XLA, no pallas_call)
    "int8_conv": "hvt/ops/quant.py:136 (_quant_conv: XLA, no pallas_call)",
    "int8_dequant": "hvt/ops/quant.py:184 (_quant_dense's epilogue: XLA, no pallas_call)",
}
INT8_CHECK_BATCH = 8  # (a): every conv shape of the four families, kernel against plain
INT8_CHECK_FAMILIES = ("resnet50", "convnext_tiny", "efficientnet_b0", "regnety_040")
INT8_TIMED_FAMILIES = ("resnet50", "convnext_tiny")  # (a): timed at BATCH
INT8_ENGINES = (  # (b): model, config, model args, weights drawn (a checkpoint) or the seeded init
    ("resnet50", "pretrain/inat21.yaml", {}, False),
    ("swinv2_tiny fuse=True", "pretrain/swinv2_tiny.yaml", {"fuse": True}, True),
    ("swinv2_tiny fuse=False", "pretrain/swinv2_tiny.yaml", {"fuse": False}, True),
    ("convnext_tiny", "pretrain/convnext_tiny.yaml", {}, True),
)
INT8_CALIBRATE = 2  # batches of BATCH
INT8_CPU_IMAGES = 4
# (b) the int8 forward on the card against the CPU, of max|logit|. Not the
# tests' 2e-3 (micro models against hvt): at full width the float layers
# between the int8 products (BatchNorm, LayerNorm, GELU, pooling) round
# differently on the two devices, each input that then lands across a tie
# moves one int8 step, and the steps compound. The int8 forward alone moves
# that much when its input moves by 1e-7 relative on one device: 0.38% of
# max|logit| (ResNet-50), 1.4% (ConvNeXt-T, drawn weights) on the CPU; the
# card against the CPU measured 0.23% and 1.5% (H100 80GB HBM3, 700 W).
INT8_CPU_TOL = 5e-2
INT8_COSINE = 0.99  # int8 against full precision, each row: hvt's bound (tests/test_quant.py)
INT8_SPEED = ("resnet50", "swinv2_tiny fuse=True")  # (c)
INT8_SPEED_BATCHES = (BATCH, 256)
INT8_SPEED_ROUNDS = 2  # (c): windows of each kind at each batch, int8 and bf16 alternating
INT8_SPEED_WINDOW_S = 0.5  # (c): each window's least seconds (and at least 3 steps)
INT8_REQUESTS = 4
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
H100_BYTES = 3.35e12
# (a) int8_linear at SwinV2-T's Dense shapes (proj, fc1, fc2 a stage; the
# merges' reduction) and ViT-B/16's (qkv, proj, fc1, fc2) at BATCH: (M, K, N)
INT8_DENSE = tuple(
    [(BATCH * g * g, c, n) for g, c in ((56, 96), (28, 192), (14, 384), (7, 768))
     for n in (c, 4 * c)]
    + [(BATCH * g * g, 4 * c, c) for g, c in ((56, 96), (28, 192), (14, 384), (7, 768))]
    + [(BATCH * g * g // 4, 4 * c, 2 * c) for g, c in ((56, 96), (28, 192), (14, 384))]
    + [(BATCH * 197, 768, n) for n in (2304, 768, 3072)] + [(BATCH * 197, 3072, 768)])


def int8_counters() -> dict:
    from hvt_torch.ops import int8_cuda as i8

    return {"int8_conv": i8.CONV_KERNEL, "int8_dequant": i8.DEQUANT_KERNEL, "_int_mm": i8.INT_MM}


def int8_bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_INT8_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def int8_family_model(name: str, dtype):
    """One of the four conv families at full width (10,000 classes), weights
    drawn away from init."""
    from hvt_torch.models import convnext, efficientnet, regnet, resnet

    build = {"resnet50": lambda: resnet.resnet50(CLASSES, dtype=dtype, seed=23),
             "convnext_tiny": lambda: convnext.convnext_tiny(CLASSES, dtype=dtype, seed=23),
             "efficientnet_b0": lambda: efficientnet.EfficientNet(
                 CLASSES, drop_connect_rate=0.0, dropout_rate=0.0, dtype=dtype, seed=23),
             "regnety_040": lambda: regnet.regnety_040(CLASSES, dtype=dtype, seed=23)}[name]
    model = build()
    randomize_family_(model, seed=23)
    return model.cuda().eval()


def recorded_int8_calls(model, batch: int, seed: int) -> dict:
    """Every distinct int8 product of one int8 forward of ``model`` at
    ``batch`` images of 224 px (dynamic scales): {signature: {"args": the
    call's tensors and options, "count": calls a forward, "route"}}; the
    route "kernel" for int8_conv2d (the conv kernel), "_int_mm" for
    int8_linear (the 1×1 convs without pads, on their strided grid)."""
    import numpy as np
    import torch

    from hvt_torch.ops import int8_cuda as i8
    from hvt_torch.ops import quant

    real_conv, real_linear, calls = i8.int8_conv2d, i8.int8_linear, {}

    def note(sig, route, args) -> None:
        if sig not in calls:
            calls[sig] = {"args": args, "count": 0, "route": route}
        calls[sig]["count"] += 1

    def conv(xq, wq, sx, sw, bias=None, out_dtype=None, **kw):
        kw = {"stride": i8._norm_stride(kw.get("stride", 1)), "pads": tuple(kw["pads"]),
              "groups": kw.get("groups", 1)}
        note((tuple(xq.shape), tuple(wq.shape), kw["stride"], kw["pads"], kw["groups"]), "kernel",
             (xq, wq, sx, sw, bias, kw))
        return real_conv(xq, wq, sx, sw, bias, out_dtype, **kw)

    def linear(xq, wq, sx, sw, bias=None, out_dtype=None):
        note((tuple(xq.shape), tuple(wq.shape)), "_int_mm", (xq, wq, sx, sw, bias, {}))
        return real_linear(xq, wq, sx, sw, bias, out_dtype)

    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(batch, 224, 224, 3))
                         .astype(np.float32)).cuda()
    with (swapped(i8, int8_conv2d=conv, int8_linear=linear), torch.inference_mode(),
          quant.Int8(model)):
        model(x)
    return calls


def int8_route(call: dict, out_dtype=None):
    """The recorded call's int8 route on the card (int32 sums with ``out_dtype`` None)."""
    from hvt_torch.ops import int8_cuda as i8

    xq, wq, sx, sw, bias, kw = call["args"]
    if call["route"] == "kernel":
        return i8.int8_conv2d(xq, wq, sx, sw, bias, out_dtype, **kw)
    return i8.int8_linear(xq, wq, sx, sw, bias, out_dtype)


def int8_plain_acc(call: dict):
    """The recorded call's plain version: its int32 sums, exact in f64."""
    from hvt_torch.ops import int8_cuda as i8

    xq, wq, sx, sw, bias, kw = call["args"]
    if call["route"] == "kernel":
        return i8.conv_acc_plain(xq, wq, kw["stride"], kw["pads"], kw["groups"])
    acc = i8.linear_acc_plain(xq.reshape(-1, xq.shape[-1]), wq)
    return acc.reshape(*xq.shape[:-1], wq.shape[0])


def int8_held(what: str, call: dict, ref, dtypes) -> float:
    """The route's int32 sums and its outputs in each of ``dtypes`` against
    the plain version's (``ref``: its int32 sums, then hvt's epilogue), bit
    for bit; → max|Δ| of the outputs."""
    import torch

    from hvt_torch.ops import int8_cuda as i8

    xq, wq, sx, sw, bias, kw = call["args"]
    ok, worst = torch.equal(int8_route(call), ref), 0.0
    for dtype in dtypes:
        y, y_ref = int8_route(call, dtype), i8.dequant_plain(ref, sx, sw, bias, dtype)
        worst = max(worst, float((y.float() - y_ref.float()).abs().max()))
        ok = ok and torch.equal(y, y_ref)
    if not ok:
        raise AssertionError(f"(a) {what}: the int8 route ({call['route']}) is not bit-equal to "
                             f"its plain version (int32 sums and {dtypes}; max|Δ| {worst})")
    return worst


def int8_conv_checks() -> dict:
    """(a) Each distinct int8 product the quantizer makes of a conv in the
    four families at INT8_CHECK_BATCH, the conv kernel (or a 1×1's _int_mm
    route) against the plain version on the card: the int32 sums and the
    f32 outputs bit-equal; x and w off an 8-byte boundary at the first
    kernel shape of each."""
    import torch

    from hvt_torch.ops import int8_cuda as i8

    out, worst = {}, {"kernel": 0.0, "_int_mm": 0.0}
    for name in INT8_CHECK_FAMILIES:
        model = int8_family_model(name, torch.bfloat16)
        calls = recorded_int8_calls(model, INT8_CHECK_BATCH, seed=31)
        shifted = None
        for sig, call in calls.items():
            xq, wq, sx, sw, bias, kw = call["args"]
            err = int8_held(f"{name} {sig}", call, int8_plain_acc(call), (torch.float32,))
            worst[call["route"]] = max(worst[call["route"]], err)
            if shifted is None and call["route"] == "kernel":
                y = int8_route(call, torch.float32)
                for off in (1, 3):
                    xs = torch.empty(xq.numel() + 16, dtype=torch.int8, device="cuda")
                    ws = torch.empty(wq.numel() + 16, dtype=torch.int8, device="cuda")
                    xs = xs[off:off + xq.numel()].view(xq.shape).copy_(xq)
                    ws = ws[off:off + wq.numel()].view(wq.shape).copy_(wq)
                    if not torch.equal(i8.int8_conv2d(xs, ws, sx, sw, bias, torch.float32, **kw), y):
                        raise AssertionError(f"(a) {name} {sig}: off by {off} bytes, not bit-equal")
                shifted = sig
        torch.cuda.synchronize()
        routes = [c["route"] for c in calls.values()]
        out[name] = {"shapes": len(calls), "kernel_shapes": routes.count("kernel"),
                     "int_mm_shapes": routes.count("_int_mm"),
                     "calls_a_forward": sum(c["count"] for c in calls.values()),
                     "off_boundary": str(shifted)}
        log(f"  (a) {name} at {INT8_CHECK_BATCH}: {len(calls)} distinct int8 conv shapes "
            f"({routes.count('kernel')} on the kernel, {routes.count('_int_mm')} 1x1 on _int_mm), "
            f"{out[name]['calls_a_forward']} calls a forward, each bit-equal to its plain "
            f"version (int32 sums and f32 outputs); x and w 1 and 3 bytes off an 8-byte "
            f"boundary at the first kernel shape {shifted}")
        del model, calls
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


def int8_conv_times() -> dict:
    """(a) Each distinct conv product of ResNet-50 and ConvNeXt-T at BATCH,
    the engine's batch: the route's bf16 output and int32 sums bit-equal to
    the plain version's; its ms (the kernel, or _int_mm and the dequant for
    a 1×1), its bound, the plain version's ms, and the same product in bf16
    (F.conv2d on channels-last tensors, F.linear for a 1×1; another
    function: torch has no CUDA int8 conv), summed to one forward by each
    shape's calls; the dequant alone at the 1×1 shapes."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import int8_cuda as i8

    out, worst = {}, {"kernel": 0.0, "_int_mm": 0.0}
    for name in INT8_TIMED_FAMILIES:
        model = int8_family_model(name, torch.bfloat16)
        calls = recorded_int8_calls(model, BATCH, seed=37)
        del model
        rows, tot = [], {"kernel": {}, "_int_mm": {}, "dequant": {}}
        for sig, call in calls.items():
            xq, wq, sx, sw, bias, kw = call["args"]
            route = call["route"]
            if route == "kernel":
                n, h, w, c = xq.shape
                kh, kwd, cg, o = wq.shape
                oh, ow = i8.conv_out_hw(h, w, kh, kwd, kw["stride"], kw["pads"])
                m, k = n * oh * ow, kh * kwd * cg
            else:
                m, k, o = xq.numel() // xq.shape[-1], xq.shape[-1], wq.shape[0]
            bound, by = int8_bound_ms(xq.numel() + wq.numel() + 2 * m * o + 8 * o, 2.0 * m * k * o)
            ref = int8_plain_acc(call)  # also the plain version's warm-up
            worst[route] = max(worst[route], int8_held(f"{name} {sig} at {BATCH}", call, ref,
                                                       (torch.bfloat16,)))
            del ref
            ms = cuda_time_ms(lambda: int8_route(call, torch.bfloat16), iters=5, warmup=1)
            plain_ms = cuda_time_ms(lambda: i8.dequant_plain(
                int8_plain_acc(call), sx, sw, bias, torch.bfloat16), iters=1, warmup=0)
            bb = None if bias is None else bias.to(torch.bfloat16)
            if route == "kernel":
                xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels-last memory
                wb = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)
                p = kw["pads"]
                bf16_ms = cuda_time_ms(lambda: F.conv2d(xb, wb, bb, kw["stride"], (p[0], p[2]), 1,
                                                        kw["groups"]), iters=5, warmup=1)
            else:
                xb, wb = xq.reshape(m, k).to(torch.bfloat16), wq.to(torch.bfloat16)
                bf16_ms = cuda_time_ms(lambda: F.linear(xb, wb, bb), iters=5, warmup=1)
            del xb, wb
            row = {"shape": str(sig), "route": route, "count": call["count"], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "bf16_ms": bf16_ms}
            if route == "_int_mm":  # the dequant launch alone on this shape's sums
                acc = int8_route(call).reshape(m, o)  # the int32 sums
                y = torch.empty((m, o), dtype=torch.bfloat16, device="cuda")
                sxc, swc, bc = i8._scale_args(sx, sw, bias, "cuda")
                stream = torch.cuda.current_stream().cuda_stream
                row["dequant_ms"] = cuda_time_ms(lambda: i8.DEQUANT_KERNEL(
                    acc.data_ptr(), sxc.data_ptr(), swc.data_ptr(),
                    0 if bc is None else bc.data_ptr(), y.data_ptr(), m * o, o, o, 2, stream),
                    iters=5, warmup=1)
                row["dequant_plain_ms"] = cuda_time_ms(lambda: i8.dequant_plain(
                    acc, sx, sw, bias, torch.bfloat16), iters=5, warmup=1)
                row["dequant_bound_ms"] = 1e3 * (6.0 * m * o + 8 * o) / H100_BYTES
                for key in ("ms", "plain_ms", "bound_ms"):
                    tot["dequant"][key] = tot["dequant"].get(key, 0.0) + call["count"] * row[
                        f"dequant_{key}"]
                tot["dequant"]["launches"] = tot["dequant"].get("launches", 0) + call["count"]
                del acc, y
            row[f"bound_{by}_ms"] = bound
            for key in ("ms", "plain_ms", "bound_ms", "bf16_ms", f"bound_{by}_ms"):
                tot[route][key] = tot[route].get(key, 0.0) + call["count"] * row[key]
            tot[route]["launches"] = tot[route].get("launches", 0) + call["count"]
            rows.append(row)
        out[name] = {"shapes": rows, "per_forward": tot}
        k, mm, dq = tot["kernel"], tot["_int_mm"], tot["dequant"]
        log(f"  (a) {name} at {BATCH}, a forward's int8 convs, each bit-equal to its plain version "
            f"(int32 sums and bf16 outputs): the kernel {k['ms']:.3f} ms over {k['launches']} "
            f"launches (bound {k['bound_ms']:.3f}, plain {k['plain_ms']:.2f}, bf16 F.conv2d on the "
            f"same shapes {k['bf16_ms']:.3f}); the 1x1s on _int_mm {mm.get('ms', 0.0):.3f} ms (bf16 "
            f"F.linear {mm.get('bf16_ms', 0.0):.3f}), their dequant alone {dq.get('ms', 0.0):.3f} ms "
            f"(bound {dq.get('bound_ms', 0.0):.3f}); by shape: " + "; ".join(
                f"{r['shape']} {r['route']} x{r['count']} {r['ms']:.3f} / bound {r['bound_ms']:.3f} "
                f"({r['bound_by']}) / bf16 {r['bf16_ms']:.3f}" for r in rows))
        del calls
        torch.cuda.empty_cache()
    out["max_abs_err"] = worst
    return out


def int8_linear_times() -> dict:
    """(a) int8_linear (_int_mm and the dequant) at SwinV2-T's and ViT-B/16's
    Dense shapes at BATCH: its int32 sums and f32 and bf16 outputs bit-equal
    to the plain version's, its ms beside its bound and the bf16 F.linear."""
    import torch
    import torch.nn.functional as F

    from hvt_torch.ops import int8_cuda as i8

    gen, rows, worst = torch.Generator("cuda").manual_seed(41), [], 0.0
    for m, k, n in INT8_DENSE:
        xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8, device="cuda")
        wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8, device="cuda")
        sx = torch.tensor(0.013, device="cuda")
        sw = 1e-3 + 2e-2 * torch.rand(n, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        call = {"route": "_int_mm", "args": (xq, wq, sx, sw, b, {})}
        worst = max(worst, int8_held(f"int8_linear ({m}, {k}, {n})", call,
                                     i8.linear_acc_plain(xq, wq), (torch.float32, torch.bfloat16)))
        xb, wb, bb = xq.bfloat16(), wq.bfloat16(), b.bfloat16()
        ms = cuda_time_ms(lambda: i8.int8_linear(xq, wq, sx, sw, b, torch.bfloat16), iters=5,
                          warmup=1)
        bf16_ms = cuda_time_ms(lambda: F.linear(xb, wb, bb), iters=5, warmup=1)
        bound, by = int8_bound_ms(m * k + n * k + 2 * m * n + 8 * n, 2.0 * m * k * n)
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "bound_ms": bound, "bound_by": by,
                     "bf16_linear_ms": bf16_ms})
    log("  (a) int8_linear (_int_mm + dequant) against bf16 F.linear at SwinV2-T's and ViT-B/16's "
        f"Dense shapes at {BATCH}, each bit-equal to its plain version (int32 sums, f32 and bf16 "
        "outputs), ms (bound): " + "; ".join(
            f"({r['m']}, {r['k']}, {r['n']}) {r['ms']:.3f} ({r['bound_ms']:.3f} {r['bound_by']}) / "
            f"bf16 {r['bf16_linear_ms']:.3f}" for r in rows))
    return {"rows": rows, "max_abs_err": worst}


def int8_engine_config(exp: str, args: dict, load_path: str | None):
    layer = {"model": {"args": args}, "eval_dataset": {
        "source": "synthetic", "path": "", "synthetic_num_classes": CLASSES,
        "synthetic_num_samples": INT8_CALIBRATE * BATCH, "global_batch_size": BATCH}}
    if load_path:
        layer["load_path"] = load_path
    return layer, downstream_config([exp], layer)


def int8_checkpoint(config, label: str, root: pathlib.Path) -> str:
    """A port checkpoint of the config's model with every weight drawn
    (``randomize_`` for SwinV2, ``randomize_family_`` for ConvNeXt): the
    weights the int8 engine loads through ``load_path``."""
    import torch

    from hvt_torch.models import build_model
    from hvt_torch.train import checkpoint as ckpt_lib
    from hvt_torch.train import ema as ema_lib

    model = build_model(config, CLASSES)
    (randomize_ if label.startswith("swin") else randomize_family_)(model, seed=7)
    path = root / label.split()[0]
    saver = ckpt_lib.Checkpointer(path)
    saver.save(0, {"params": {k: v.detach() for k, v in model.named_parameters()},
                   "batch_stats": ema_lib.batch_stats(model), "ema_params": None})
    saver.close()
    del model
    return str(path)


def int8_forward_split(model, x, act_scales) -> dict:
    """(c) One forward of ``x`` on the card, int8 (``act_scales``) and full
    precision, from torch.profiler (the mean of 3): kernel ms by kernel
    name, and the int8 forward's kernel ms by the op that launched them
    (the profiler's correlation of each kernel with its op). The int8
    products are the conv and dequant kernels (launched outside any op,
    found by their names) and the kernels that ``aten::_int_mm`` launched,
    whatever cuBLAS names them; the rest is the quantize passes, _int_mm's
    padding copies and the float layers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hvt_torch.ops import quant

    def traced(fn) -> tuple[dict, dict]:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        by_kernel, by_op = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if us and str(e.device_type).endswith("CUDA"):
                by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 3e3
        for e in prof.events():
            for k in getattr(e, "kernels", ()):
                key = e.name if e.name != "aten::_int_mm" else f"aten::_int_mm: {k.name}"
                by_op[key] = by_op.get(key, 0.0) + k.duration / 3e3
        return by_kernel, by_op

    ctx = quant.Int8(model, act_scales)

    def int8_forward():
        with ctx:
            model(x)

    with torch.inference_mode():
        (int8, int8_ops), (full, _) = traced(int8_forward), traced(lambda: model(x))
    ours = {k: ms for k, ms in int8.items() if "int8_conv" in k or "int8_dequant" in k}
    gemm = {k.removeprefix("aten::_int_mm: "): ms for k, ms in int8_ops.items()
            if k.startswith("aten::_int_mm: ")}
    total = sum(int8.values())
    products = sum(ours.values()) + sum(gemm.values())
    return {"int8_kernel_ms": total, "int8_products_ms": products,
            "conv_dequant_ms": sum(ours.values()), "int_mm_ms": sum(gemm.values()),
            "int_mm_kernels": sorted(gemm),
            "products_share": products / total if total else math.nan,
            "full_kernel_ms": sum(full.values()),
            "top_int8": sorted(int8.items(), key=lambda kv: -kv[1])[:10],
            "int8_by_op": sorted(int8_ops.items(), key=lambda kv: -kv[1])[:12]}


def int8_engine_run(label: str, config, speed: bool) -> tuple[dict, object]:
    """(b) InferenceEngine(quantize="int8", calibrate=INT8_CALIBRATE) at BATCH;
    on its model and batch of BATCH images the calibrated step, the dynamic
    step and the full-precision step (``build_topk_step``, as the engine
    builds its own): launches a forward, logits' cosine and top-1 agreement
    against full precision; INT8_CPU_IMAGES images of the int8 forward
    (calibrated scales) against the same model on the CPU; (c) with
    ``speed``, each step's img/s at INT8_SPEED_BATCHES."""
    import copy

    import numpy as np
    import torch

    from hvt_torch.data import DevicePrep
    from hvt_torch.downstream import predict as predict_lib
    from hvt_torch.downstream import serve as serve_lib
    from hvt_torch.ops import quant

    counters = {**kernel_counters(), **int8_counters()}
    t0 = time.perf_counter()
    engine = serve_lib.InferenceEngine(config, batch=BATCH, topk=5, quantize="int8",
                                       calibrate=INT8_CALIBRATE)
    setup_s = time.perf_counter() - t0
    model, device = engine.model, engine.device
    prep = DevicePrep.from_config(config.eval_dataset, config.precision)
    steps = {"calibrated": engine._step,
             "dynamic": predict_lib.build_topk_step(model, prep, None, engine._k, device,
                                                    quantize="int8"),
             "full": predict_lib.build_topk_step(model, prep, None, engine._k, device)}
    images = np.random.default_rng(43).integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
    launches = {}
    for kind, step in steps.items():
        step(images)  # quantizes the weights once (int8), so the next call is a warm one
        before = {k: c.launches for k, c in counters.items()}
        step(images)
        launches[kind] = {k: c.launches - before[k] for k, c in counters.items()
                          if c.launches > before[k]}
    f32 = not label.startswith("swin")  # the fused halves take bf16 only
    card = copy.deepcopy(model).float() if f32 else model
    if f32:
        card.dtype = torch.float32
    cpu = copy.deepcopy(card).cpu()
    contexts = {"calibrated": quant.Int8(model, engine.act_scales), "dynamic": quant.Int8(model),
                "full": contextlib.nullcontext()}
    with torch.inference_mode():
        x = prep.normalize(torch.from_numpy(images).to(device))
        logits = {}
        for kind, ctx in contexts.items():
            with ctx:
                logits[kind] = model(x).float()
        full = logits["full"]
        agree = {}
        for kind in ("calibrated", "dynamic"):
            cos = torch.nn.functional.cosine_similarity(logits[kind], full, dim=-1)
            agree[kind] = {"cosine_min": float(cos.min()),
                           "top1_agree": int((logits[kind].argmax(-1) == full.argmax(-1)).sum())}
            if not (bool(torch.isfinite(logits[kind]).all()) and agree[kind]["cosine_min"] > INT8_COSINE):
                raise AssertionError(f"(b) {label} {kind}: int8 logits' cosine against full "
                                     f"precision {agree[kind]['cosine_min']} <= {INT8_COSINE}")
        # the int8 forward on the card against the same on the CPU, on INT8_CPU_IMAGES
        xs = x[:INT8_CPU_IMAGES]
        t1 = time.perf_counter()
        with quant.Int8(card, engine.act_scales):
            got = card(xs).float().cpu()
        with quant.Int8(cpu, engine.act_scales):
            ref = cpu(xs.cpu()).float()
        cpu_s = time.perf_counter() - t1
        tol = INT8_CPU_TOL
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > TOP1_MARGIN
        same = bool(((got.argmax(-1) == ref.argmax(-1)) | ~decided).all())
        if not (bool(torch.isfinite(got).all()) and err <= tol * scale and same):
            raise AssertionError(f"(b) {label}: the card's int8 logits against the CPU's, max|Δ| "
                                 f"{err} > {tol}·{scale} or a decided top-1 apart")
    del card, cpu
    rec = {"setup_s": setup_s, "launches": launches, "against_full": agree,
           "calibrated_layers": len(engine.act_scales), "cpu_dtype": "float32" if f32 else "bfloat16",
           "cpu_max_abs_err": err, "cpu_max_abs": scale, "cpu_tol": tol, "cpu_s": cpu_s}
    int8 = launches["calibrated"]
    if not (int8.get("_int_mm") and int8.get("int8_dequant") == int8.get("_int_mm")
            and int8.get("int8_conv")):
        raise AssertionError(f"(b) {label}: int8 launches {int8}")
    for name, n in launches["full"].items():  # the repository's kernels run under int8 as without
        if launches["calibrated"].get(name) != n or launches["dynamic"].get(name) != n:
            raise AssertionError(f"(b) {label}: {name} launched {n} times a full-precision "
                                 f"forward, {launches['calibrated'].get(name)} under int8")
    log(f"  (b) {label}: engine (quantize int8, calibrate {INT8_CALIBRATE}) set up in "
        f"{setup_s:.1f} s, {rec['calibrated_layers']} calibrated layers; launches a forward "
        f"(calibrated / dynamic / full) {launches['calibrated']} / {launches['dynamic']} / "
        f"{launches['full']}; against full precision: cosine >= "
        f"{agree['calibrated']['cosine_min']:.5f} / {agree['dynamic']['cosine_min']:.5f}, top-1 "
        f"{agree['calibrated']['top1_agree']} / {agree['dynamic']['top1_agree']} of {BATCH}; "
        f"{INT8_CPU_IMAGES} images against the CPU in {rec['cpu_dtype']}: max|Δ| {err:.4g} (tol "
        f"{tol}·{scale:.4g}), {cpu_s:.1f} s")
    if speed:
        rec["images_per_s"], rec["windows"] = {}, {}
        for b in INT8_SPEED_BATCHES:
            imgs = np.random.default_rng(b).integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
            for kind in ("calibrated", "full"):
                steps[kind](imgs)
                rec["windows"][f"{kind} {b}"] = []
            for _ in range(INT8_SPEED_ROUNDS):  # the kinds alternate, so drift falls on both
                for kind in ("calibrated", "full"):
                    n, t1 = 0, time.perf_counter()
                    while n < 3 or time.perf_counter() - t1 < INT8_SPEED_WINDOW_S:
                        steps[kind](imgs)  # returns host numpy: ends in a synchronize
                        n += 1
                    rec["windows"][f"{kind} {b}"].append((n, time.perf_counter() - t1))
            for kind in ("calibrated", "full"):
                w = rec["windows"][f"{kind} {b}"]
                rec["images_per_s"][f"{kind} {b}"] = b * sum(n for n, _ in w) / sum(t for _, t in w)
        log(f"  (c) {label}: the engine step's img/s, int8 (calibrated) / bf16, over "
            f"{INT8_SPEED_ROUNDS} alternating windows of at least {INT8_SPEED_WINDOW_S} s each "
            "(each window's img/s in brackets): " + "; ".join(
                f"batch {b} {rec['images_per_s'][f'calibrated {b}']:.1f} "
                f"{[round(b * n / t, 1) for n, t in rec['windows'][f'calibrated {b}']]} / "
                f"{rec['images_per_s'][f'full {b}']:.1f} "
                f"{[round(b * n / t, 1) for n, t in rec['windows'][f'full {b}']]}, ratio "
                f"{rec['images_per_s'][f'calibrated {b}'] / rec['images_per_s'][f'full {b}']:.3f}"
                for b in INT8_SPEED_BATCHES))
        split = rec["forward_split"] = int8_forward_split(model, x, engine.act_scales)
        log(f"  (c) {label}: one forward at {BATCH}, kernel time: int8 "
            f"{split['int8_kernel_ms']:.3f} ms, of it the int8 products "
            f"{split['int8_products_ms']:.3f} ({100 * split['products_share']:.1f}%: the conv and "
            f"dequant kernels {split['conv_dequant_ms']:.3f}, _int_mm's own kernels "
            f"{split['int_mm_ms']:.3f}, named {split['int_mm_kernels']}); full precision "
            f"{split['full_kernel_ms']:.3f} ms; the int8 forward's largest kernels: " + "; ".join(
                f"{k[:60]} {ms:.3f}" for k, ms in split["top_int8"][:6]) + "; by launching op: "
            + "; ".join(f"{k[:70]} {ms:.3f}" for k, ms in split["int8_by_op"]))
    return rec, engine


def int8_http_check(layer: dict, engine) -> dict:
    """(c) ``python -m hvt_torch.serve --quantize int8 --calibrate 2`` on
    ResNet-50 (inat21.yaml, seeded weights) answers INT8_REQUESTS requests;
    each record equal to the in-process calibrated engine's."""
    path = exp_file({**layer, "machine": {"save_root": str(runs_root())}, "save": {"wandb": False}})
    port = free_port()
    cmd = [sys.executable, "-m", "hvt_torch.serve", "--machine",
           str(ROOT / "configs/machines/local.yaml"), "--exp",
           str(ROOT / "configs/pretrain/inat21.yaml"), path, "--port", str(port), "--batch",
           str(BATCH), "--topk", "5", "--quantize", "int8", "--calibrate", str(INT8_CALIBRATE)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        while True:
            try:
                health = get(port, "/healthz")
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    raise AssertionError(f"(c) the int8 server did not start: {proc.stdout.read()}")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        with ThreadPoolExecutor(INT8_REQUESTS) as pool:
            replies = list(pool.map(lambda i: http(port, "POST", "/predict?topk=5", ppm(i)),
                                    range(INT8_REQUESTS)))
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    for i, (code, rec) in enumerate(replies):
        check_record(code, rec, 5)
        ref = engine.predict_image(ppm(i), topk=5)
        if rec["class_ids"] != ref["class_ids"] or max(
                abs(a - b) for a, b in zip(rec["probs"], ref["probs"])) > 1e-6:
            raise AssertionError(f"(c) served record {rec} against the in-process engine's {ref}")
    log(f"  (c) python -m hvt_torch.serve --quantize int8 --calibrate {INT8_CALIBRATE} (ResNet-50, "
        f"inat21.yaml): up in {up_s:.1f} s, {INT8_REQUESTS} requests answered, each record equal "
        f"to the in-process calibrated engine's; healthz {health}")
    return {"up_s": up_s, "requests": INT8_REQUESTS, "healthz": health}


def int8_phase(card: str) -> dict:
    """Phase 23: int8 w8a8 serving. (a) the int8 conv kernel against its
    plain version at every conv shape of four families, times at ResNet-50's
    and ConvNeXt-T's, int8_linear beside bf16 F.linear; (b) the int8 engine
    of ResNet-50, SwinV2-T on both routes and ConvNeXt-T; (c) img/s and the
    int8 HTTP server."""
    import gc

    import torch

    log(f"  every number of phase 23 on {card}")
    t0 = time.perf_counter()
    with torch.no_grad():  # the recorded calls' tensors keep no graph
        out = {"card": card, "checks": int8_conv_checks(), "conv_times": int8_conv_times(),
               "linear_times": int8_linear_times()}
    errs = [out[k]["max_abs_err"] for k in ("checks", "conv_times")]
    out["max_abs_err"] = {  # the kernels' line: int8_conv at 8 and 64, the dequant on every _int_mm
        "int8_conv": max(e["kernel"] for e in errs),
        "int8_dequant": max([e["_int_mm"] for e in errs] + [out["linear_times"]["max_abs_err"]])}
    out["a_s"] = time.perf_counter() - t0
    root = runs_root() / "int8"
    root.mkdir(parents=True)
    counters = {**kernel_counters(), **int8_counters()}
    for c in counters.values():
        c.launches = 0
    engines, layers = {}, {}
    for label, exp, args, drawn in INT8_ENGINES:
        layer, config = int8_engine_config(exp, args, None)
        if drawn:
            load = engines.get("swin_ckpt") if label.startswith("swin") else None
            load = load or int8_checkpoint(config, label, root)
            if label.startswith("swin"):
                engines["swin_ckpt"] = load
            layer, config = int8_engine_config(exp, args, load)
        rec, engine = int8_engine_run(label, config, label in INT8_SPEED)
        out[label] = rec
        if label == "resnet50":
            layers[label], engines[label] = layer, engine
        else:
            engine.close()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    out["b_s"] = time.perf_counter() - t0 - out["a_s"]
    out["launches"] = {k: c.launches for k, c in counters.items() if c.launches}
    if not all(out["launches"].get(k) for k in INT8_KERNELS):
        raise AssertionError(f"(b) the int8 engines launched {out['launches']}")
    out["http"] = int8_http_check(layers["resnet50"], engines["resnet50"])
    log(f"  phase 23: (a) {out['a_s']:.1f} s, (b) and (c)'s speed {out['b_s']:.1f} s, the int8 "
        f"server {out['http']['up_s']:.1f} s to start")
    engines["resnet50"].close()
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    clear_runs()
    return out


def ptxas_summary(logs: dict) -> dict:
    """{source: [{kernel, registers, static_smem, spill_stores, spill_loads}]}
    from ``nvcc -Xptxas -v``'s report of each entry function."""
    import re

    out = {}
    for source, text in logs.items():
        rows, row = [], None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                name = re.match(r"_ZN3hvt(\d+)", mangled)
                kernel = mangled
                if name:  # hvt::[namespace::]<name><template arguments>: dtypes and integers
                    rest = mangled[len("_ZN3hvt"):]
                    while rest[:1].isdigit():
                        size = re.match(r"\d+", rest).group()
                        kernel, rest = (rest[len(size):len(size) + int(size)],
                                        rest[len(size) + int(size):])
                    if rest.startswith("I") and "EE" in rest:
                        args = re.findall(r"(13__nv_bfloat16)|^(f)(?=[EL])|Li(\d+)E|Lb(\d)E|"
                                          r"\d+(NhwcWindows|FlatWindows)",
                                          rest[1:rest.index("EE") + 1])
                        kernel += "<" + ", ".join(
                            {"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, a)
                            for a in ("".join(t) for t in args)) + ">"
                row = {"kernel": kernel, "registers": None, "static_smem": 0, "spill_stores": 0,
                       "spill_loads": 0}
                rows.append(row)
                continue
            if row is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                row["spill_stores"], row["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                row["static_smem"] = int(sm.group(1)) if sm else 0
        out[source] = rows
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one forward per route and one training step with "
                             "torch.profiler")
    args = parser.parse_args(argv)
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    try:
        from hvt_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the hvt_torch package is missing ({e}); run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    OUT_DIR.mkdir(exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import PIL
    import yaml

    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"Pillow {PIL.__version__}, PyYAML {yaml.__version__}")
    host = host_facts()
    log(f"[1] host: {host['cpu_count']} CPUs ({host['affinity']} in this process's affinity); "
        f"g++ {host['gxx'] or 'missing'}; jpeglib.h {'found' if host['jpeglib_h'] else 'missing'}, "
        f"-ljpeg {'links' if host['ljpeg_links'] else 'does not link'}; sklearn "
        f"{'imports' if host['sklearn'] else 'missing'}")

    t0 = time.perf_counter()
    log("[2] building every kernel from hvt_torch/ops/csrc")
    logs = _build.build_all()
    log(f"[2] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    (OUT_DIR / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    ptxas = ptxas_summary(logs)
    for source, rows in ptxas.items():
        log(f"  ptxas {source}: " + "; ".join(
            f"{r['kernel']} {r['registers']} regs, {r['static_smem']} B static smem, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in rows))
    bwd_smem = _build.load("window_attention_bwd").hvt_window_attention_bwd_smem
    log("  window_attention_bwd dynamic shared memory per block: "
        f"bf16 {bwd_smem(0)} B, f32 {bwd_smem(1)} B")
    fwd_smem = _build.load("window_attention").hvt_window_attention_fwd_smem
    log("  window_attention forwards' attention_fwd_tc_kernel dynamic shared memory per block: "
        f"bf16 {fwd_smem(0)} B, f32 {fwd_smem(1)} B")

    log(f"[3] kernels vs plain versions, bf16 (the retired halves and the window-attention "
        f"forwards also f32), batch {BATCH}")
    checked = kernel_records(timing=False)
    log("[3] the window-attention forwards at N = 144 (window 12), bf16 and f32")
    wide_checked = wide_window_check()
    log(f"[3] the fused forwards and the retired halves at SwinV2-B's block shapes, bf16 "
        f"(the retired halves also f32), batch {BATCH} (eval)")
    base_names = ("mlp_half_fwd", "attention_half_nhwc_fwd", "attention_half_fwd")
    base_checked = kernel_records(False, BASE_STAGES, BATCH, base_names + RETIRED_CASES)

    log(f"[4] serving SwinV2-T at 224 px, {CLASSES} classes, batch {BATCH}")
    routes = [serve_route(fuse) for fuse in (False, True)]

    log(f"[5] times at batch {BATCH} on {card} (CUDA events; per SwinV2-T forward)")
    timed = kernel_records(timing=True)
    kernels = []
    for name, (source, replaces, fuse) in KERNELS.items():
        rec = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": routes[int(fuse)]["launches"][name],
            "max_abs_err": checked[name]["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
        log(f"  {name}: {rec['ms']:.4f} ms kernel, {rec['plain_ms']:.4f} ms plain, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), library {rec['library_ms']}")
    for name in FORWARD_NAMES[len(KERNELS):]:
        rec = timed[name]
        log(f"  {name}: {rec['ms']:.4f} ms kernel, {rec['plain_ms']:.4f} ms plain, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library {rec['library_ms']}; per launch "
            "(kernel/plain ms): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} x{st['launches_per_forward']} "
                f"{st['ms']:.3f}/{st['plain_ms']:.3f}" for st in rec["stages"]))
    log("  window-attention forwards against SDPA in the same dtype, ms per SwinV2-T forward "
        "(kernel / SDPA / bound): " + "; ".join(
            f"{k} {timed[k]['ms']:.4f} / {timed[k]['library_ms']:.4f} / {timed[k]['bound_ms']:.4f}"
            for k in WA_FORWARDS))
    for k in WA_FORWARDS:
        stages = timed[k]["stages"]
        timed[k]["host_ms"], timed[k]["device_ms"] = (
            sum(st["launches_per_forward"] * st[key] for st in stages) for key in ("host_ms", "device_ms"))
        log(f"  {k}: host {timed[k]['host_ms']:.4f} ms a forward in the call, device "
            f"{timed[k]['device_ms']:.4f} ms in the kernel alone; per launch (host/device): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['host_ms']:.3f}/{st['device_ms']:.3f}"
                for st in stages))
    for name in ("mlp_half_fwd", *ATTN_HALF_FWD):
        rec = timed[name]
        log(f"  {name}: composite yardstick (the unfused route's ops, no grad) "
            f"{rec['composite_ms']:.4f} ms per SwinV2-T forward against {rec['ms']:.4f} ms through "
            "the kernels; per launch (kernels/composite): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['ms']:.3f}/{st['composite_ms']:.3f}"
                for st in rec["stages"]))
    for name, (sub_kernels, _) in FWD_SPLITS.items():
        rec = timed[name]
        keys = [k for _, k in sub_kernels[0]]
        log(f"  {name}: host {rec['host_ms']:.4f} / device {rec['device_ms']:.4f} ms per SwinV2-T "
            f"forward in the call; device ms by kernel: {split_line(rec['kernels_ms'])}; bound "
            f"{rec['bound_ms']:.4f} ms, the design's floor (its round trips through device memory) "
            f"{rec['design_floor_ms']:.4f} ms; per launch (host/device, {'/'.join(keys)}): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['host_ms']:.3f}/{st['device_ms']:.3f}, "
                + "/".join(f"{st['kernels_ms'].get(k, 0.0):.3f}" for k in keys)
                for st in rec["stages"]))
    # fc1 and fc2 each do 8·T·C² operations a launch (T tokens, C channels)
    for st in timed["mlp_half_fwd"]["stages"]:
        st["tflops"] = {k: st["flops"] / 2 / st["kernels_ms"][k] / 1e9 for k in ("fc1", "fc2")
                        if st["kernels_ms"].get(k)}
    log("  mlp_half_fwd products, TFLOP/s per launch (fc1/fc2): " + "; ".join(
        f"stage {st['stage']} shift {st['shift']} " + "/".join(
            f"{st['tflops'].get(k, 0.0):.1f}" for k in ("fc1", "fc2"))
        for st in timed["mlp_half_fwd"]["stages"]))
    from hvt_torch.ops import fused_halves_cuda as fh

    mlp_fwd_smem = _build.load("mlp").hvt_mlp_fwd_smem
    log("  MLP forward kernels, both sites (ptxas; dynamic shared memory per block, B, at C = "
        "96 / 768: " + "; ".join(
            f"{k} {mlp_fwd_smem(i, fh.fc2_cols(96))} / {mlp_fwd_smem(i, fh.fc2_cols(768))}"
            for i, k in enumerate(("fc1", "fc2", "LayerNorm"))) + "): " + "; ".join(
            f"{r['kernel']} {r['registers']} regs, {r['static_smem']} B static, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in ptxas.get("mlp", [])
            if r["kernel"].startswith(("mlp_fwd_", "ln_resid_fwd"))))
    fwd_smem = _build.load("fused_halves").hvt_attention_half_fwd_smem
    log("  attention half forward kernels (ptxas, per instance; dynamic shared memory per block: "
        f"attention output {fwd_smem(0, 96)} B, proj C=96 {fwd_smem(1, 96)} B, C=768 "
        f"{fwd_smem(1, 768)} B, LayerNorm {fwd_smem(2, 96)} B): " + "; ".join(
            f"{source} {r['kernel']} {r['registers']} regs, {r['static_smem']} B static, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for source, rows in ptxas.items()
            if source in ("fused_halves", "attention_half") for r in rows
            if r["kernel"].startswith(("attn_half_fwd_", "ln_resid_fwd"))))
    base_timed = kernel_records(True, BASE_STAGES, TRAIN_BATCH, base_names, train_launches)
    for name, rec in base_timed.items():
        log(f"  SwinV2-B {name}: {rec['ms']:.4f} ms kernel, {rec['plain_ms']:.4f} ms plain, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), per SwinV2-B training step at batch "
            f"{TRAIN_BATCH} ({sum(st['launches_per_forward'] for st in rec['stages'])} launches); "
            "per launch (kernel/plain ms): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} x{st['launches_per_forward']} "
                f"{st['ms']:.3f}/{st['plain_ms']:.3f}" for st in rec["stages"]))
    base_retired = kernel_records(True, BASE_STAGES, BATCH, RETIRED_CASES)
    sb_smem = _build.load("swin_block").hvt_swin_block_smem
    core_smem = _build.load("window_attention").hvt_window_attention_fwd_smem(1)
    log(f"  retired halves (csrc/swin_block.cu; dynamic shared memory per block: products "
        f"{sb_smem(96)} B at 96 columns, {sb_smem(128)} B at 128; the core's f32 "
        f"attention_fwd_tc_kernel {core_smem} B): " + "; ".join(f"{r['kernel']} {r['registers']} regs, {r['static_smem']} B static, "
                            f"spills {r['spill_stores']}/{r['spill_loads']} B"
                            for r in ptxas.get("swin_block", [])))
    retired_timed = {"SwinV2-T": (timed, STAGES), "SwinV2-B": (base_retired, BASE_STAGES)}
    for label, (recs, stages) in retired_timed.items():
        for name in RETIRED_CASES:
            rec = recs[name]
            retired_times(rec, name, stages, BATCH)
            log(f"  {label} {name}: {rec['ms']:.4f} ms a forward at batch {BATCH} (host "
                f"{rec['host_ms']:.4f} / device {rec['device_ms']:.4f} in the call), plain "
                f"{rec['plain_ms']:.4f}, composite {rec['composite_ms']:.4f}; bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; PR 8's f32-rate bound "
                f"{rec['f32_rate_bound_ms']:.4f}), the design's floor "
                f"{rec['design_floor_ms']:.4f}; "
                f"device ms by kernel: {split_line(rec['kernels_ms'])}; per launch ms and TFLOP/s "
                "by product (piece products counted): " + "; ".join(
                    f"stage {st['stage']} shift {st['shift']} x{st['launches_per_forward']} "
                    f"{st['ms']:.3f}, " + "/".join(f"{k} {v:.0f}" for k, v in st["tflops"].items())
                    for st in rec["stages"]))
    for r in routes:
        log(f"  fuse={r['fuse']}: forward {r['forward_ms']:.3f} ms on kernels, "
            f"{r['forward_plain_ms']:.3f} ms on plain versions; engine step "
            f"{r['step_images_per_s']:.1f} img/s; HTTP {r['http_images_per_s']:.1f} img/s, "
            f"latency p50 {r['http_latency_ms_p50']:.1f} ms p90 {r['http_latency_ms_p90']:.1f} ms")

    log(f"[6] {BWD_KERNEL} vs plain version, bf16, batch {TRAIN_BATCH}")
    bwd_checked = backward_records(timing=False)
    bwd = backward_records(timing=True)
    wrapper_ms = sum(st["launches_per_forward"] * st["wrapper_ms"] for st in bwd["stages"])
    log(f"  {BWD_KERNEL}: {bwd['ms']:.4f} ms kernel through the model's backward "
        f"({wrapper_ms:.4f} ms in the launch wrapper alone), {bwd['plain_ms']:.4f} ms plain, bound "
        f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}), library {bwd['library_ms']:.4f} ms "
        f"(SDPA backward), per training step on {card}; per launch (model backward/wrapper/bound/"
        f"plain/library): " + "; ".join(
            f"stage {st['stage']} shift {st['shift']} {st['ms']:.3f}/{st['wrapper_ms']:.3f}/"
            f"{st['bytes'] / H100_BYTES_PER_S * 1e3:.3f}/{st['plain_ms']:.3f}/{st['library_ms']:.3f}"
            for st in bwd["stages"]))
    log(f"  {BWD_KERNEL}: " + host_device_line(bwd))

    log(f"[6] {BWD_KERNEL} vs plain version, f32, batch {TRAIN_BATCH} (check only)")
    bwd_f32 = backward_records(False, torch.float32)

    log(f"[6] window_attention_bwd (split q, k, v) vs plain version, bf16, batch {TRAIN_BATCH}")
    split_checked = split_backward_records(timing=False)
    split_bwd = split_backward_records(timing=True)
    log(f"[6] window_attention_bwd (split q, k, v) vs plain version, f32, batch {TRAIN_BATCH} "
        "(check only)")
    split_f32 = split_backward_records(False, torch.float32)
    wrapper_ms = sum(st["launches_per_forward"] * st["wrapper_ms"] for st in split_bwd["stages"])
    log(f"  window_attention_bwd: {split_bwd['ms']:.4f} ms kernel through autograd "
        f"({wrapper_ms:.4f} ms in the launch wrapper alone), {split_bwd['plain_ms']:.4f} ms plain, "
        f"bound {split_bwd['bound_ms']:.4f} ms ({split_bwd['bound_by']}), library "
        f"{split_bwd['library_ms']:.4f} ms (SDPA backward), per training step's 12 block shapes on "
        f"{card}; per launch (autograd/wrapper/plain/library): " + "; ".join(
            f"stage {st['stage']} shift {st['shift']} {st['ms']:.3f}/{st['wrapper_ms']:.3f}/"
            f"{st['plain_ms']:.3f}/{st['library_ms']:.3f}" for st in split_bwd["stages"]))
    log("  window_attention_bwd: " + host_device_line(split_bwd))

    log(f"[6] fused halves' backward kernels vs plain versions, bf16, batch {TRAIN_BATCH}")
    fused_checked = fused_backward_records(timing=False)
    fused = fused_backward_records(timing=True)
    for name, rec in fused.items():
        wrapper_ms = sum(st["launches_per_forward"] * st["wrapper_ms"] for st in rec["stages"])
        log(f"  {name}: {rec['ms']:.4f} ms kernel through the model's backward ({wrapper_ms:.4f} ms "
            f"in the launch wrapper alone), {rec['plain_ms']:.4f} ms plain, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library none, per training step on {card}; per launch (model "
            f"backward/wrapper/bound/plain): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['ms']:.3f}/{st['wrapper_ms']:.3f}/"
                f"{max(st['bytes'] / H100_BYTES_PER_S, st['flops'] / H100_BF16_FLOPS) * 1e3:.3f}/"
                f"{st['plain_ms']:.3f}" for st in rec["stages"]))

    for name in SPLIT_BWD:
        rec = fused[name]
        log(f"  {name}: " + host_device_line(rec))
        log(f"  {name}: device ms per SwinV2-T step by kernel (the wrapper's calls): "
            + split_line(rec["kernels_ms"]))
        log(f"  {name}: composite yardstick (the unfused route's ops through autograd) "
            f"{rec['composite_ms']:.4f} ms per SwinV2-T step against {rec['ms']:.4f} ms through "
            "the kernels; per launch (kernels/composite): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} {st['ms']:.3f}/{st['composite_ms']:.3f}"
                for st in rec["stages"]))
    smem = _build.load("fused_halves_bwd").hvt_attention_half_bwd_smem
    log("  attention half backward kernels (ptxas, per instance; dynamic shared memory per block: "
        f"attention output {smem(0, 96)} B, core {smem(1, 96)} B, proj "
        + ", ".join(f"C={c} {smem(2, c)} B" for c in (96, 192, 384, 768)) + "): " + "; ".join(
            f"{source} {r['kernel']} {r['registers']} regs, spills {r['spill_stores']}/"
            f"{r['spill_loads']} B" for source, rows in ptxas.items()
            for r in rows if r["kernel"].startswith("attn_half_bwd_")))

    mlp_smem = _build.load("mlp").hvt_mlp_bwd_smem
    log("  MLP backward kernels, both sites (ptxas; dynamic shared memory per block, B, at C = "
        "96 / 768: " + "; ".join(f"{k} {mlp_smem(i, 96)} / {mlp_smem(i, 768)}" for i, k in enumerate(
            ("LayerNorm backward", "hidden", "dx", "grad_tn")))
        + "; fc1 and fc2 the forward's): " + "; ".join(
            f"{r['kernel']} {r['registers']} regs, {r['static_smem']} B static, spills "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in ptxas.get("mlp", [])
            if r["kernel"].startswith(("mlp_bwd_", "grad_tn", "sum_parts"))))

    log(f"[6] SwinV2-B: the fused halves' backward kernels and the chunked MLP vs plain "
        f"versions, bf16, batch {TRAIN_BATCH}")
    base_bwd_checked = fused_backward_records(False, BASE_STAGES)
    chunked_checked = chunked_records(timing=False)
    base_bwd = fused_backward_records(True, BASE_STAGES)
    chunked = chunked_records(timing=True)
    for name, rec in {**base_bwd, **chunked}.items():
        log(f"  SwinV2-B {name}: {rec['ms']:.4f} ms kernel through the model's backward or "
            f"forward, {rec['plain_ms']:.4f} ms plain, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library none, per SwinV2-B training step on {card}; per launch "
            "(kernel/wrapper/bound/plain ms): " + "; ".join(
                f"stage {st['stage']} shift {st['shift']} x{st['launches_per_forward']} "
                f"{st['ms']:.3f}/{st.get('wrapper_ms', st['ms']):.3f}/"
                f"{max(st['bytes'] / H100_BYTES_PER_S, st['flops'] / H100_BF16_FLOPS) * 1e3:.3f}/"
                f"{st['plain_ms']:.3f}" for st in rec["stages"]))
    rec = chunked["mlp_half_chunked_bwd"]
    log("  SwinV2-B mlp_half_chunked_bwd: " + host_device_line(rec))
    log("  SwinV2-B mlp_half_chunked_bwd: device ms per SwinV2-B step by kernel (the wrapper's "
        "calls): " + split_line(rec["kernels_ms"]))
    fwd = chunked["mlp_half_chunked_fwd"]
    log(f"  SwinV2-B mlp_half_chunked_fwd: composite yardstick (the unfused route's ops, no grad) "
        f"{fwd['composite_ms']:.4f} ms per SwinV2-B step against {fwd['ms']:.4f} ms through the "
        f"kernels; host {fwd['host_ms']:.4f} / device {fwd['device_ms']:.4f} ms per step in the "
        f"call; device ms by kernel: {split_line(fwd['kernels_ms'])}; fc1/fc2 TFLOP/s "
        + "/".join(f"{fwd['flops'] / 2 / fwd['kernels_ms'][k] / 1e9:.1f}" for k in ("fc1", "fc2")
                   if fwd["kernels_ms"].get(k)))
    log(f"  SwinV2-B mlp_half_chunked_bwd: composite yardstick (the unfused route's ops through "
        f"autograd) {rec['composite_ms']:.4f} ms per SwinV2-B step against {rec['ms']:.4f} ms "
        "through the kernels")

    log(f"[7] training SwinV2-T at 224 px, {CLASSES} classes, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps (hvt_torch.main), per route")
    train = {}
    for fuse in (False, True):
        label = f"fuse={fuse}"
        train[label], trainer = train_run(training_config(fuse=fuse),
                                          {k: 12 for k in TRAIN_KERNELS[fuse]}, label,
                                          EVAL_PER_FORWARD[f"swinv2_tiny fuse={fuse}"])
        del trainer
        train[label]["gradients"] = gradient_check(training_config(drop_path_rate=0.0, fuse=fuse),
                                                   label)
    kernels.append({
        "name": BWD_KERNEL, "route": "cuda", "source": BWD_SOURCE[0], "replaces": BWD_SOURCE[1],
        "launches": train["fuse=False"]["launches"][BWD_KERNEL] // TRAIN_STEPS,
        "max_abs_err": bwd_checked["max_abs_err"], "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
    })
    for name, (source, replaces) in FUSED_BWD.items():
        rec = fused[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train["fuse=True"]["launches"][name] // TRAIN_STEPS,
            "max_abs_err": fused_checked[name]["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
        })

    log(f"[8] bn_train's four calls (the two reductions with their finishes, the normalize and "
        f"dx passes) vs f64 sums and plain versions, bf16, the {len(RESNET_BN_SHAPES)} BatchNorm "
        f"shapes of ResNet-50 at batch {RESNET_BATCH}")
    bn_checked = bn_records(timing=False)
    bn_timed = bn_records(timing=True, host=True)
    for name, rec in bn_timed.items():
        log(f"  {name}: {rec['ms']:.4f} ms, {rec['plain_ms']:.4f} ms plain, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library {rec['library_ms']:.4f} ms, "
            f"host {rec['host_ms']:.4f} / device {rec['device_ms']:.4f} ms from an idle card, per "
            f"training step ({RESNET_BN_LAYERS} calls) on {card}; per call (ms/bound/plain/library "
            f"ms, host/device µs): " + "; ".join(
                f"{st['shape'][0]}x{st['shape'][1]} x{st['launches_per_forward']} {st['ms']:.4f}/"
                f"{st['bytes'] / H100_BYTES_PER_S * 1e3:.4f}/{st['plain_ms']:.4f}/"
                f"{st['library_ms']:.4f}, {st['host_ms'] * 1e3:.1f}/{st['device_ms'] * 1e3:.1f}"
                for st in rec["stages"]))
    bn_train_timed = bn_train_times()
    log(f"  bn_train a step on {card}: {bn_train_line(bn_train_timed)}")

    log(f"[9] training ResNet-50 at 224 px, {CLASSES} classes, batch {RESNET_BATCH}, "
        f"{RESNET_STEPS} steps (hvt_torch.main), bn_pallas true then false")
    resnet = {}
    resnet["bn_pallas=True"], trainer = train_run(
        resnet_config(True), {k: RESNET_BN_LAYERS for k in BN_KERNELS}, "resnet50 bn_pallas=True",
        EVAL_PER_FORWARD["resnet50"])
    resnet["bn_pallas=True"]["ema"] = check_ema(trainer, "resnet50 bn_pallas=True")
    del trainer
    # In bf16 the paths' f32 sums, equal to ~1e-7, flip some bf16 BatchNorm
    # outputs by an ulp, and 53 BatchNorm backwards magnify the flips in the
    # first layers' gradients: there the loss is held and the gradients are
    # recorded. In f32 nothing rounds to bf16, and every gradient is held.
    resnet["bn_pallas=True"]["gradients_bf16"] = gradient_check(
        resnet_config(True), "resnet50 bn_pallas=True bf16", randomize=False, hold_gradients=False)
    resnet["bn_pallas=True"]["gradients_bf16_exact_sums"] = gradient_check(
        resnet_config(True), "resnet50 bf16, plain path with f64 sums (no kernel)", randomize=False,
        hold_gradients=False, path=exact_bn_reductions)
    resnet["bn_pallas=True"]["gradients"] = gradient_check(
        resnet_config(True, "float32"), "resnet50 bn_pallas=True f32", randomize=False)
    resnet["bn_pallas=False"], trainer = train_run(resnet_config(False), {},
                                                   "resnet50 bn_pallas=False", {})
    resnet["bn_pallas=False"]["ema"] = check_ema(trainer, "resnet50 bn_pallas=False")
    del trainer
    for name, (source, replaces) in BN_KERNELS.items():
        rec = bn_timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": resnet["bn_pallas=True"]["launches"][name],
            "max_abs_err": bn_checked[name]["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })

    log(f"[10] training SwinV2-B on fuse: true at 224 px, {CLASSES} classes, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps (hvt_torch.main), grad_accum auto")
    base_train, trainer = train_run(training_config("swinv2_base", "auto", fuse=True),
                                    BASE_TRAIN_PER_STEP, "swinv2_base fuse=True",
                                    EVAL_PER_FORWARD["swinv2_base fuse=True"])
    log(f"  grad_accum auto resolved to {trainer.grad_accum} for batch {TRAIN_BATCH} on {card}")
    if trainer.grad_accum != 1:
        raise AssertionError(f"grad_accum auto resolved to {trainer.grad_accum}, not 1")
    del trainer
    base_train["gradients"] = gradient_check(
        training_config("swinv2_base", drop_path_rate=0.0, fuse=True), "swinv2_base fuse=True")
    for name, (source, replaces) in CHUNKED.items():
        rec = chunked[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": base_train["launches"][name],
            "max_abs_err": chunked_checked[name]["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
        })

    log(f"[11] the fused block's other routes: training SwinV2-T at 224 px, {CLASSES} classes, "
        f"batch {TRAIN_BATCH} (hvt_torch.main); hvt's window_attention op on split q, k, v")
    routes_train = {}
    mlp_pair = {"mlp_half_fwd": 12, "mlp_half_bwd": 12}
    nhwc_eval = EVAL_PER_FORWARD["swinv2_tiny fuse=True"]  # eval runs no fuse_attn_train route
    for label, knobs, steps, per_step, per_eval in (
            ("fuse_nhwc=False", {"fuse_nhwc": False}, TRAIN_STEPS,
             {**mlp_pair, "attention_half_fwd": 12, "attention_half_bwd": 12},
             {"mlp_half_fwd": 12, "attention_half_fwd": 12}),
            ("fuse_resid=False", {"fuse_resid": False}, ROUTE_STEPS,
             {**mlp_pair, "attention_half_nhwc_fwd": 12, "attention_half_nhwc_bwd": 12}, nhwc_eval),
            ("fuse_attn_train=False fallback_xla=False",
             {"fuse_attn_train": False, "fallback_xla": False}, ROUTE_STEPS,
             {**mlp_pair, "window_attention_packed_fwd": 12, BWD_KERNEL: 12}, nhwc_eval)):
        rec, trainer = train_run(training_config(fuse=True, steps=steps, **knobs), per_step,
                                 f"fuse=True {label}", per_eval)
        del trainer
        if label != "fuse_attn_train=False fallback_xla=False":
            rec["gradients"] = gradient_check(
                training_config(drop_path_rate=0.0, fuse=True, **knobs), f"fuse=True {label}")
        routes_train[label] = rec
    routes_train["window_attention"] = split_op_run()
    new_timed = {"attention_half_fwd": timed["attention_half_fwd"],
                 "attention_half_bwd": fused["attention_half_bwd"],
                 "window_attention_fwd": timed["window_attention_fwd"],
                 "window_attention_bwd": split_bwd}
    new_checked = {"attention_half_fwd": checked["attention_half_fwd"],
                   "attention_half_bwd": fused_checked["attention_half_bwd"],
                   "window_attention_fwd": checked["window_attention_fwd"],
                   "window_attention_bwd": split_checked}
    for name, (source, replaces) in {**WINDOWED, **SPLIT}.items():
        rec, check = new_timed[name], new_checked[name]
        run = routes_train["window_attention" if name in SPLIT else "fuse_nhwc=False"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": run["launches"][name], "max_abs_err": check["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })

    log(f"[12] the retired fused halves as their caller composes them: SwinV2-T's 12 block "
        f"shapes at batch {BATCH}, f32 and bf16")
    retired_run = retired_op_run()
    log("  the branches' device kernels (profiled, ms over the 24 launches): " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(retired_run["device_kernels_ms"].items(),
                                          key=lambda kv: -kv[1])))
    for name, (source, replaces) in RETIRED.items():
        rec, check = timed[name], checked[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": retired_run["launches"][name], "max_abs_err": check["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
        })

    log(f"[13] evaluation through hvt_torch.main at 224 px, {CLASSES} classes, batch "
        f"{EVAL_BATCH}, {EVAL_IMAGES} images: SwinV2-T on both routes, ResNet-50 with EMA, "
        "SwinV2-B on fuse: true")
    evaluation = evaluation_phase(card)

    log(f"[14] checkpoints on the card: SwinV2-T fuse: true ({CKPT_STEPS} steps, resumed from "
        f"{CKPT_AT}), ResNet-50 with EMA ({RESNET_CKPT_STEPS} steps, resumed from "
        f"{RESNET_CKPT_AT}), SIGTERM, swin:// and serving's load_path, the cost of a checkpoint")
    checkpoints = checkpoint_phase(card)

    log(f"[15] training from JPEG folders: the fixture, the loader alone, ResNet-50 "
        f"(inat21.yaml, progressive resizing) and SwinV2-T fuse: true from it, the input bench, "
        f"the device augmentations against the CPU, a resume with every augmentation")
    folders = input_phase(card, host)

    log(f"[16] downstream on the card: feature extraction and its cache (ResNet-50, SwinV2-T fuse: "
        f"true), SimpleShot and the linear probe's grid search against the CPU's f64 fits, the "
        f"entry points on a JPEG fixture, HTTP serving of ResNet-50 and SwinV2-B, serve_bench")
    downstream = downstream_phase(card)

    log(f"[17] the rest of training: inat21.yaml + hot_tpu.yaml (ResNet-50, SAM, bn_pallas), "
        f"swinv2_tiny.yaml and SwinV2-B at their batch of 2048 with grad_accum auto; "
        f"accumulation and SAM against one pass and the plain path; recomputation; ape; "
        f"bn_custom and bn_groups ({CLASSES} classes, synthetic source)")
    t17 = time.perf_counter()
    rest = rest_of_training_phase(card)
    rest["wall_s"] = time.perf_counter() - t17

    log("[18] ViT and DINOv2 through the flash-attention kernels: the kernels against their "
        "plain versions and beside SDPA; vit_b16.yaml (ViT-B/16) at 2,048 with grad_accum auto "
        "on use_flash true and false; DINOv2-B/14's linear probe and SimpleShot features")
    t18 = time.perf_counter()
    vit = vit_phase(card)
    vit["wall_s"] = time.perf_counter() - t18
    from hvt_torch.ops import flash_attention as fa

    vit["ptxas"] = [r for r in ptxas.get("flash_attention", []) if "flash" in r["kernel"]]
    log("  flash kernels (ptxas): " + "; ".join(
        f"{r['kernel']} {r['registers']} regs, {r['static_smem']} B static smem, spills "
        f"{r['spill_stores']}/{r['spill_loads']} B" for r in vit["ptxas"])
        + "; dynamic shared memory per block and blocks an SM (forward, dK/dV, dQ) at N = "
        + ", ".join(f"{n}: {fwd.smem} / {dkv.smem} / {dq.smem} B, {occ[0]} / {occ[1]} / {occ[2]}"
                    for n in (197, 257, 1025, 1370)
                    for (fwd, dkv, dq), occ in [(fa.flash_plan(n), flash_occupancy(n))]))
    flash_run = vit["train"]["vit_base_patch16_224 use_flash=True"]
    timed_flash = vit["times"][0]["kernels"]
    for name, (source, replaces, _) in FLASH.items():
        rec = timed_flash[name]
        check = max(c[g]["max_abs_err"] for c in vit["checks"] if not c["negative_row"]
                    for g in (("o",) if name == "flash_attention_fwd" else
                              ("dk", "dv") if name == "flash_attention_bwd_dkv" else ("dq",)))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": flash_run["launches"][name], "max_abs_err": check,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })

    log(f"[19] ConvNeXt, RegNet-Y and EfficientNet (no kernel of the repository): the card "
        f"against the CPU in f32; convnext_tiny.yaml and regnety_040.yaml at 2,048 with "
        f"grad_accum auto; EfficientNet-B0 on inat21.yaml's recipe at {EFFNET_BATCH}; "
        f"recomputation; HTTP serving of ConvNeXt-T ({CLASSES} classes, synthetic source)")
    t19 = time.perf_counter()
    families = families_phase(card)
    families["wall_s"] = time.perf_counter() - t19

    log("[20] data parallelism over torch.distributed, a world of one through NCCL: bn_train "
        "at ResNet-50's 53 BatchNorm shapes under the group against one process; inat21.yaml's "
        "ResNet-50 and swinv2_tiny.yaml fuse: true under the group and without, bit-equal; "
        "torchrun --nproc_per_node=1 -m hvt_torch.main")
    data_parallel = data_parallel_phase(card)
    bn = data_parallel["bn_train"]
    kernels.append({
        "name": "bn_finish", "route": "cuda", "source": BN_FINISH[0], "replaces": BN_FINISH[1],
        "launches": data_parallel["bn_finish_launches"],
        "max_abs_err": bn["finish_max_abs_err"], "ms": bn["finish_ms"],
        "plain_ms": bn["finish_plain_ms"], "bound_ms": bn["finish_bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })

    log("[21] tensor parallelism (mesh.model) and ZeRO-1 (mesh.zero), two gloo ranks on this "
        "card: SwinV2-T fused and unfused and ViT-B/16 on flash with model 2 against one "
        "process; ResNet-50 (bn_pallas, EMA) and SwinV2-T fused with zero against data "
        "parallelism, bit-equal")
    grid = grid_phase(card)

    log("[22] SwinV2-T with 8 experts (moe_experts: 8): 3 steps on fuse: true and on fuse: "
        "false against the plain path, swinv2_tiny.yaml's 2,048 with grad_accum auto, "
        "evaluation and HTTP serving, expert parallelism on two gloo ranks at model: 2")
    moe = moe_phase(card)

    log("[23] int8 w8a8 serving (--quantize int8): the int8 conv kernel against its plain "
        "version at every conv shape of ResNet-50, ConvNeXt-T, EfficientNet-B0 and "
        "RegNetY-4.0GF, timed beside bf16 F.conv2d; int8_linear beside bf16 F.linear; the int8 "
        "engine (dynamic and calibrated) of ResNet-50, SwinV2-T on both routes and ConvNeXt-T; "
        "img/s; python -m hvt_torch.serve --quantize int8 --calibrate 2")
    int8 = int8_phase(card)
    end_phase()
    for name, replaces in INT8_KERNELS.items():
        per = int8["conv_times"]["resnet50"]["per_forward"]["kernel" if name == "int8_conv"
                                                           else "dequant"]
        kernels.append({
            "name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": replaces,
            "launches": int8["launches"][name], "max_abs_err": int8["max_abs_err"][name],
            "ms": per["ms"], "plain_ms": per["plain_ms"], "bound_ms": per["bound_ms"],
            "bound_by": ("bytes" if per.get("bound_bytes_ms", 0.0)
                         >= per.get("bound_operations_ms", 0.0) else "operations"),
            "library_ms": None,
        })

    report = {"card": card, "host": host, "folders": folders, "downstream": downstream,
              "data_parallel": data_parallel, "grid": grid, "moe": moe, "int8": int8,
              "phase_seconds": PHASE_SECONDS,
              "rest_of_training": rest, "vit": vit, "families": families,
              "batch": BATCH, "kernels": kernels,
              "routes": routes,
              "evaluation": evaluation, "checkpoints": checkpoints,
              "kernel_stages": {k: {"check": checked[k]["stages"], "timed": timed[k]["stages"]}
                                for k in FORWARD_NAMES},
              "backward_stages": {"check": bwd_checked["stages"], "timed": bwd["stages"]},
              "fused_backward_stages": {k: {"check": fused_checked[k]["stages"],
                                            "timed": fused[k]["stages"]} for k in FUSED_GRADS},
              "forward_splits": {k: {f: timed[k][f] for f in (
                  "ms", "plain_ms", "bound_ms", "design_floor_ms", "composite_ms", "host_ms",
                  "device_ms", "kernels_ms")} for k in FWD_SPLITS},
              "forward_composite_ms": {"mlp_half_fwd": timed["mlp_half_fwd"]["composite_ms"],
                                       "mlp_half_chunked_fwd":
                                           chunked["mlp_half_chunked_fwd"]["composite_ms"]},
              "fused_backward_splits": {k: {f: fused[k][f] for f in (
                  "ms", "plain_ms", "bound_ms", "composite_ms", "kernels_ms")}
                  for k in SPLIT_BWD},
              "split_backward_stages": {"check": split_checked["stages"],
                                        "timed": split_bwd["stages"]},
              "backward_f32_check": {"packed": bwd_f32["stages"], "split": split_f32["stages"]},
              "ptxas": ptxas,
              "window_attention_fwd_f32": {"check": checked["window_attention_fwd_f32"]["stages"],
                                           "timed": timed["window_attention_fwd_f32"]["stages"]},
              "window_attention_forwards": {
                  "ms": {k: timed[k]["ms"] for k in WA_FORWARDS},
                  "library_ms": {k: timed[k]["library_ms"] for k in WA_FORWARDS},
                  "bound_ms": {k: timed[k]["bound_ms"] for k in WA_FORWARDS},
                  "host_ms": {k: timed[k]["host_ms"] for k in WA_FORWARDS},
                  "device_ms": {k: timed[k]["device_ms"] for k in WA_FORWARDS},
                  "n144_relative_errors": wide_checked},
              "routes_train": routes_train,
              "retired": {"op_run": retired_run,
                          "swinv2_base_check": {k: base_checked[k]["stages"]
                                                for k in RETIRED_CASES},
                          "timed": {label: {k: {f: recs[k][f] for f in (
                              "ms", "plain_ms", "composite_ms", "bound_ms", "f32_rate_bound_ms",
                              "design_floor_ms", "host_ms", "device_ms", "kernels_ms", "stages")}
                              for k in RETIRED_CASES}
                              for label, (recs, _) in retired_timed.items()}},
              "train": train,
              "bn_stages": {k: {"check": bn_checked[k]["stages"], "timed": bn_timed[k]["stages"]}
                            for k in BN_KERNELS},
              "bn_per_step": {k: {f: bn_timed[k][f] for f in (
                  "ms", "plain_ms", "library_ms", "bound_ms", "host_ms", "device_ms")}
                  for k in BN_KERNELS},
              "bn_train": bn_train_timed,
              "resnet50": resnet,
              "swinv2_base": {
                  "forward_stages": {k: {"check": base_checked[k]["stages"],
                                         "timed": base_timed[k]["stages"]} for k in base_timed},
                  "forward_per_step": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by")}
                                       for k, v in base_timed.items()},
                  "backward_stages": {k: {"check": base_bwd_checked[k]["stages"],
                                          "timed": base_bwd[k]["stages"]} for k in FUSED_GRADS},
                  "backward_per_step": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by")}
                                        for k, v in base_bwd.items()},
                  "chunked_forward_split": {f: chunked["mlp_half_chunked_fwd"][f] for f in (
                      "ms", "bound_ms", "composite_ms", "host_ms", "device_ms", "kernels_ms")},
                  "chunked": {k: {"check": chunked_checked[k]["stages"],
                                  "timed": chunked[k]["stages"]} for k in CHUNKED},
                  "train": base_train}}
    if args.profile:
        report["profile"] = {f"fuse={f}": profile_route(f) for f in (False, True)}
        for route, rows in report["profile"].items():
            log(f"  profile {route}: " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_forward']:.3f} ms x{r['calls']}" for r in rows[:8]))
        for fuse in (False, True):
            prof = report["profile"][f"train_step fuse={fuse}"] = profile_train_step(
                training_config(fuse=fuse), PROFILE_NAMES[fuse])
            prof["share_of_median_step"] = prof["device_ms"] / train[f"fuse={fuse}"]["step_ms_median"]
            log(f"  profile train step fuse={fuse}: {prof['device_ms']:.2f} ms of kernel time in a "
                f"{prof['step_ms']:.2f} ms profiled step (busy {100 * prof['busy_share']:.1f}%; "
                f"{100 * prof['share_of_median_step']:.1f}% of phase 7's median step), backward "
                f"kernels {prof['backward_kernel_ms']:.3f} ms ({100 * prof['backward_kernel_share']:.1f}%), "
                f"forward kernels {prof['forward_kernel_ms']:.3f} ms; " + "; ".join(
                    f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["rows"][:12]))
            opt = prof["optimizer"]
            log(f"  optimizer update alone (median of 5): host {opt['host_ms']:.3f} ms, device span "
                f"{opt['span_ms']:.3f} ms, kernel time {opt['kernel_ms']:.3f} ms")
            log("  profile train step by operator (device time of the kernels each launched; "
                "Optimizer.step's is the span of its launches): " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["ops"][:12]))
        for pallas in (True, False):
            label = f"bn_pallas={pallas}"
            prof = report["profile"][f"resnet50 train_step {label}"] = profile_train_step(
                resnet_config(pallas), PROFILE_NAMES["resnet"])
            prof["share_of_median_step"] = prof["device_ms"] / resnet[label]["step_ms_median"]
            log(f"  profile ResNet-50 train step {label}: {prof['device_ms']:.2f} ms of kernel time "
                f"in a {prof['step_ms']:.2f} ms profiled step (busy {100 * prof['busy_share']:.1f}%; "
                f"{100 * prof['share_of_median_step']:.1f}% of phase 9's median step), BatchNorm "
                f"kernels: backward {prof['backward_kernel_ms']:.3f} ms, forward "
                f"{prof['forward_kernel_ms']:.3f} ms; " + "; ".join(
                    f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["rows"][:14]))
            log("  by operator: " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["ops"][:14]))
        prof = report["profile"]["train_step fuse=True fuse_nhwc=False"] = profile_train_step(
            training_config(fuse=True, fuse_nhwc=False), PROFILE_NAMES[True])
        prof["share_of_median_step"] = (prof["device_ms"]
                                        / routes_train["fuse_nhwc=False"]["step_ms_median"])
        log(f"  profile train step fuse=True fuse_nhwc=False: {prof['device_ms']:.2f} ms of kernel "
            f"time in a {prof['step_ms']:.2f} ms profiled step (busy {100 * prof['busy_share']:.1f}%; "
            f"{100 * prof['share_of_median_step']:.1f}% of phase 11's median step), backward "
            f"kernels {prof['backward_kernel_ms']:.3f} ms, forward kernels "
            f"{prof['forward_kernel_ms']:.3f} ms; " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["rows"][:14]))
        log("  by operator: " + "; ".join(
            f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["ops"][:14]))
        label = "fuse_attn_train=False fallback_xla=False"
        prof = report["profile"][f"train_step fuse=True {label}"] = profile_train_step(
            training_config(fuse=True, fuse_attn_train=False, fallback_xla=False),
            PROFILE_NAMES["packed_fused"])
        prof["share_of_median_step"] = prof["device_ms"] / routes_train[label]["step_ms_median"]
        log(f"  profile train step fuse=True {label}: {prof['device_ms']:.2f} ms of kernel "
            f"time in a {prof['step_ms']:.2f} ms profiled step (busy {100 * prof['busy_share']:.1f}%; "
            f"{100 * prof['share_of_median_step']:.1f}% of phase 11's median step), backward "
            f"kernels {prof['backward_kernel_ms']:.3f} ms, forward kernels "
            f"{prof['forward_kernel_ms']:.3f} ms; " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["rows"][:14]))
        prof = report["profile"]["swinv2_base train_step fuse=True"] = profile_train_step(
            training_config("swinv2_base", fuse=True), PROFILE_NAMES["base"])
        prof["share_of_median_step"] = prof["device_ms"] / base_train["step_ms_median"]
        log(f"  profile SwinV2-B train step fuse=True: {prof['device_ms']:.2f} ms of kernel time in "
            f"a {prof['step_ms']:.2f} ms profiled step (busy {100 * prof['busy_share']:.1f}%; "
            f"{100 * prof['share_of_median_step']:.1f}% of phase 10's median step), backward "
            f"kernels {prof['backward_kernel_ms']:.3f} ms, forward kernels "
            f"{prof['forward_kernel_ms']:.3f} ms; " + "; ".join(
                f"{r['name'][:40]} {r['ms_per_step']:.3f} ms x{r['calls']}" for r in prof["rows"][:16]))
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] every phase passed in {time.perf_counter() - started:.1f} s; seconds by phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for root in _RUNS + _FIXTURES:
            shutil.rmtree(root, ignore_errors=True)
    sys.exit(code)
