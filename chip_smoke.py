"""Smoke run of the PyTorch port on one CUDA GPU (an H100 is the target).

    python3 chip_smoke.py

From the root of a checkout, in phases; any failure ends the run with a
nonzero exit code and no result line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. builds the eleven kernels (five Swin block kernels and the W8A8 joint
   block, the window attention forward and backward, the deformable sampler
   forward and backward, the 3x3 convolution) from
   ``basicsr4rs_torch/csrc/`` with nvcc, all at once;
3. holds each kernel against its plain PyTorch version on the card at
   SwinIR-M block shapes (C=180, 6 heads, window 8, hidden 360), without
   and with the shift mask, in float32 and bfloat16, and times both: the
   joint forward kernel also at the shapes of the served requests, at
   SwinIR-light's widths (C=60, heads of 10), with a window of 4 and at
   SwinIR-L2S's block (window 6: 36 tokens in each 64-row tile, shifted by
   3 under a mask of 256 x 36 x 36, B=1 and the training batch of 8 of
   96x96, the latter under DropPath's scales); the
   attention and MLP branch kernels, forward and backward, at the training
   shape (batch 4 of 48x48) in their three output modes, every gradient by
   name, and where their tiles are padded: the attention kernels at
   SwinIR-light's widths, a window of 4 and heads of 48, the MLP kernels at
   SwinIR-light's widths and at 480 tokens (not a multiple of their
   64-token tile), and both forward kernels at the eval route's widths past
   the joint kernel's (C=180 in 3 heads of 60, C=240 in 8 heads of 30), and
   all four at SwinIR-L2S's training batch (window 6, both dtypes, shifted
   and not, with DropPath's scales and without; timed shifted with them,
   the attention kernels with the share of their window units' tile rows
   that are padding); the
   two forward kernels, which add nothing atomically, must repeat bit for
   bit, the attention forward's two launches' device time is read by
   ``torch.profiler``, and the MLP forward's grid is printed (units, parts
   of the hidden chunks, blocks an SM, how full the waves are);
   the window-attention kernels at the shapes of the
   ResShift UNet (C=192, 6 heads of 32, window 8; maps of 64, 32, 16 and 8;
   batch 1 and the training batch; with the shift mask and without), at
   window 9 on the latents of ``train_ResShift_L2S288.yml`` (maps of 72, 36
   and 18 shifted by 4, and 9 as one window; its batch 32 in bfloat16, 16 in
   float32), at the joint align-diffusion model's middle block (B=12 of
   8x8: one window of 64 tokens, no shift; both dtypes) and at C=180 with
   heads of 30, beside
   ``F.scaled_dot_product_attention`` (and its backward by autograd) as a
   yardstick, with each kernel's grid and fill (units, samples a unit,
   blocks an SM, stages) and, for the forward at batch 1, its device time;
   the deformable sampler's kernels (3d) at the shapes EDVR-M gives them
   (64 channels in 8 groups, nine taps; training batch 4 x 5 frames of 64x64
   and a served window of 5 frames of 180x320, all three pyramid levels) and
   BasicVSR++ (128 channels in 16 groups; one tap on 64-, 3- and 2-channel
   maps for the flow warps, also with ``border``), with offsets small and
   large enough to leave the map and whole positions among them (for the
   backward also offsets that send most corners past its window and
   whole-number offsets on the window's edges; per case its plan, the share
   of corners it summed in device memory, and d offset and d mask repeating
   bit for bit), beside
   ``F.grid_sample`` as the one-tap yardstick, and the warps as ``flow_warp``
   runs them (the flow read through its strides; call time and device time
   beside ``F.grid_sample``'s; gradients); the 3x3 convolution kernel
   (3e) at the shapes SwinIR-M x4 gives it (180->180 on the LQ map, 180->64,
   64->256 on the LQ and the 2x map, 64->64 on the 4x map, one odd size; and
   180->180 channels-last and as the RSTB's view of its tokens), all four
   epilogues in both types, beside ``F.conv2d`` + its epilogue, and its
   gradients; the same check again (3g) at EDSR-L x4's upsampler
   convolutions in training (B=16, 256 -> 1024 on 48x48 and 96x96) and
   RCAN x2's (B=16, 64 -> 256 on 48x48), in float32; the
   W8A8 joint block (3f) against its plain version by the rule stated there,
   against the float block by SNR, and timed beside the float kernel, also
   past the float kernel's widths (C=180 in 3 heads of 60, C=240 in 8 heads
   of 30, B=2 64x64: its wide variant);
4. serves SwinIR-M x4 through ``basicsr4rs_torch.test`` (the code path of
   ``python -m basicsr4rs_torch.test -opt options/test/SwinIR/
   test_SwinIR_M_x4_synthetic.yml``) on 4 synthetic image pairs and random
   seed-0 weights that it writes first, counts the kernel's launches, checks
   the outputs and times each request; 4b breaks one request of each size
   down by kernel group with ``torch.profiler``;
5. runs one request again with every block on the plain version and
   compares the two outputs;
6. trains SwinIR-M x4 through ``basicsr4rs_torch.train`` (the code path of
   ``python -m basicsr4rs_torch.train -opt options/train/SwinIR/
   train_SwinIR_M_x4_synthetic.yml``) for 8 steps of batch 4 at GT 192 on
   synthetic pairs that it writes first, with two validations and
   checkpoints inside: counts every kernel's launches per step, checks that
   the loss is finite and falls on a fixed batch, the EMA, the saved
   ``.pth`` and a resume from the saved ``.state``, times the steps, and
   breaks three more steps down by kernel with ``torch.profiler``;
7. runs one training batch forward and backward through the kernels and
   through their plain versions, with the same DropPath masks, and compares
   the loss and every parameter's gradient;
8. serves ResShift x4 through ``basicsr4rs_torch.test`` (``-opt
   options/test/ResShift/test_ResShift_x4_synthetic.yml``: UNetModelSwin at
   the published width behind a VQ-f4 first stage, 15 reverse steps) on 4
   synthetic pairs and seed-0 weights that it writes first: 270 launches of
   the attention kernel a request, latency after a warm-up request, one
   request again on the plain versions with the same seed, and where the
   device time of a request goes (``torch.profiler``);
9. trains it through ``basicsr4rs_torch.train`` (``-opt
   options/train/ResShift/train_ResShift_x4_synthetic.yml``) for 8 steps:
   18 launches of each attention kernel a step, finite losses, step time,
   peak memory, EMA, checkpoint, resume, the device time of a step by
   kernel, and two steps under bfloat16 autocast;
10. runs one ResShift training batch forward and backward through the
    kernels and through the plain versions and compares every gradient;
    10b. builds ``UNetModelSwin`` from ``network_g`` of
    ``options/train/ResShift/train_ResShift_L2S288.yml`` as it stands
    (window 9, 6 channels in and out, latents 72x72) with seed-0 weights and
    runs B=2 forward and backward through the kernels (18 launches of each
    attention kernel) and through the plain versions: the output and every
    gradient;
11. serves EDVR-M x4 through ``basicsr4rs_torch.test`` (``-opt
    options/test/EDVR/test_EDVR_M_x4_synthetic.yml``: ``VideoTestDataset``,
    windows of 5 LQ frames of 180x320, per-clip PSNR) on two synthetic clips
    and seed-0 weights that it writes first: 4 launches of the sampler a
    request, latency after a warm-up request, one request again on the plain
    versions, the device time of a request by kernel;
12. trains it through ``basicsr4rs_torch.train`` (``-opt
    options/train/EDVR/train_EDVR_M_x4_synthetic.yml``: ``REDSDataset``,
    batch 4, GT 256) for 8 steps: 4 forward and 4 backward launches a step,
    a finite loss that falls on the first batch, the end of the TSA-only
    warm-up at iteration 4 (a frozen parameter keeps its value before it and
    moves from it on), EMA, checkpoint, resume, step time, peak memory, the
    device time of a step by kernel;
13. runs one EDVR training batch forward and backward through the kernels
    and through the plain versions and compares every gradient;
14. to 16. the same three for BasicVSR++ (``options/test/BasicVSRPP/
    test_BasicVSRPP_x4_synthetic.yml``: one clip of 30 frames of 180x320 in
    one forward, 462 launches, and its device memory stage by stage;
    ``options/train/BasicVSRPP/
    train_BasicVSRPP_x4_synthetic.yml``: ``REDSRecurrentDataset``, batch 1 of
    30 frames, 462 forward and 461 backward launches a step, SpyNet frozen
    before iteration 4; one request and one step by kernel);
17. serves SwinIR-M x4 through ``basicsr4rs_torch.test`` again with
    ``SWIN_FUSED_CONV=1``: 10 launches of the convolution kernel a forward,
    outputs against the cuDNN route, latency of both routes;
18. runs it under ``quantized_inference(net, min_channels=10**9,
    swin_kernels=True)`` at B=16 of LQ 64x64 and at the 128x128 request: 36
    launches of the W8A8 block a forward, the kernel route against the plain
    route, SNR against the float output with the blocks' linears redrawn at
    full scale, output MP/s of both;
19. serves MSRResNet x4 through ``basicsr4rs_torch.test`` (``-opt
    options/test/SRResNet_SRGAN/test_MSRResNet_x4_synthetic.yml``) in float,
    ``val:quant_int8=true`` and ``=static``: SNR against float, latency of
    the three; then trains it for 8 steps through ``basicsr4rs_torch.train``
    (``-opt options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml``);
20. runs ``basicsr4rs_torch.inference.inference_swinir --tile 128`` on one LQ
    512x512 image (16 tiles in one batch) and holds it against the untiled
    forward, with the device memory of both (and of the tiled one with
    ``SWIN_FUSED_CONV=1``) stage by stage; MSRResNet tiled with a pad that
    covers its receptive field;
21. trains SwinIR-M x4 for 4 steps with ``SWIN_JOINT_TRAIN=1``: launch
    counts per step, gradients against the split route, step time;
22. serves SwinIR (depths [2, 2], LQ 64x64, eval) at widths past the joint
    kernel's: C=180 in 3 heads of 60 and SwinIR-L's C=240 in 8 heads of 30
    through the attention and MLP branch forward kernels, no joint launch,
    against its plain forward; then, with the blocks' linears at full scale,
    under ``swin_kernels=True``: the W8A8 block alone, against the float
    forward by phase 18's SNR bound; a width refused fails the phase;
59. (in the serving modes, after 22) exports SwinIR-M x4 with
    ``python -m basicsr4rs_torch.scripts.export_serving --device cuda`` under
    ``SWIN_FUSED_CONV=1`` (seed-0 weights, one 128x128 bucket) into a
    temporary directory, loads it with ``ServingModel`` and serves a
    128x128 and a 120x124 request with the switch off: 36 K1 and 10 K10
    launches a request read from the served run alone, outputs against the
    live network (bit for bit or within ``F32_TOL``), export time, served
    and live latency;
60. the same for phase 22's C=240 network (one 64x64 bucket): K2 and K4 a
    block, no K1;
61. MSRResNet x4 with static int8 scales calibrated on one batch (one 64x64
    bucket at batch 4, a request of 3 at 60x60) against the live
    ``quantized_inference`` run, and its SNR against float;
62. (beside phase 71a, whose scripts keep the card idle; in ``serving``
    mode after 61) a second interpreter serves phase 59's directory: K1 and
    K10 launch there, the port's networks, models and registries are never
    imported, the output is this process's;
23. writes a synthetic Landsat -> Sentinel tree (``results/chip_smoke/l2s``:
    40 windows of uint16 TIFFs, Landsat a 3x area average of Sentinel) and
    trains SwinIR-L2S x3 through ``basicsr4rs_torch.train`` (``-opt
    options/train/SwinIR/train_SwinIR_L2S288_synthetic.yml``: 6 bands,
    window 6, batch 8 at GT 288, ``use_amp``) for 8 steps: 36 launches of
    K2 to K5 a step, the dtype the blocks are handed (float32 alone, or the
    phase fails), a loss that falls on the first batch, one validation on ``net_g_ema`` (per-image CSV of band
    PSNR/SSIM and NIQE, RGB and NSS PNGs), EMA and checkpoint, step time,
    peak memory, and 2 steps by kernel with ``torch.profiler``;
24. holds that model's output, loss and every gradient against the plain
    versions on one training batch in float32, the dtype its blocks get
    under ``use_amp``;
25. serves it through ``basicsr4rs_torch.test`` (``-opt
    options/test/SwinIR/test_SwinIR_L2S288_synthetic.yml``, LQ 96x96): 36 K1
    launches a request, latency, where a validation item's host time goes,
    and one request of ``SwinIRHMModel`` on ``SwinIR_StyleCNN`` with both
    outputs scored;
26. trains ResShift-L2S x3 (``-opt
    options/train/ResShift/train_ResShift_L2S288_synthetic.yml``: window 9,
    72x72 latents of 6 bands, batch 32, ``use_amp``) for 8 steps: 18
    launches of K6 and of K7 a step in bfloat16, step time, peak memory, the
    device time of a step by kernel;
27. samples it through ``basicsr4rs_torch.test`` (``-opt
    options/test/ResShift/test_ResShift_L2S288_synthetic.yml``): 2 requests
    of 15 reverse steps, 270 K6 launches each, latency, the device time of a
    request by kernel;
28. writes random LPIPS weights (``results/chip_smoke/lpips``) and trains
    the registration autoencoder (``-opt options/train/AlignAutoencoder/
    train_Registration_L2S_Square192_synthetic.yml``: ``RegistrationModel``
    on ``StyleResNet``, 12 -> 6 bands, 64 features, 8 blocks, batch 12 at
    GT 192, ``use_amp``) for 8 steps from seed-0 weights with its channel
    gates opened: step time, peak memory, a loss that falls on the first
    batch, one validation of its 26 metrics (CSV, RGB and NSS PNGs) and
    the host time of each metric type on one item, LPIPS's on the card,
    and one step by kernel (28b);
29. trains the joint align-diffusion model (``-opt options/train/
    AlignResDiff/train_AlignResDiff_3loss_L2S_Square192_synthetic.yml``:
    ``AlignJointDiffModel`` on ``ResNetAE_SwinUNet``, the published widths,
    batch 12 at GT 66, ``use_amp``) for 8 steps: the K6 and K7 launches of
    each step, counted from the UNet's Swin blocks (2 and 2) and read back,
    the dtype they are made in (bfloat16 alone, or the phase fails), step
    time, peak memory, one validation, one step by kernel with
    ``torch.profiler`` (29b, as 28b for phase 28); 29c holds it in float32
    against the plain versions on seed-0 weights: one batch's loss and every
    gradient, and a request's output from the same noises;
30. serves it through ``basicsr4rs_torch.test`` (``-opt options/test/
    AlignResDiff/test_AlignResDiff_3loss_L2S_Square192_synthetic.yml``,
    seed-0 weights it writes first): 30 K6 launches a request, latency, the
    device time of a request by kernel;
31. trains SRCNN x3 on 6 bands (``-opt options/train/SRCNN/
    train_SRCNN_L2S288_synthetic.yml``: ``L2SSingleModel``, batch 8 at GT
    288, ``use_amp``) for 8 steps: a loss that falls on the first batch,
    one validation;
32. writes ``datasets/CNN_x4_synthetic/`` (16 train pairs of GT 256x256, two
    to serve of LQ 128x128 and 96x160) and a random He-scaled VGG19 in
    torchvision's layout (``results/chip_smoke/vgg19.pth``, which the
    perceptual losses read as their ``pretrain_path``), and
    trains ESRGAN x4 (``-opt options/train/ESRGAN/
    train_ESRGAN_x4_synthetic.yml``: RRDBNet 64 x 23, VGGStyleDiscriminator
    64, perceptual, GAN and pixel losses, EMA; batch 16, GT 128) for 6 steps
    from random weights: every logged loss finite, step time, peak memory,
    the G phase's discriminator passes keeping its BatchNorm statistics, the
    EMA moved, the checkpoint reloading to the EMA network's output; 32b
    breaks one step down by kernel group;
33. serves RRDBNet x4 through ``basicsr4rs_torch.test`` (``-opt options/
    test/ESRGAN/test_ESRGAN_x4_synthetic.yml``) and through
    ``basicsr4rs_torch.inference.inference_esrgan`` from one random
    ``params_ema`` checkpoint: the same images, latency, and (33b) the
    device time of a request by kernel group;
34. serves and trains EDSR-L x4 (``options/{test,train}/EDSR/
    *_EDSR_Lx4_synthetic.yml``: 256 features, 32 blocks; batch 16, GT 192)
    with ``SWIN_FUSED_CONV=1`` (2 K10 launches a forward, 256 -> 1024) and
    without: the two routes' outputs, latency, step time; then RCAN x2 as
    published (10 groups x 20 RCABs, batch 16, GT 96; ``-opt options/train/
    RCAN/train_RCAN_x2_synthetic.yml`` on ``datasets/CNN_x2_synthetic/``)
    trained 6 steps with K10 (one launch a forward, 64 -> 256), one batch
    forward and backward with K10 and without: the output and every
    gradient, and an EDSR-M x4 forward (64 -> 256 twice) with K10 and
    without;
35. trains MSRGAN x4 (``-opt options/train/SRResNet_SRGAN/
    train_MSRGAN_x4_synthetic.yml``: SRGANModel, MSRResNet 64 x 16,
    VGGStyleDiscriminator) for 6 steps, then the same with
    ``UNetDiscriminatorSN`` (64 features) at GT 256: the exact spectral norm
    on the card;
36. trains ECBSR x4 m4c16 PReLU on the Y channel (``-opt options/train/
    ECBSR/train_ECBSR_x4_m4c16_prelu_synthetic.yml``: batch 32, GT 256) for
    6 steps and validates it re-parameterised, holds that forward against
    the branched one, and runs SRVGGNetCompact and RIDNet at their default
    widths;
37 to 46. the recurrent video models at the published widths on synthetic
    data and seed-0 weights (phase 3h holds the sampler's kernels at their
    shapes first): BasicVSR and IconVSR served through
    ``basicsr4rs_torch.test`` on a 30-frame clip of 180x320 (37, 38),
    IconVSR and EDVR-L on Vimeo90K septuplets (39, 40), BasicVSR trained on
    REDS and IconVSR on Vimeo90K through ``basicsr4rs_torch.train`` across
    ``fix_flow`` (41, 42; 41c, 42c one batch's gradients against the plain
    sampler), the
    video GAN (43), TOFlow and DUF served (44, 45; DUF times one request),
    and
    ``inference_basicvsr`` and ``inference_basicvsrpp`` against
    ``test.py``'s images (46); each request's and step's sampler launches
    counted.
47 to 49. the Real-ESRGAN degradation engine against its CPU run, and
    RealESRNet and RealESRGAN x4plus trained 16 steps each (no kernel);
50 to 53. the face models at the published widths (no kernel): StyleGAN2
    256 Cmul2 trained 16 steps of batch 3 through ``basicsr4rs_torch.train``
    (``options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ_synthetic.yml``
    on ``datasets/FFHQ_256_synthetic/``; R1 and the path-length term
    non-zero on their steps only, step times by kind, one step with both
    terms traced, 50a), one regularised step at out_size 64 on the card
    and the CPU in float32, both against float64 (50b), ``inference_stylegan2`` at truncation 0.7 (50c),
    a forward of the bilinear generator at 256 (50d); HiFaceGAN (48
    features, crop 512) trained 4 steps (51, 51b by phase) and served
    through both test files (52a, 52b); DFDNet (64 features) on a 512x512
    face through ``inference_dfdnet``, the card against the CPU with the
    entries each part selected (53); 52a and 53b trace a request by kernel.
54 to 58. the FID / taming slice (no kernel): ``TamingModel`` built from
    ``options/test/taming/test_taming_vqgan8192_synthetic.yml`` (the
    published VQGAN: 4 bands, ch 128, 8192 codes; seed-0 weights it writes)
    validated on 4 items of the taco layout at GT 256 (PSNR, SSIM, the two
    RS NIQE scores, CSV, band PNGs), latency, device time and memory, one
    item against the CPU stage by stage with the share of codes that agree
    (54); the FID InceptionV3 (random weights in pytorch-fid's layout) on two
    sets of 32 images at 299 on the card and the CPU, images a second,
    ``calculate_fid`` from the card's features (55); ``calculate_psnr_pt`` and
    ``calculate_ssim_pt`` through SwinIR-M's validation route and item by
    item against the host metrics on the same images, seconds of each route
    (56); MSRResNet x4 trained 4 steps with Adafactor and with Lamb on the
    card and the CPU, and Adafactor's factored route on a 256 -> 256
    convolution (57); the EMA of a fine-tune start from a ``.pth`` whose
    ``params`` and ``params_ema`` differ, and of a resumed run (58).
63, 64. (after 7) data-parallel training through the launcher: 63 starts
    ``python -m torch.distributed.run --standalone --nproc_per_node 1`` on
    NCCL, whose rank runs ``basicsr4rs_torch.train``'s pipeline with
    ``--launcher pytorch`` on the SwinIR-M x4 config (DDP around ``net_g``):
    10 steps, a checkpoint, one validation, then ``--auto_resume`` to 12; K2 to
    K5 counted a step and K1 in each validation; the step beside phase 6's
    (DDP's cost at one rank). 64 starts two ranks on the one card over gloo
    for 2 SGD steps at 2 rows a rank (no DropPath, flips or crops), then one
    process at 4 rows from the same ``.pth`` on the same items: the
    parameters against each other (``F32_TOL`` elementwise, the steps taken
    within ``F32_SUM_TOL`` of the largest), the EMA within 4 ulps of the
    weights (an EMA that never moved, and the weights, must fail that), the
    loss, both step times. A rank that fails, a run past its time and DDP's
    stride warning fail the phase. One card cannot show NCCL between two
    cards.
65. (after 64) the two-network models on two ranks sharing the card over
    gloo, each rank's job ``chip_smoke.py rank`` with the model jobs of
    ``dist_model_specs``, then each in this process at the global batch,
    from one seed (the second rank from another, which rank 0's broadcast
    replaces), 2 steps on host-made batches: ESRGAN x4 (RRDBNet 64 x 23,
    VGG-style D 64; and once more with each rank's own statistics and
    means, a control the check must fail), StyleGAN2 256 Cmul2 (R1 and the
    path length on step 2, the path batch 3 split 2 + 1, replayed draws),
    the video GAN (BasicVSR 64 x 30 on a 15-frame clip a rank: K8, K9) and
    the joint align-diffusion model at GT 66 (K6, K7). Each network's step
    1 gradients and its moves within ``DIST_MODEL_TOL`` of their largest
    entry, the ranks' weights equal, the losses and ``mean_path_length``
    within 1e-3; the step times of both and the gradient exchange's.

66 to 70. (after 58) SwinIR's options and the unfused routes: 66a holds K2
    to K5 at SwinIR-L's shapes (C=240 in 8 heads of 30, hidden 480; the
    training batch of 8 x 64x64 with DropPath's scales and as the branch
    alone, a served 64x64 request) against their plain versions and times
    them; 66 serves SwinIR-L real-world x4 (``-opt options/test/SwinIR/
    test_SwinIR_L_x4_realworld_synthetic.yml``: 9 RSTBs of 6 blocks,
    nearest+conv, 3conv; 3 requests of LQ 64x64, seed-0 weights it writes)
    through ``basicsr4rs_torch.test``: 54 K2 and 54 K4 launches a request,
    none of K1, request time, a request's device time by kernel (66b), peak
    memory, one request against the plain forward; 67 trains it (``-opt
    options/train/SwinIR/train_SwinIR_L_x4_realworld_synthetic.yml``, batch
    8 at GT 256) for 6 steps: 54 launches of each of K2 to K5 a step, finite
    losses falling on the first batch, the checkpoint, step time, peak
    memory, one step by kernel (67c), and (67b) one batch's output and every
    gradient through the kernels against the plain versions; 68, at
    SwinIR-M's width: (a) in eval ``fused_attn: false`` against K1, (b) in
    training with every rate 0 the unfused route against K2 to K5, (c) with
    ``drop_rate: 0.1`` K2 and the unfused MLP against the unfused route from
    the same generator state (the same masks), outputs and gradients; 69
    samples ResShift x4 built with ``network_g:fused_attn=false`` and again
    with its blocks on K6, same weights and noise; 70 runs SR3UNet at the
    widths quoted for SR3 16 -> 128 (inner 64, multipliers 1, 2, 4, 8, 8,
    attention at 16, 2 residual blocks, dropout 0.2; not checked against
    the public config file), a training step of B=4 at 128x128
    (time, peak memory, by kernel in 70b), and its output and gradients in
    float32 against float64 on the card.

71. (after 70) the user's path from raw images and an official checkpoint,
    on the port's scripts alone, each started as ``python -m
    basicsr4rs_torch.scripts...`` in a process of its own: (a) a DIV2K-style
    HR folder from ``tests/data/baboon.png`` (the image, its flips, its
    transpose, its 2x MATLAB bicubic enlargement) through
    ``extract_subimages`` at the published crop 480, step 240, thresh 0,
    two sub-images held out as the validation pair, ``generate_bicubic_lr
    --scale 4`` and ``generate_meta_info``; (b) the sub-image count by the
    crop rule, every LR 120x120, one sorted meta-info line each; (c)
    ``basicsr4rs_torch.train`` on the published
    ``options/train/SwinIR/train_SwinIR_SRx4_scratch.yml`` (SwinIR-M x4,
    batch 4, GT 192, 6 loader workers, Adam 2e-4, EMA 0.999; only the data
    roots, the run's length and its logging given by ``--force_yml``) for 40
    steps and one validation: 36 launches of each of K2 to K5 a step and of
    K1 a validation image, by the wrappers' counts and by
    ``torch.profiler``, the mean L1 of the last 5 steps below the first 5's,
    a finite PSNR, median step time, busy share, peak memory; (d) without
    ``lmdb``, ``create_lmdb`` and a dataset's first item in LMDB mode raise
    its ``ImportError`` (with it, both folders go into LMDBs and the file
    trains 3 steps from them); (e) a seed-0 EDSR-L x4 under EDSR-PyTorch's
    key names through ``convert_models --model edsr --num_block 32``,
    served through ``basicsr4rs_torch.test`` with ``SWIN_FUSED_CONV=1`` (2
    K10 launches a request), bit for bit the network it was made from.

``python3 chip_smoke.py kernels`` stops after phase 3; ``python3 chip_smoke.py
serving`` runs phases 3a, 3e, 3g, 3f, 4, 4b, 17 to 22 and 59 to 62 alone; ``python3
chip_smoke.py cnn`` runs phases 3g and 32 to 36 alone; ``python3 chip_smoke.py
video`` runs phases 3h and 37 to 46 alone; ``python3 chip_smoke.py
realesrgan`` phases 47 to 49, ``python3 chip_smoke.py faces`` phases 50
to 53, ``python3 chip_smoke.py taming`` phases 54 to 58, ``python3
chip_smoke.py dist`` phases 6 and 63 to 65, ``python3 chip_smoke.py
options`` phases 66 to 70 and ``python3 chip_smoke.py data`` phase 71, each
ending with the same last
line (``python3 chip_smoke.py rank <job>`` is one rank of 63, 64 or 65, as
torchrun starts it). The line before the
last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
CONFIG = 'options/test/SwinIR/test_SwinIR_M_x4_synthetic.yml'
DATA_DIR = 'datasets/SwinIR_M_x4_synthetic'
WEIGHTS = 'experiments/SwinIR_M_x4_synthetic/net_g_seed0.pth'
LQ_SIZES = [(128, 128), (96, 160), (125, 94), (64, 64)]   # (H, W); 125x94 is padded
SCALE = 4
# kernel vs plain. float32: sums taken in another order, elementwise
# |err| <= atol + rtol |plain|. bfloat16: the plain version rounds every GEMM
# output and the residual stream y to bfloat16 where the kernel keeps
# float32, so errors are bf16 ulps of the largest magnitudes, not of each
# element: max|err| <= 1.6e-2 max|plain| (two ulps at the top of the range).
F32_TOL = (1e-4, 1e-4)   # (atol, rtol)
# float32 parameter gradients are sums over every token of the call (9216 at
# the training shape), added by atomicAdd in an order that changes from run
# to run; an entry's error follows the size of the sum's terms, not of the
# entry, so the bound is relative to the largest entry: max|err| <= 1e-4 max|plain|.
F32_SUM_TOL = 1e-4
BF16_TOL = 1.6e-2
MODEL_TOLERANCE = 1e-3   # on the [0, 1] output: a quarter of one uint8 level
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 on the CUDA
# cores, dense bfloat16 on the tensor cores, HBM3
PEAK_FLOPS_F32, PEAK_FLOPS_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_FLOPS_TF32 = 495e12   # dense TF32 on the tensor cores


def fail(msg):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def phase(title):
    print(f'\n== {title} [at {time.perf_counter() - T0:.1f} s]', flush=True)


def cuda_time_ms(fn, iters=10):
    """Mean milliseconds per call, CUDA events around ``iters`` calls after
    a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_info():
    phase('1. card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}')
    return card


def build_kernels():
    from basicsr4rs_torch.ops import _build
    phase('2. build')
    t0 = time.perf_counter()
    libs = _build.build_all()   # one nvcc per source, all at once
    print(f'built {len(libs)} kernels in {time.perf_counter() - t0:.2f} s with nvcc '
          f'{" ".join(_build.NVCC_FLAGS)}')
    for name, lib in libs.items():
        print(f'{os.path.relpath(_build.CSRC_DIR / (name + ".cu"), ROOT)} -> '
              f'{os.path.relpath(lib, ROOT)}')
        log = lib.with_name(lib.name + '.log').read_text()
        keep = ('registers', 'spill') + (('Compiling entry',) if name == 'conv3x3_fwd' else ())
        print('\n'.join('  ' + line.strip() for line in log.splitlines()
                        if any(k in line for k in keep)))
        if 'sm_90a' not in log:
            fail(f'{name} was not compiled for sm_90a')


C, HEADS, WS, HIDDEN = 180, 6, 8, 360   # a SwinIR-M block


def block_inputs(b, h, w, dtype, shift, gen, c=C, heads=HEADS, ws=WS, hidden=HIDDEN):
    """Block inputs on the card (SwinIR-M's widths unless given): x already
    rolled, weights with std 1/sqrt(fan_in) so that the attention is far
    from uniform."""
    from basicsr4rs_torch.archs.swinir_arch import _shift_attn_mask
    n = ws * ws

    def r(*shape, std=1.):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = r(b, h, w, c).to(dtype)
    args = [x, 1 + r(c, std=.1), r(c, std=.1), r(3 * c, c, std=c**-.5), r(3 * c, std=.02),
            r(c, c, std=c**-.5), r(c, std=.02), r(heads, n, n, std=.5),
            _shift_attn_mask(h, w, ws, shift, x.device) if shift else None,
            1 + r(c, std=.1), r(c, std=.1), r(hidden, c, std=c**-.5), r(hidden, std=.02),
            r(c, hidden, std=hidden**-.5), r(c, std=.02)]
    return args + [ws, heads, (c // heads)**-.5]


def bound_ms(flop, nbytes, dtype):
    """The least time the card could take: the larger of operations over the
    peak rate of the type (float32 on the CUDA cores, bfloat16 on the tensor
    cores) and bytes over the memory rate; and which of the two it is."""
    peak = PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS_BF16
    by_ops, by_bytes = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, 'operations') if by_ops >= by_bytes else (by_bytes, 'bytes')


M_WIDTHS = (C, HEADS, WS, HIDDEN)
LIGHT_WIDTHS = (60, 6, 8, 120)   # SwinIR-light: embed 60, 6 heads of 10, mlp 2
# past the joint kernel's widths: heads of 60, and SwinIR-L's 240 in 8 heads of 30; mlp 2
WIDE_WIDTHS = ((180, 3, 8, 360), (240, 8, 8, 480))
# SwinIR-L2S (train_SwinIR_L2S288_scratch.yml): 6 heads of 30, window 6 (36
# tokens, shifted by 3), mlp 2; its training batch is 8 LQ patches of 96x96
L2S_WIDTHS = (180, 6, 6, 360)
L2S_SHAPE = (8, 96, 96)


def padded_rows(ws):
    """The share of the window units' tile rows that are padding: K1 to K3
    hold a window of ws^2 tokens in a tile of the Swin kernels' largest
    window (K2's proj launch, K3's LayerNorm backward and the MLP kernels
    tile the tokens themselves, which the shapes here fill)."""
    from basicsr4rs_torch.ops.swin_block import MAX_TOKENS_PER_WINDOW
    return 1 - ws * ws / MAX_TOKENS_PER_WINDOW


ROUTE = {torch.float32: '3xTF32 at 495 TFLOP/s', torch.bfloat16: 'bfloat16 at 989 TFLOP/s'}


def tensor_core_bound_ms(flop, nbytes, dtype):
    """(bound ms, by what) of a kernel whose products all run on the tensor
    cores (all but K8, K9): float32 as three TF32 products (3xTF32) at the TF32
    peak, bfloat16 at the bfloat16 peak; and the float32 CUDA-core bound
    (their first route) beside it."""
    peak, products = (PEAK_FLOPS_TF32, 3) if dtype == torch.float32 else (PEAK_FLOPS_BF16, 1)
    by_ops, by_bytes = products * flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = (by_ops, 'operations') if by_ops >= by_bytes else (by_bytes, 'bytes')
    return bound, max(flop / PEAK_FLOPS_F32 * 1e3, by_bytes)


def kernel_work(kernel, b, h, w, dtype, shifted, widths=M_WIDTHS):
    """(FLOP, bytes) of one call on a Swin block (SwinIR-M's widths unless
    given): every product of the function, each input read once and each
    output written once."""
    c, heads, ws, hid = widths
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    attn_w, mlp_w = 4 * c * c, 2 * c * hid                      # weight elements
    small = 4 * (8 * c + hid) + 4 * heads * n * n               # LN, biases, rel_bias (f32)
    mask = 4 * (h // ws) * (w // ws) * n * n if shifted else 0
    attn_fwd = t * (8 * c * c + 4 * n * c)
    mlp_fwd = t * 4 * c * hid
    return {
        'swin_block_joint_fwd': (attn_fwd + mlp_fwd,
                                 2 * t * c * es + (attn_w + mlp_w) * es + small + mask),
        'swin_attn_block_fwd': (attn_fwd, 2 * t * c * es + attn_w * es + small + mask),
        # recomputes qkv, scores and P v; then dWproj, dO, dV, dP, dQ, dK, dWqkv, dLN
        'swin_attn_block_bwd': (t * (22 * c * c + 12 * n * c),
                                3 * t * c * es + attn_w * (es + 4) + 2 * small + mask),
        'mlp_block_fwd': (mlp_fwd, 2 * t * c * es + mlp_w * es + small),
        # recomputes fc1; then dW2, dh, dW1, dLN
        'mlp_block_bwd': (t * 10 * c * hid, 3 * t * c * es + mlp_w * (es + 4) + 2 * small),
    }[kernel]


def compare(got, want, dtype, rule):
    """(ok, max abs err, max abs err / max|plain|, the tolerance in words)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return False, float('nan'), float('nan'), 'finite'
    err = (got - want).abs()
    max_abs = err.max().item()
    max_rel = max_abs / max(want.abs().max().item(), 1e-30)
    if dtype != torch.float32:
        return max_rel <= BF16_TOL, max_abs, max_rel, f'max|err| <= {BF16_TOL} max|plain|'
    if rule == 'elementwise':
        ok = bool((err <= F32_TOL[0] + F32_TOL[1] * want.abs()).all())
        return ok, max_abs, max_rel, f'|err| <= {F32_TOL[0]} + {F32_TOL[1]} |plain|'
    return max_rel <= F32_SUM_TOL, max_abs, max_rel, f'max|err| <= {F32_SUM_TOL} max|plain|'


def time_pair(plain, kernel):
    """(kernel ms, plain ms), timed in the order plain, kernel, kernel, plain."""
    times = [cuda_time_ms(fn) for fn in (plain, kernel, kernel, plain)]
    return (times[1] + times[2]) / 2, (times[0] + times[3]) / 2


def check_joint_kernel():
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full, reference_swin_block_full
    phase('3a. joint forward kernel vs plain version (SwinIR-M block: C=180, 6 heads, '
          'window 8, hidden 360; and SwinIR-L2S\'s, window 6)')
    gen = torch.Generator().manual_seed(0)
    both = (torch.float32, torch.bfloat16)
    cases = [(2, 64, 64, dt, shift, False) for dt in both for shift in (0, 4)]
    # the padded shapes of the served requests, one image each
    cases += [(1, h + (-h) % 8, w + (-w) % 8, torch.float32, 4, False) for h, w in LQ_SIZES]
    # the joint training route's call: a batch of patches under DropPath's scales
    cases += [(*TRAIN_SHAPE, dt, shift, True) for dt in both for shift in (0, 4)]
    cases = [case + (M_WIDTHS,) for case in cases]
    # SwinIR-light's widths (head dim 10), and a window of 16 tokens
    cases += [(2, 64, 64, dt, shift, False, LIGHT_WIDTHS) for dt in both for shift in (0, 4)]
    cases += [(2, 32, 32, dt, shift, False, (C, HEADS, 4, HIDDEN))
              for dt in both for shift in (0, 2)]
    # SwinIR-L2S's block: its request (B=1 96x96) and its training batch under
    # DropPath's scales (the joint training route), mask of 256 x 36 x 36
    l2s = [(1, 96, 96, dt, shift, False, L2S_WIDTHS) for dt in both for shift in (0, 3)]
    l2s += [(*L2S_SHAPE, dt, shift, True, L2S_WIDTHS) for dt in both for shift in (0, 3)]
    cases += l2s
    # timed: all but the L2S cases that only check (the request both ways and
    # the float32 batch, shifted)
    untimed = {case for case in l2s if case[4] == 0 or (case[0] == 8 and case[3] != torch.float32)}
    summary = {'max_abs_err': 0.}
    for case in cases:
        b, h, w, dt, shift, scaled, (c, heads, ws, hidden) = case
        args = block_inputs(b, h, w, dt, shift, gen, c, heads, ws, hidden)
        scales = None
        if scaled:   # mask / keep per sample and branch: sample 1 loses both, sample 2 one
            s1 = torch.full((b,), 1 / 0.9, device='cuda')
            s2 = torch.full((b,), 1 / 0.8, device='cuda')
            s1[1] = s2[1] = s2[2] = 0.
            scales = (s1, s2)
        with torch.no_grad():
            got = fused_swin_block_full(*args, residual_scales=scales)
            want = reference_swin_block_full(*args, residual_scales=scales)
        torch.cuda.synchronize()
        ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
        if scaled and not torch.equal(got[1], args[0][1]):
            fail(f'joint kernel: a dropped sample is not passed through at {(b, h, w, dt, shift)}')
        widths = '' if (c, heads, ws, hidden) == M_WIDTHS else f' C={c} heads={heads} ws={ws}'
        line = (f'B={b} {h}x{w}{widths} {str(dt)[6:]:8s} shift={shift}{" scaled" if scaled else ""}: '
                f'max_abs_err={max_abs:.3e} '
                f'max_rel_err={max_rel:.3e} (max|err| / max|plain|), tolerance {tolerance}')
        if not ok:
            print(line, flush=True)
            fail(f'joint kernel and plain version disagree at {(b, h, w, dt, shift, scaled)}')
        if dt == torch.float32:
            summary['max_abs_err'] = max(summary['max_abs_err'], max_abs)
        if case in untimed:
            print(line, flush=True)
            continue
        with torch.no_grad():
            kernel_ms, plain_ms = time_pair(
                lambda: reference_swin_block_full(*args, residual_scales=scales),
                lambda: fused_swin_block_full(*args, residual_scales=scales))
        line += f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms'
        if (c, heads, ws, hidden) == L2S_WIDTHS:
            flop, nbytes = kernel_work('swin_block_joint_fwd', b, h, w, dt, shift, L2S_WIDTHS)
            (bound, by), _ = tensor_core_bound_ms(flop, nbytes, dt)
            line += (f', bound {bound:.4f} ms by {by} on its route ({ROUTE[dt]}); '
                     f'{100 * padded_rows(ws):.2f}% of its tile rows padding')
            key = f'ws6_{"bf16_" if dt != torch.float32 else ""}{"b8_" if b == 8 else ""}'
            summary.update({key + 'ms': kernel_ms, key + 'bound_ms': bound})
            if key == 'ws6_':
                summary['ws6_plain_ms'] = plain_ms
        if (c, heads, ws, hidden) == M_WIDTHS and (
                (b, h, w) == (1, 128, 128) or (b, h, w, dt) == (2, 64, 64, torch.bfloat16)):
            flop, nbytes = kernel_work('swin_block_joint_fwd', b, h, w, dt, shift)
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            line += (f', bound {bound:.4f} ms by {by} on its route ({ROUTE[dt]}; on the CUDA '
                     f'cores {cuda_cores:.4f} ms)')
            if (b, h, w, dt) == (1, 128, 128, torch.float32):   # the largest served request
                summary.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                               cuda_core_bound_ms=cuda_cores)
        print(line, flush=True)
    return summary


ATTN_GRADS = ('dx', 'd_ln_weight', 'd_ln_bias', 'd_qkv_weight', 'd_qkv_bias', 'd_proj_weight',
              'd_proj_bias', 'd_rel_bias')
MLP_GRADS = ('dx', 'd_ln_weight', 'd_ln_bias', 'd_fc1_weight', 'd_fc1_bias', 'd_fc2_weight',
             'd_fc2_bias')
TRAIN_SHAPE = (4, 48, 48)   # batch 4 of 48x48 LQ patches: the training step's block input


def check_branch_kernels():
    """The four kernels of the training path against their plain versions."""
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    phase('3b. attention and MLP branch kernels, forward and backward, vs plain versions')
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    cases = [(shape, torch.float32, shift, mode, M_WIDTHS) for shape in (TRAIN_SHAPE, (2, 64, 64))
             for shift in (0, 4) for mode in ('branch', 'residual', 'scaled')]
    cases += [(TRAIN_SHAPE, torch.bfloat16, 4, mode, M_WIDTHS)
              for mode in ('branch', 'residual', 'scaled')]
    # the attention kernels where their tiles are padded: SwinIR-light's
    # heads of 10 features, windows of 16 tokens, and heads of 48 features
    # (two 32-feature chunks of a head, wider than the joint kernel takes)
    both = (torch.float32, torch.bfloat16)
    cases += [((2, 64, 64), dt, 4, 'scaled', LIGHT_WIDTHS) for dt in both]
    cases += [((2, 32, 32), dt, 2, mode, (C, HEADS, 4, HIDDEN))
              for dt in both for mode in ('branch', 'scaled')]
    cases += [((2, 64, 64), torch.float32, 4, 'residual', (96, 2, WS, 192))]
    # a token count that is not a multiple of the MLP kernels' 64-token tile
    # (480, the last tile half full and across two samples): not whole
    # windows, so the MLP kernels alone
    cases += [((2, 20, 12), dt, 0, 'scaled', M_WIDTHS) for dt in both]
    # SwinIR's eval blocks past the joint kernel's widths (phase 22): the
    # forward kernels alone
    cases += [((2, 64, 64), dt, 4, 'scaled', widths) for widths in WIDE_WIDTHS for dt in both]
    # SwinIR-L2S's training batch: window 6 (36 tokens in each 64-row tile of
    # K2's and K3's units), shifted by 3 with the 256 x 36 x 36 mask and not,
    # with DropPath's scales and without; timed where shifted and scaled
    l2s = [(L2S_SHAPE, dt, shift, mode, L2S_WIDTHS) for dt in both for shift in (0, 3)
           for mode in ('residual', 'scaled')]
    cases += l2s
    padded_s = l2s_s = 0.
    summary = {name: {'max_abs_err': 0.} for name in
               ('swin_attn_block_fwd', 'swin_attn_block_bwd', 'mlp_block_fwd', 'mlp_block_bwd')}
    for (b, h, w), dt, shift, mode, widths in cases:
        t_case = time.perf_counter()
        c, heads, ws, hidden = widths
        (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ln2w, ln2b, w1, b1, w2, b2,
         ws, heads, scale) = block_inputs(b, h, w, dt, shift, gen, c, heads, ws, hidden)
        dz = torch.randn(x.shape, generator=gen).cuda().to(dt)
        add = mode == 'residual'
        s = None
        if mode == 'scaled':   # DropPath's mask / keep: one sample dropped
            s = torch.full((b,), 1 / 0.9, device='cuda')
            s[1] = 0.
        tail = (add, s)
        attn = (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ws, heads, scale) + tail
        attn_b = (x, dz, ln1w, ln1b, wqkv, bqkv, wproj, rel, mask, ws, heads, scale) + tail
        mlp = (x, ln2w, ln2b, w1, b1, w2, b2) + tail
        mlp_b = (x, dz, ln2w, ln2b, w1, b1, w2) + tail
        runs = [
            ('swin_attn_block_fwd', S.swin_attn_block_forward, S.reference_swin_attn_block,
             attn, ('out',)),
            ('swin_attn_block_bwd', S.swin_attn_block_backward,
             S.reference_swin_attn_block_backward, attn_b, ATTN_GRADS),
            ('mlp_block_fwd', M.mlp_block_forward, M.reference_mlp_block, mlp, ('out',)),
            ('mlp_block_bwd', M.mlp_block_backward, M.reference_mlp_block_backward, mlp_b,
             MLP_GRADS),
        ]
        padded = widths not in (M_WIDTHS, L2S_WIDTHS) or h % ws or w % ws
        if h % ws or w % ws:
            runs = runs[2:]
        elif widths in WIDE_WIDTHS:   # the eval route: the forward kernels
            runs = runs[0:1] + runs[2:3]
        elif widths not in (M_WIDTHS, LIGHT_WIDTHS, L2S_WIDTHS):   # MLP tiles not padded
            runs = runs[:2]
        is_l2s = widths == L2S_WIDTHS
        tag = (f'B={b} {h}x{w} {str(dt)[6:]:8s} shift={shift} {mode:8s}'
               + ('' if widths == M_WIDTHS else f' C={c} heads={heads} ws={ws}'))
        for name, kernel, plain, args, outputs in runs:
            with torch.no_grad():
                got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g, wnt in zip(outputs, got, want):
                # activations elementwise; parameter gradients, sums over all
                # tokens, relative to the largest entry
                rule = 'elementwise' if out_name in ('out', 'dx') else 'sum'
                ok, max_abs, max_rel, tolerance = compare(g, wnt, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    print(f'{name} {tag}: ' + ', '.join(worst))
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == torch.float32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            if mode == 'scaled':   # a dropped sample passes x and dz through untouched
                through = dz if name.endswith('bwd') else x
                if not torch.equal(got[0][1], through[1]):
                    fail(f'{name}: the dropped sample is not passed through at {tag}')
            if is_l2s and not (shift and mode == 'scaled'):
                print(f'{name:20s} {tag}: max abs err (of max|plain|): ' + ', '.join(worst),
                      flush=True)
                continue
            kernel_ms, plain_ms = time_pair(lambda: plain(*args), lambda: kernel(*args))
            flop, nbytes = kernel_work(name, b, h, w, dt, shift, widths)
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            route = (f'bound {bound:.4f} ms by {by} on its route ({ROUTE[dt]}; on the CUDA '
                     f'cores {cuda_cores:.4f} ms)')
            if is_l2s:
                if name.startswith('swin_attn'):
                    route += (f'; {100 * padded_rows(ws):.2f}% of its (window, head) units\' '
                              'tile rows padding')
                key = 'ws6_' if dt == torch.float32 else 'ws6_bf16_'
                summary[name].update({key + 'ms': kernel_ms, key + 'bound_ms': bound})
                if dt == torch.float32:
                    summary[name]['ws6_plain_ms'] = plain_ms
                if name == 'mlp_block_fwd':   # the plan it picks at 73,728 tokens
                    units, parts, per_sm, sms, _ = M.forward_plan(x, hidden)
                    route += (f'; grid {units} units ({parts} parts a tile), {per_sm} block(s) '
                              f'an SM on {sms} SMs')
            print(f'{name:20s} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                  f'{route} | max abs err (of max|plain|): ' + ', '.join(worst), flush=True)
            main_case = ((b, h, w), shift, mode, widths) == (TRAIN_SHAPE, 4, 'scaled', M_WIDTHS)
            if main_case and dt == torch.bfloat16:
                summary[name].update(bf16_ms=kernel_ms, bf16_bound_ms=bound)
            if main_case and dt == torch.float32:
                summary[name].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, cuda_core_bound_ms=cuda_cores)
                if name == 'mlp_block_fwd':   # its grid: units, parts, blocks an SM, SMs
                    units, parts, per_sm, sms, _ = M.forward_plan(x, hidden)
                    fill = units / (-(-units // (per_sm * sms)) * per_sm * sms)
                    print(f'{name:20s} {tag}: grid {units} units (64-token tiles x {parts} '
                          f'parts of the hidden chunks), {per_sm} block(s) an SM on {sms} SMs, '
                          f'{100 * fill:.1f}% of the waves\' slots filled', flush=True)
                    summary[name].update(units=units, parts=parts, fill=fill)
                if name == 'swin_attn_block_fwd':   # device time of its two launches
                    with torch.no_grad():
                        split = {part: kernel_device_ms(lambda: kernel(*args),
                                                        only=f'swin_attn_fwd_{part}_kernel')
                                 for part in ('head', 'proj')}
                    print(f'{name:20s} {tag}: device time of the (window, head) units '
                          f'{show_ms(split["head"])}, of proj {show_ms(split["proj"])}', flush=True)
                    summary[name].update({f'{part}_device_ms': ms for part, ms in split.items()})
                if name.endswith('bwd'):   # atomicAdd sums: reported, not required
                    with torch.no_grad():
                        again = kernel(*args)
                    print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit '
                          'for bit: ' + ', '.join(
                              f'{o} {"yes" if torch.equal(g, a) else "no"}'
                              for o, g, a in zip(outputs, got, again)), flush=True)
            if name.endswith('fwd') and mode == 'scaled':   # K2, K4: no atomics, required
                with torch.no_grad():
                    again = kernel(*args)
                if not torch.equal(got[0], again):
                    fail(f'{name}: a second launch on the same inputs differs at {tag}')
                print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit for bit',
                      flush=True)
        if padded:
            padded_s += time.perf_counter() - t_case
        if is_l2s:
            l2s_s += time.perf_counter() - t_case
    print(f'phase 3b: {time.perf_counter() - t0:.1f} s, of which {padded_s:.1f} s for the '
          f'padded shapes (C=60, window 4, C=96, 20x12) and {l2s_s:.1f} s for SwinIR-L2S\'s '
          'window 6')
    return summary


RS_C, RS_HEADS = 192, 6   # the Swin layers of the ResShift UNets: 6 heads of 32
# the RS fork's own diffusion config: UNetModelSwin with window 9 (81 tokens)
# on 72x72 latents (GT 288 through the VQ-f4 first stage), attention at 72,
# 36, 18 and 9, batch 32 under use_amp
L2S_CONFIG = 'options/train/ResShift/train_ResShift_L2S288.yml'
ATTENTION_KERNELS = ('window_attention_fwd', 'window_attention_bwd')


def attention_work(kernel, b, h, w, c, heads, nwb, dtype, ws):
    """(FLOP, bytes) of one window-attention call: the two products of the
    forward (4 n C a token) or the five of the backward (10 n C, the scores
    recomputed), qkv (and dout) read once, out (or dqkv) written once, the
    float32 bias read and, in the backward, dbias written."""
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    bias = 4 * nwb * heads * n * n
    return {'window_attention_fwd': (t * 4 * n * c, t * 4 * c * es + bias),
            'window_attention_bwd': (t * 10 * n * c, t * 7 * c * es + 2 * bias)}[kernel]


def sdpa_window_attention(qkv, mask, ws, heads, scale):
    """The one library call that computes the forward kernel's function,
    ``F.scaled_dot_product_attention`` with the float bias as ``attn_mask``,
    between the window partition and reverse copies it needs. Timed here as a
    yardstick; the port never calls it."""
    import torch.nn.functional as F
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    x = qkv.reshape(b, h // ws, ws, w // ws, ws, 3, heads, c // heads)
    q, k, v = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, ws * ws, c // heads)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    o = o.reshape(b, h // ws, w // ws, heads, ws, ws, c // heads)
    return o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)


def sdpa_window_attention_backward(qkv, bias, dout, ws, heads, scale):
    """The library's counterpart of the backward kernel: (dqkv, dbias) by
    ``torch.autograd.grad`` through ``sdpa_window_attention``, the float
    bias (nWb, heads, n, n) a leaf repeated over the samples, so that its
    gradient is summed back over them; and a function that reruns that
    backward alone on the same forward's graph. Timed here as a yardstick;
    the port never calls it."""
    qkv_leaf = qkv.detach().requires_grad_()
    bias_leaf = bias.detach().to(qkv.dtype).requires_grad_()
    with torch.enable_grad():
        out = sdpa_window_attention(qkv_leaf, bias_leaf.repeat(qkv.shape[0], 1, 1, 1), ws,
                                    heads, scale)

    def backward():
        return torch.autograd.grad(out, (qkv_leaf, bias_leaf), dout, retain_graph=True)

    return backward(), backward


def check_attention_kernels(train_batch, l2s_batch, align_batch):
    """The window-attention kernels, forward and backward, against their
    plain versions at the shapes the ResShift UNets give them: window 8
    (the published RGB config) and window 9 (``L2S_CONFIG``, whose batch under
    use_amp is ``l2s_batch``; float32 at half of it); and the joint
    align-diffusion model's middle block (``ALIGN_JOINT_TRAIN``: its batch of
    ``align_batch`` 8x8 maps, one window of 64 tokens, no shift)."""
    from basicsr4rs_torch.archs.unet_arch import shift_attn_mask_resshift
    from basicsr4rs_torch.ops import window_attention as A
    phase('3c. window attention kernels, forward and backward, vs plain versions '
          f'(C={RS_C}, {RS_HEADS} heads; window {WS}, and window 9 on the 72x72 latents of '
          f'{os.path.basename(L2S_CONFIG)}; B={align_batch} 8x8 of the joint align-diffusion '
          f'model; and C={C}, head_dim {C // HEADS})')
    gen = torch.Generator().manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    # (B, H = W, C, dtype, shifted, window)
    serve_case, train_case = (1, 64, RS_C, f32, True, WS), (train_batch, 64, RS_C, f32, True, WS)
    bf16_case = (train_batch, 64, RS_C, bf16, True, WS)
    l2s_case, l2s_bf16_case = (l2s_batch // 2, 72, RS_C, f32, True, 9), (l2s_batch, 72, RS_C,
                                                                         bf16, True, 9)
    cases = [serve_case, (1, 64, RS_C, f32, False, WS), (1, 8, RS_C, f32, False, WS), train_case,
             (train_batch, 64, RS_C, f32, False, WS), (train_batch, 32, RS_C, f32, True, WS),
             (train_batch, 16, RS_C, f32, True, WS), (train_batch, 8, RS_C, f32, False, WS),
             bf16_case, (train_batch, 64, RS_C, bf16, False, WS), (1, 64, RS_C, bf16, True, WS),
             (2, 64, C, f32, True, WS), (2, 64, C, bf16, False, WS)]
    for b, dt in ((l2s_batch // 2, f32), (l2s_batch, bf16)):   # 72, 36, 18 shifted by 4; 9 alone
        cases += [(b, size, RS_C, dt, size > 9, 9) for size in (72, 36, 18, 9)]
    align_case, align_bf16_case = ((align_batch, 8, RS_C, dt, False, WS) for dt in (f32, bf16))
    cases += [align_case, align_bf16_case]
    library_backward = {train_case: '', bf16_case: 'bf16_', l2s_case: 'window9_',
                        l2s_bf16_case: 'window9_bf16_', align_case: 'align_',
                        align_bf16_case: 'align_bf16_'}
    summary = {name: {'max_abs_err': 0., 'library_ms': None} for name in ATTENTION_KERNELS}
    t0 = time.perf_counter()
    for case in cases:
        b, size, c, dt, shifted, ws = case
        heads, n = HEADS, ws * ws
        scale = (c // heads)**-.5
        qkv = torch.randn(b, size, size, 3 * c, generator=gen).cuda().to(dt)
        dout = torch.randn(b, size, size, c, generator=gen).cuda().to(dt)
        bias = (torch.randn(1, heads, n, n, generator=gen) * .5).cuda()
        if shifted:
            mask = torch.from_numpy(shift_attn_mask_resshift(size, size, ws, ws // 2)).cuda()
            bias = bias + mask[:, None]
        nwb = bias.shape[0]
        args = (qkv, bias, ws, heads, scale)
        args_b = (qkv, bias, dout, ws, heads, scale)
        tag = f'B={b} {size}x{size} C={c} ws={ws} {str(dt)[6:]:8s} nWb={nwb}'
        runs = [('window_attention_fwd', A.window_attention_forward,
                 A.reference_window_attention, args, ('out',)),
                ('window_attention_bwd', A.window_attention_backward,
                 A.reference_window_attention_backward, args_b, ('dqkv', 'dbias'))]
        for name, kernel, plain, call, outputs in runs:
            with torch.no_grad():
                got = kernel(*call)
            want = plain(*call)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g_, w_ in zip(outputs, got, want):
                # dbias is a sum over samples (and windows); activations elementwise
                rule = 'sum' if out_name == 'dbias' else 'elementwise'
                ok, max_abs, max_rel, tolerance = compare(g_, w_, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == f32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            with torch.no_grad():
                kernel_ms, plain_ms = time_pair(lambda: plain(*call), lambda: kernel(*call))
            flop, nbytes = attention_work(name, b, size, size, c, heads, nwb, dt, ws)
            # every product on the tensor cores; the unit plan the kernel launched
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, dt)
            plan = A.forward_plan if name == 'window_attention_fwd' else A.backward_plan
            units, group, per_sm, sms, stages = plan(qkv, ws, heads)
            waves = -(-units // (per_sm * sms))
            line = (f'{name:20s} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                    f'bound {bound:.4f} ms by {by} ({ROUTE[dt]}; CUDA-core {cuda_cores:.4f}); '
                    f'{units} units of {group} samples, {per_sm} an SM ({stages} stages): '
                    f'{waves} waves, {100 * units / (waves * per_sm * sms):.1f}% filled')
            library_ms = None
            if name == 'window_attention_fwd':
                windows = (size // ws)**2
                mask = bias.to(dt) if nwb == 1 else bias.to(dt).repeat(b, 1, 1, 1)
                with torch.no_grad():
                    lib_out = sdpa_window_attention(qkv, mask, ws, heads, scale)
                    ok, max_abs, _, _ = compare(lib_out, want[0], dt, 'elementwise')
                    if not ok:
                        fail(f'the library call disagrees with the plain version at {tag}: '
                             f'{max_abs:.3e}')
                    library_ms = cuda_time_ms(
                        lambda: sdpa_window_attention(qkv, mask, ws, heads, scale))
                line += (f', library (SDPA + partition/reverse copies, {b * windows} windows) '
                         f'{library_ms:.4f} ms')
                key = {l2s_case: 'window9_', l2s_bf16_case: 'window9_bf16_', train_case: 'train_',
                       bf16_case: 'bf16_', align_case: 'align_',
                       align_bf16_case: 'align_bf16_'}.get(case)
                if key:
                    summary[name].update({f'{key}ms': kernel_ms, f'{key}bound_ms': bound,
                                          f'{key}library_ms': library_ms})
            elif case in library_backward:   # the backward of that call, the forward untimed
                lib_grads, backward = sdpa_window_attention_backward(*args_b)
                for out_name, g_, w_ in zip(outputs, lib_grads, want):
                    ok, max_abs, _, _ = compare(g_, w_, dt,
                                                'sum' if out_name == 'dbias' else 'elementwise')
                    if not ok:
                        fail(f'the library backward disagrees with the plain version at {tag}: '
                             f'{out_name} {max_abs:.3e}')
                library_ms = cuda_time_ms(backward)
                del lib_grads, backward
                line += (f', library (autograd.grad through SDPA + partition/reverse copies, '
                         f'dqkv and dbias) {library_ms:.4f} ms')
                key = library_backward[case]
                if key:
                    summary[name].update({f'{key}ms': kernel_ms, f'{key}bound_ms': bound,
                                          f'{key}library_ms': library_ms})
            if case == serve_case and name == 'window_attention_fwd':   # a call of a request
                with torch.no_grad():
                    device_ms = kernel_device_ms(lambda: kernel(*call),
                                                 only='window_attention_fwd_kernel')
                    call_us = host_us(lambda: kernel(*call))
                line += f'; device {show_ms(device_ms)}, host {call_us:.1f} us a call'
                summary[name].update(device_ms=device_ms, host_us=call_us)
            print(line + ' | max abs err (of max|plain|): ' + ', '.join(worst), flush=True)
            main_case = serve_case if name == 'window_attention_fwd' else train_case
            if case == main_case:
                summary[name].update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by, library_ms=library_ms)
            if name == 'window_attention_bwd' and case in (train_case, train_case[:4] + (False, WS)):
                with torch.no_grad():   # atomicAdd sums: reported, not required
                    again = kernel(*call)
                print(f'{name:20s} {tag}: a second launch on the same inputs repeats bit for '
                      'bit: ' + ', '.join(f'{o} {"yes" if torch.equal(g_, a) else "no"}'
                                          for o, g_, a in zip(outputs, got, again)), flush=True)
    print(f'phase 3c: {time.perf_counter() - t0:.1f} s')
    return summary


# ------------------------------------------------- the deformable sampler
DEFORM_KERNELS = ('deform_sample_fwd', 'deform_sample_bwd')
EDVR_FEAT, EDVR_GROUPS, EDVR_FRAMES = 64, 8, 5          # EDVR-M: num_feat, deformable_groups
EDVR_TRAIN_BATCH, EDVR_TRAIN_LQ = 4, 64                 # GT 256 at x4
VIDEO_LQ = (180, 320)                                   # the REDS4 frame at x4
PP_FEAT, PP_GROUPS = 64, 16                             # BasicVSR++: mid_channels, deform groups
EDVR_L_FEAT, ICON_TRAIN_BATCH = 128, 4                  # EDVR-L's num_feat; BasicVSR's batch
VIMEO_LQ, TOF_SIZE = (64, 112), (256, 448)              # Vimeo90K's 448x256 at x4 and at x1


def deform_work(kernel, n, c, h, w, taps, groups, with_mask, dtype):
    """(FLOP, bytes) of one sampler call with stride 1 and 'same' padding:
    the map, offsets and mask read once, the column tensor written once (or
    read once, with the three gradients written); 8 operations a sample for
    the blend and the mask, 30 in the backward, 20 a tap for its position."""
    es, p = torch.finfo(dtype).bits // 8, h * w
    maps, col = n * c * p * es, n * c * taps * p * es
    offsets = n * groups * taps * p * 4 * (3 if with_mask else 2)
    position = 20 * n * groups * taps * p
    return {'deform_sample_fwd': (8 * n * c * taps * p + position, maps + offsets + col),
            'deform_sample_bwd': (30 * n * c * taps * p + 2 * position,
                                  2 * maps + 2 * offsets + col)}[kernel]


def deform_inputs(n, c, h, w, taps, groups, with_mask, dtype, spread, gen):
    """A map, offsets and a mask on the card. ``spread`` is the offsets'
    standard deviation in pixels, and the first sample's offsets are whole
    numbers, a tenth of them zero; or ``('scatter', d)``: +-d pixels, the
    sign alternating by column for dy and by row for dx, plus a random
    tenth of a pixel, so that most corners fall outside K9's window; or
    ``('edge', halo)``: a whole-number shift of 3 plus deviations of 0,
    +-halo, +-(halo + 1) and +-1 pixels by column (dx's three columns on),
    balanced over every 8 columns, so that a tile's mean offset is the shift
    and whole-number corners land on both sides of each edge of K9's
    window."""
    from basicsr4rs_torch.ops.dcn import SampleGeometry
    k = 3 if taps == 9 else 1
    geo = SampleGeometry(k, k, 1, k // 2, 1, groups)
    x = torch.randn(n, c, h, w, generator=gen).cuda().to(dtype)
    shape = (n, groups * taps, h, w)
    if isinstance(spread, tuple) and spread[0] == 'scatter':
        d = spread[1]
        sign_y = 1 - 2 * (torch.arange(w) % 2).view(1, 1, 1, w).float()
        sign_x = 1 - 2 * (torch.arange(h) % 2).view(1, 1, h, 1).float()
        pairs = [d * sign_y + .1 * torch.randn(shape, generator=gen),
                 d * sign_x + .1 * torch.randn(shape, generator=gen)]
    elif isinstance(spread, tuple) and spread[0] == 'edge':
        halo = spread[1]
        steps = torch.tensor([0, halo, -halo, halo + 1, -halo - 1, 1, -1, 0]).float()
        cols = torch.arange(w)
        pairs = [3 + steps[cols % 8].view(1, 1, 1, w).expand(shape),
                 3 + steps[(cols + 3) % 8].view(1, 1, 1, w).expand(shape)]
    else:
        pairs = None
    if pairs is None:
        offset = torch.randn(n, groups * 2 * taps, h, w, generator=gen) * spread
        offset[0] = offset[0].round() * (torch.rand(offset[0].shape, generator=gen) > .1)
    else:
        offset = torch.stack(pairs, dim=2).reshape(n, groups * 2 * taps, h, w).contiguous()
    mask = torch.rand(n, groups * taps, h, w, generator=gen).cuda() if with_mask else None
    dcol = torch.randn(n, c, taps, h, w, generator=gen).cuda().to(dtype)
    return x, offset.cuda(), mask, dcol, geo


def grid_of(offset):
    """``F.grid_sample``'s normalised grid for a one-tap offset (dy, dx)."""
    n, _, h, w = offset.shape
    ys = torch.arange(h, device=offset.device).view(1, h, 1) + offset[:, 0]
    xs = torch.arange(w, device=offset.device).view(1, 1, w) + offset[:, 1]
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)


def recurrent_deform_cases():
    """Phase 3h's cases (as 3d's): the shapes BasicVSR, IconVSR, EDVR-L on
    Vimeo90K and TOFlow give the sampler that 3d does not hold. IconVSR's
    REDS request runs PCD on one keyframe window of 5 frames at 180x320,
    90x160 and 45x80: 3d's 'EDVR serve' cases, and BasicVSR's served warp is
    3d's 'warp 64ch serve'."""
    from basicsr4rs_torch.archs.basicvsr_arch import keyframes
    f32 = torch.float32
    pcd, pcd_l = (EDVR_FEAT, 9, EDVR_GROUPS, True), (EDVR_L_FEAT, 9, EDVR_GROUPS, True)
    (vh, vw), (th, tw) = VIMEO_LQ, TOF_SIZE
    icon_train = ICON_TRAIN_BATCH * len(keyframes(14, 5)) * 7   # 4 keyframes x 4 x 7 frames
    return [('BasicVSR train warp', ICON_TRAIN_BATCH, 64, 64, (EDVR_FEAT, 1, 1, False), f32, 3.,
             True),
            ('IconVSR train PCD L1', icon_train, 64, 64, pcd, f32, 2., True),
            ('IconVSR train PCD L3', icon_train, 16, 16, pcd, f32, 12., False),
            ('IconVSR Vimeo PCD L1', 4 * 7, vh, vw, pcd, f32, 2., False),
            ('EDVR-L Vimeo PCD L1', 7, vh, vw, pcd_l, f32, 2., True),
            ('EDVR-L Vimeo PCD L2', 7, vh // 2, vw // 2, pcd_l, f32, 6., False),
            ('EDVR-L Vimeo PCD L3', 7, vh // 4, vw // 4, pcd_l, f32, 2., False),
            ('TOFlow warp 3ch folded', 6, th, tw, (3, 1, 1, False), f32, 3., True)]


def check_deform_kernels(number='3d', cases=None):
    """The deformable sampler's kernels against their plain versions at the
    shapes EDVR-M and BasicVSR++ give them, nine taps and one (3d; with the
    flow warps as ``flow_warp`` runs them), or at ``cases``."""
    import torch.nn.functional as F

    from basicsr4rs_torch.ops import dcn as D
    phase(f'{number}. deformable sampler kernels, forward and backward, vs plain versions'
          + (' at the recurrent video models\' shapes' if cases else ''))
    gen = torch.Generator().manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    tb, tl, (sh, sw) = EDVR_TRAIN_BATCH * EDVR_FRAMES, EDVR_TRAIN_LQ, VIDEO_LQ
    edvr = (EDVR_FEAT, 9, EDVR_GROUPS, True)
    pp = (2 * PP_FEAT, 9, PP_GROUPS, True)
    # (tag, N, H, W, (C, taps, deform groups, mask), dtype, offsets (deform_inputs), timed)
    train_case = ('EDVR train L1', tb, tl, tl, edvr, f32, 2., True)
    warp_case = ('warp 64ch zeros', 1, 64, 64, (PP_FEAT, 1, 1, False), f32, 3., True)
    cases = [train_case,
             ('EDVR train L2', tb, tl // 2, tl // 2, edvr, f32, 2., False),
             ('EDVR train L3', tb, tl // 4, tl // 4, edvr, f32, 12., False),
             ('EDVR train L1 bf16', tb, tl, tl, edvr, bf16, 2., True),
             # K9: most corners outside its window (device-memory atomics), and
             # whole-number offsets on the window's edges (the halo is the plan's)
             ('EDVR train scattered', 4, tl, tl, edvr, f32, ('scatter', 24.), False),
             ('EDVR train edge', 4, tl, tl, edvr, f32, ('edge', None), False),
             ('warp 64ch edge', 1, 64, 64, (PP_FEAT, 1, 1, False), f32, ('edge', None), False),
             ('EDVR serve L1', EDVR_FRAMES, sh, sw, edvr, f32, 2., True),
             ('EDVR serve L2', EDVR_FRAMES, sh // 2, sw // 2, edvr, f32, 40., False),
             ('EDVR serve L3', EDVR_FRAMES, sh // 4, sw // 4, edvr, f32, 2., False),
             ('EDVR serve L1 bf16', EDVR_FRAMES, sh, sw, edvr, bf16, 2., False),
             ('BasicVSR++ train', 1, 64, 64, pp, f32, 4., True),
             ('BasicVSR++ train far', 1, 64, 64, pp, f32, 40., False),
             ('BasicVSR++ serve', 1, sh, sw, pp, f32, 4., True),
             ('BasicVSR++ train bf16', 1, 64, 64, pp, bf16, 4., False),
             warp_case,
             ('warp 64ch serve', 1, sh, sw, (PP_FEAT, 1, 1, False), f32, 3., True),
             ('warp 2ch flow', 1, 64, 64, (2, 1, 1, False), f32, 30., False),
             ('warp 3ch SpyNet', 58, 64, 64, (3, 1, 1, False), f32, 3., False),
             ('warp 64ch bf16', 1, 64, 64, (PP_FEAT, 1, 1, False), bf16, 3., False)
             ] if cases is None else cases
    summary = {name: {'max_abs_err': 0., 'library_ms': None} for name in DEFORM_KERNELS}
    for case in cases:
        tag, n, h, w, (c, taps, groups, with_mask), dt, spread, timed = case
        if spread == ('edge', None):   # the halo K9's plan gives this shape
            k = 3 if taps == 9 else 1
            spread = ('edge', D.backward_plan(torch.empty(n, c, h, w, device='cuda', dtype=dt),
                                              D.SampleGeometry(k, k, 1, k // 2, 1, groups)).halo)
        x, offset, mask, dcol, geo = deform_inputs(n, c, h, w, taps, groups, with_mask, dt,
                                                   spread, gen)
        outside = 1 - D.reference_deform_sample(torch.ones(n, groups, h, w, device='cuda'),
                                                offset, None, geo).ne(0).float().mean().item()
        tag = (f'{tag:22s} N={n} C={c} {h}x{w} K={taps} G={groups} {str(dt)[6:]:8s} '
               f'({100 * outside:.1f}% of the samples outside)')
        runs = [('deform_sample_fwd', lambda: D.deform_sample_forward(x, offset, mask, geo),
                 lambda: D.reference_deform_sample(x, offset, mask, geo), ('col',)),
                ('deform_sample_bwd', lambda: D.deform_sample_backward(x, offset, mask, dcol, geo),
                 lambda: D.reference_deform_sample_backward(x, offset, mask, dcol, geo),
                 ('dx', 'doffset', 'dmask'))]
        for name, kernel, plain, outputs in runs:
            with torch.no_grad():
                got = kernel()
            want = plain()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst = []
            for out_name, g_, w_ in zip(outputs, got, want):
                if w_ is None:
                    if g_ is not None:
                        fail(f'{name}: {out_name} without a mask at {tag}')
                    continue
                # the column tensor is elementwise; the gradients are sums (dx over the
                # samples that touch a pixel, by atomicAdd; the others over a group's channels)
                rule = 'elementwise' if out_name == 'col' else 'sum'
                ok, max_abs, max_rel, tolerance = compare(g_, w_, dt, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                if not ok:
                    fail(f'{name}: {out_name} disagrees with the plain version at {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
                if dt == f32:
                    summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'], max_abs)
            line = f'{name:18s} {tag}: max abs err (of max|plain|) ' + ', '.join(worst)
            del got, want
            if timed:
                with torch.no_grad():
                    kernel_ms = cuda_time_ms(kernel, iters=5)
                plain_ms = cuda_time_ms(plain, iters=2)
                with torch.no_grad():
                    kernel_ms = (kernel_ms + cuda_time_ms(kernel, iters=5)) / 2
                flop, nbytes = deform_work(name, n, c, h, w, taps, groups, with_mask, dt)
                bound, by = bound_ms(flop, nbytes, dt)
                line += (f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                         f'{bound:.4f} ms by {by}')
                times = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
                if taps == 1:   # the library's call for the same warp, as a yardstick
                    grid = grid_of(offset)
                    if name == 'deform_sample_fwd':
                        def call():
                            return F.grid_sample(x, grid, 'bilinear', 'zeros', True)
                        with torch.no_grad():
                            lib = call().unsqueeze(2)
                            want = plain()
                    else:
                        xg, gg = x.clone().requires_grad_(), grid.clone().requires_grad_()
                        out = F.grid_sample(xg, gg, 'bilinear', 'zeros', True)

                        def call():
                            return torch.autograd.grad(out, (xg, gg), dcol[:, :, 0],
                                                       retain_graph=True)
                        lib, want = call()[0], plain()[0]
                    ok, max_abs, max_rel, _ = compare(lib, want, dt, 'sum')
                    if max_rel > 1e-3:   # it blends on the normalised grid: a looser check
                        fail(f'F.grid_sample disagrees with the plain version at {tag}: '
                             f'{max_abs:.3e}')
                    times['library_ms'] = cuda_time_ms(call, iters=5)
                    line += f', library (F.grid_sample) {times["library_ms"]:.4f} ms'
                    if case == warp_case:
                        summary[name]['one_tap'] = times
                if case == train_case:
                    summary[name].update(times)
            print(line, flush=True)
            if name == 'deform_sample_bwd':
                check_deform_backward(D, x, offset, mask, dcol, geo, tag, kernel, outputs)
        del x, offset, mask, dcol
        torch.cuda.empty_cache()
    if cases is None:
        check_flow_warps(gen, summary)
        check_border_warp(gen)
    return summary


def check_deform_backward(D, x, offset, mask, dcol, geo, tag, kernel, outputs):
    """K9 beyond its values: its plan (the window the card's occupancy gives,
    as ``backward_window`` computes it), the share of corners it summed in
    device memory rather than in its window, and d offset and d mask
    repeating bit for bit (one writer each; dx's atomic sums need not)."""
    name = 'deform_sample_bwd'
    plan = D.backward_plan(x, geo)
    window = D.backward_window(x.shape, geo, plan.halo)
    if plan.window != window:
        fail(f'{name}: the plan\'s window {plan.window} is not backward_window\'s {window}')
    counts = torch.zeros(2, dtype=torch.int64, device='cuda')
    with torch.no_grad():
        D._launch_backward(x, offset, mask, dcol, geo, True, True, corners=counts)
        first, again = kernel(), kernel()
    near, far = counts.tolist()
    same = {o: torch.equal(a, b) for o, a, b in zip(outputs, first, again) if a is not None}
    print(f'{name:18s} {tag}: plan halo {plan.halo}, window {window.height}x{window.width} '
          f'({window.smem_bytes} bytes a block), {window.slices} slice(s) of 32x{window.rows} '
          f'pixels, {plan.taps_per_z} tap(s) a block, grid {plan.grid}, {plan.blocks_per_sm} '
          f'blocks an SM; corners summed in device memory: {far} of {near + far} '
          f'({100 * far / max(near + far, 1):.2f}%); a second launch repeats bit for bit: '
          + ', '.join(f'{o} {"yes" if v else "no"}' for o, v in same.items()), flush=True)
    if not all(v for o, v in same.items() if o != 'dx'):
        fail(f'{name}: d offset or d mask differs between two launches at {tag}')


def kernel_device_ms(fn, iters=20, only=None):
    """Milliseconds of device time (kernels and memory operations; with
    ``only``, those whose name holds it) a call of ``fn`` takes, by
    ``torch.profiler`` over ``iters`` calls; None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = device_time_by_group(prof, ())[0]
    busy_ms = sum(ms for key, ms, _ in rows if only is None or only in key)
    return busy_ms / iters if busy_ms else None


def show_ms(ms):
    return 'not seen' if ms is None else f'{ms:.4f} ms'


def host_us(fn, iters=200):
    """Microseconds of host time a call of ``fn`` takes, the device kept
    ahead of the host by a long kernel first."""
    torch.cuda._sleep(int(2e8))   # about 0.1 s of device time, so nothing waits on it
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def check_flow_warps(gen, summary):
    """The one-tap warp as ``flow_warp`` runs it in 'zeros' mode: the flow
    (N, H, W, 2) read by the kernel through its strides, handed over as
    BasicVSR++ does (a permuted (N, 2, H, W) map), against the plain version
    on BasicSR's offset; then the call time (CUDA events around the
    wrapper) and the kernel's device time (``torch.profiler``) beside
    ``F.grid_sample``'s, so that what is left between them reads as host or
    device time; and the gradients of ``flow_warp`` against the plain
    versions."""
    import torch.nn.functional as F

    from basicsr4rs_torch.archs.arch_util import flow_warp
    from basicsr4rs_torch.ops import dcn as D
    f32 = torch.float32
    for tag, c, (h, w) in (('warp 64ch flow', PP_FEAT, (64, 64)),
                           ('warp 64ch flow serve', PP_FEAT, VIDEO_LQ),
                           ('warp 2ch flow', 2, (64, 64))):
        x = torch.randn(1, c, h, w, generator=gen).cuda()
        flow = (torch.randn(1, 2, h, w, generator=gen) * 3.).cuda().permute(0, 2, 3, 1)
        offset = torch.stack([flow[..., 1], flow[..., 0]], dim=1)   # BasicSR's (dy, dx)
        with torch.no_grad():
            got = D.warp_by_flow(x, flow)
        want = D.reference_deform_sample(x, offset, None, D.WARP).reshape(x.shape)
        ok, max_abs, max_rel, tolerance = compare(got, want, f32, 'elementwise')
        if not ok:
            fail(f'deform_sample_fwd: the flow warp disagrees with the plain version at {tag}: '
                 f'{max_abs:.3e}, tolerance {tolerance}')
        summary['deform_sample_fwd']['max_abs_err'] = max(
            summary['deform_sample_fwd']['max_abs_err'], max_abs)
        grid = grid_of(offset)

        def kernel():
            return D.warp_by_flow(x, flow)

        def library():
            return F.grid_sample(x, grid, 'bilinear', 'zeros', True)

        col = torch.empty(1, c, 1, h, w, device='cuda')
        lib = D._lib('deform_sample_fwd')
        launch_args = (0, x.data_ptr(), flow.data_ptr(), None, col.data_ptr(),
                       D._forward_dims(x.shape, D.FLOW_WARP, flow.shape, flow.stride())[1],
                       torch.cuda.current_stream().cuda_stream)

        def launch_only():   # the C call alone: ctypes and the kernel's launch
            return lib.deform_sample_fwd(*launch_args)

        with torch.no_grad():
            kernel_ms, library_ms = time_pair(library, kernel)
            device_ms, library_device_ms = kernel_device_ms(kernel), kernel_device_ms(library)
            wrapper_us, launch_us, library_us = host_us(kernel), host_us(launch_only), host_us(
                library)
        bound, by = bound_ms(*deform_work('deform_sample_fwd', 1, c, h, w, 1, 1, False, f32), f32)

        print(f'{"deform_sample_fwd":18s} {tag:22s} N=1 C={c} {h}x{w} (flow_warp, zeros): max abs '
              f'err {max_abs:.2e} | call {kernel_ms:.4f} ms, device {show_ms(device_ms)}; '
              f'F.grid_sample call {library_ms:.4f} ms, device {show_ms(library_device_ms)}; bound '
              f'{bound:.4f} ms by {by}; host {wrapper_us:.1f} us a call, of which the C call '
              f'(ctypes and launch) {launch_us:.1f} us; F.grid_sample host {library_us:.1f} us',
              flush=True)
        summary['deform_sample_fwd'].setdefault('flow_warp', {})[f'C={c} {h}x{w}'] = dict(
            ms=kernel_ms, device_ms=device_ms, library_ms=library_ms,
            library_device_ms=library_device_ms, bound_ms=bound, host_us=wrapper_us,
            launch_us=launch_us, library_host_us=library_us)
    # gradients of flow_warp's zeros mode, through the kernels and the plain versions
    n, c, h, w = 2, 16, 96, 160
    x = torch.randn(n, c, h, w, generator=gen).cuda()
    flow = (torch.randn(n, 2, h, w, generator=gen) * 20).cuda()
    dout = torch.randn(n, c, h, w, generator=gen).cuda()

    def run():
        xx, ff = x.clone().requires_grad_(), flow.clone().requires_grad_()
        out = flow_warp(xx, ff.permute(0, 2, 3, 1))
        return (out.detach(),) + torch.autograd.grad(out, (xx, ff), dout)

    got = run()
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        want = run()
    finally:
        for p in patches:
            p.stop()
    worst = []
    for name, g_, w_ in zip(('out', 'dx', 'dflow'), got, want):
        ok, max_abs, max_rel, tolerance = compare(g_, w_, f32, 'elementwise' if name == 'out'
                                                  else 'sum')
        worst.append(f'{name} {max_abs:.2e} ({max_rel:.1e})')
        if not ok:
            fail(f'flow_warp (zeros): {name} disagrees with the plain version: {max_abs:.3e}, '
                 f'tolerance {tolerance}')
    print(f'flow_warp zeros       N={n} C={c} {h}x{w}, flow as a permuted (N, 2, H, W) map: '
          'max abs err (of max|plain|) ' + ', '.join(worst), flush=True)


def check_border_warp(gen):
    """``bilinear_warp`` with ``border`` (positions clamped to the map before
    the kernel sees them), forward and backward through the autograd
    function, against the same call on the plain versions."""
    from basicsr4rs_torch.ops import dcn as D
    n, c, h, w = 58, 3, 96, 160   # SpyNet's batch of a 30-frame clip, one level down
    x = torch.randn(n, c, h, w, generator=gen).cuda()
    ys = torch.arange(h).view(1, h, 1) + torch.randn(n, h, w, generator=gen) * 20
    xs = torch.arange(w).view(1, 1, w) + torch.randn(n, h, w, generator=gen) * 20
    dout = torch.randn(n, c, h, w, generator=gen).cuda()

    def run():
        leaves = [t.clone().cuda().requires_grad_() for t in (x, ys, xs)]
        out = D.bilinear_warp(*leaves, border=True)
        return (out.detach(),) + torch.autograd.grad(out, leaves, dout)

    got = run()
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        want = run()
    finally:
        for p in patches:
            p.stop()
    clamped = ((ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)).float().mean().item()
    worst = []
    for name, g_, w_ in zip(('out', 'dx', 'dpy', 'dpx'), got, want):
        ok, max_abs, max_rel, tolerance = compare(g_, w_, torch.float32,
                                                  'elementwise' if name == 'out' else 'sum')
        worst.append(f'{name} {max_abs:.2e} ({max_rel:.1e})')
        if not ok:
            fail(f'bilinear_warp with border: {name} disagrees with the plain version: '
                 f'{max_abs:.3e}, tolerance {tolerance}')
    outside = (ys < 0) | (ys > h - 1)
    if got[2].cpu()[outside].abs().max().item() != 0:
        fail('bilinear_warp with border: a clamped position has a gradient')
    print(f'bilinear_warp border  N={n} C={c} {h}x{w} ({100 * clamped:.1f}% of the positions '
          'clamped, their gradient zero): max abs err (of max|plain|) ' + ', '.join(worst),
          flush=True)


def write_inputs():
    """4 synthetic GT/LQ pairs (smooth random images, LQ the bicubic
    downscale) and the seed-0 random SwinIR-M weights the config names."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(0)
    for sub in ('GT', 'LQ'):
        os.makedirs(os.path.join(DATA_DIR, sub), exist_ok=True)
    for i, (h, w) in enumerate(LQ_SIZES):
        coarse = rng.rand(h // 4 + 2, w // 4 + 2, 3).astype(np.float32)
        gt = cv2.resize(coarse, (SCALE * w, SCALE * h), interpolation=cv2.INTER_CUBIC)
        gt = (np.clip(gt, 0, 1) * 255).round().astype(np.uint8)
        lq = cv2.resize(gt, (w, h), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(DATA_DIR, 'GT', f'{i:04d}.png'), gt)
        cv2.imwrite(os.path.join(DATA_DIR, 'LQ', f'{i:04d}.png'), lq)
    net_opt = dict(yaml_load(CONFIG)['network_g'])
    net_opt.pop('type')
    net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0))
    os.makedirs(os.path.dirname(WEIGHTS), exist_ok=True)
    torch.save({'params': net.state_dict()}, WEIGHTS)
    return sum(net_opt['depths'])


def serve():
    import cv2
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    phase('4. serve SwinIR-M x4 through basicsr4rs_torch.test on cuda:0')
    blocks = write_inputs()
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', CONFIG]
    fused_swin_block_full.launches = 0
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_swin_block_full.launches
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, 4 requests, metrics, '
          f'image writes); kernel launches {launches} = {launches / len(LQ_SIZES):g} per request')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != blocks * len(LQ_SIZES):
        fail(f'expected {blocks} kernel launches per forward, counted {launches} '
             f'over {len(LQ_SIZES)} requests')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{name} is not finite')
    out_dir = os.path.join(model.opt['path']['visualization'], 'SwinIR_M_x4_synthetic')
    for i, (h, w) in enumerate(LQ_SIZES):
        img = cv2.imread(os.path.join(out_dir, f'{i:04d}_{model.opt["name"]}.png'))
        if img is None or img.shape != (SCALE * h, SCALE * w, 3):
            fail(f'saved image {i}: {None if img is None else img.shape}')

    # per-request latency of the model's own test(), after a warm-up request
    loader = [item for item in model_loader(model)]
    model.feed_data(loader[0])
    model.test()
    latencies = []
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.test()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        out = model.output
        if out.shape != (1, 3, SCALE * h, SCALE * w) or not torch.isfinite(out).all():
            fail(f'request {h}x{w}: output {tuple(out.shape)}')
        latencies.append(ms)
        print(f'request LQ {h}x{w} -> {SCALE * h}x{SCALE * w}: {ms:.3f} ms, '
              f'{SCALE * h * SCALE * w / ms / 1e3:.3f} output MP/s')
    print(f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    return model, loader, launches


def request_latencies(model, items, want, launches=None, warm=True):
    """ms of the model's own test() on each of ``items``, after a warm-up
    request (none with ``warm=False``: the pipeline's own requests were),
    with the peak memory counted from the first timed one; ``want(item)``:
    the output's shape; ``launches``: (wrapper, count), the launches of a
    kernel each request must make."""
    if warm:
        model.feed_data(items[0])
        model.test()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    for item in items:
        model.feed_data(item)
        before = launches[0].launches if launches else 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model.test()
        end.record()
        torch.cuda.synchronize()
        out = model.output
        if tuple(out.shape) != tuple(want(item)) or not torch.isfinite(out).all():
            fail(f'request: output {tuple(out.shape)}, expected {tuple(want(item))}')
        if launches and launches[0].launches - before != launches[1]:
            fail(f'a request launched {getattr(launches[0], "__name__", "a kernel")} '
                 f'{launches[0].launches - before} times, expected {launches[1]}')
        latencies.append(start.elapsed_time(end))
    return latencies


def profile_requests(model, loader):
    """Phase 4b: where the device time of the SwinIR-M requests goes, by
    kernel group, one request of each served size."""
    phase('4b. device time of the SwinIR-M requests by kernel group (torch.profiler)')
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        print(f'LQ {h}x{w}:')
        profile_device_time(model.test, 1, 'request', ('swin_block_joint_kernel',),
                            f'swinir_request_{h}x{w}_profile.json')


def model_loader(model):
    """The loader of the model's (first) test set."""
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    dataset_opt = next(iter(model.opt['datasets'].values()))
    return build_dataloader(build_dataset(dataset_opt), dataset_opt)


def check_whole_model(model, loader):
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops.swin_block import reference_swin_block_full
    phase('5. whole model: kernel vs plain version, one request (LQ 125x94)')
    model.feed_data(loader[2])
    model.test()
    with_kernel = model.output.float().clamp(0, 1)
    with mock.patch.object(swinir_arch, 'fused_swin_block_full', reference_swin_block_full):
        model.test()
    plain = model.output.float().clamp(0, 1)
    err = (with_kernel - plain).abs().max().item()
    print(f'max abs error on the [0, 1] output: {err:.3e} (tolerance {MODEL_TOLERANCE})')
    if err > MODEL_TOLERANCE:
        fail('whole-model outputs disagree')


TRAIN_CONFIG = 'options/train/SwinIR/train_SwinIR_M_x4_synthetic.yml'
TRAIN_DATA_DIR = 'datasets/SwinIR_M_x4_synthetic_train'
TRAIN_IMAGES, TRAIN_GT_SIZE, VAL_LQ_SIZE = 8, 256, 64
RESUME_ITERS = 2
PROFILE_DIR = 'results/chip_smoke'
PROFILE_PAD = (200, 10**6)   # spin kernels, cycles each: about 0.1 s before a profiled window
# whole-model gradients, kernels vs plain versions: per parameter,
# max|difference| <= 1e-3 of the largest entry of the plain gradient (float32
# sums in another order through 36 blocks and 7 convolutions' backward)
GRAD_TOLERANCE = 1e-3


def smooth_image(rng, h, w):
    """A smooth random uint8 image: coarse noise, bicubically enlarged."""
    import cv2
    import numpy as np
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3).astype(np.float32)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_pairs(root, seed, sets):
    """Smooth GT images and their bicubic x``SCALE`` LQ under ``root``: for
    each of ``sets`` (GT folder, LQ folder, count, GT size), from one
    ``RandomState(seed)``."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    for gt_dir, lq_dir, count, size in sets:
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(count):
            gt = smooth_image(rng, size, size)
            lq = cv2.resize(gt, (size // SCALE, size // SCALE), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(root, lq_dir, f'{i:04d}.png'), lq)


def write_train_inputs():
    """Synthetic GT/LQ pairs for training (8 of GT 256x256, two batches of 4
    at GT patch 192) and one validation pair (LQ 64x64)."""
    write_pairs(TRAIN_DATA_DIR, 1, [('GT', 'LQ', TRAIN_IMAGES, TRAIN_GT_SIZE),
                                    ('val_GT', 'val_LQ', 1, SCALE * VAL_LQ_SIZE)])


def training_kernels():
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    return {'swin_block_joint_fwd': S.fused_swin_block_full,
            'swin_attn_block_fwd': S.swin_attn_block_forward,
            'swin_attn_block_bwd': S.swin_attn_block_backward,
            'mlp_block_fwd': M.mlp_block_forward, 'mlp_block_bwd': M.mlp_block_backward}


def run_train_pipeline(extra_args, record, config=None, model_cls=None, loss_key='l_pix',
                       wrappers=None, before_first_step=None, after_step=None,
                       record_tests=False):
    """``basicsr4rs_torch.train.train_pipeline`` on a synthetic config, with
    every optimization step of ``model_cls`` timed by CUDA events and its
    loss and launch counts recorded; ``after_step(model, step record)`` may
    add to the step's record; with ``record_tests`` each ``test()`` of the
    model (a validation image) is recorded too (``recorded_tests``)."""
    import basicsr4rs_torch.train as entry
    from basicsr4rs_torch.models.swinir_model import SwinIRModel
    config = config or TRAIN_CONFIG
    model_cls = model_cls or SwinIRModel
    wrappers = wrappers or training_kernels()
    before_first_step = before_first_step or follow_first_batch
    step = model_cls.optimize_parameters

    def timed_step(model, current_iter):
        if not record['steps']:
            before_first_step(model, record)
        before = {k: w.launches for k, w in wrappers.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(model, current_iter)
        end.record()
        torch.cuda.synchronize()
        record['steps'].append({
            'iter': current_iter, 'ms': start.elapsed_time(end),
            loss_key: float(model.log_dict[loss_key]),
            'launches': {k: w.launches - before[k] for k, w in wrappers.items()}})
        if after_step is not None:
            after_step(model, record['steps'][-1])

    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.train', '-opt', config] + extra_args
    try:
        with contextlib.ExitStack() as patches:
            patches.enter_context(mock.patch.object(model_cls, 'optimize_parameters', timed_step))
            if record_tests:
                for patch in recorded_tests(model_cls, record, wrappers):
                    patches.enter_context(patch)
            return entry.train_pipeline(ROOT)
    finally:
        sys.argv = argv


def recorded_tests(model_cls, record, wrappers):
    """Patches of ``model_cls`` (an ``SRModel``) under which each ``test()``
    goes into ``record['tests']``: its time by CUDA events, its launches, the
    peak memory above its start, whether each forward ran on bands, its
    output on the host."""
    test, forward, bands = model_cls.test, model_cls._eval_forward, []
    record.setdefault('tests', [])

    def recorded_forward(model, x):
        bands.append(model._eval_on_bands(x))
        return forward(model, x)

    def timed_test(model):
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        test(model)
        end.record()
        torch.cuda.synchronize()
        record['tests'].append({
            'ms': start.elapsed_time(end), 'on_bands': bands[:],
            'launches': {k: w.launches - before[k] for k, w in wrappers.items()},
            'peak_mib': (torch.cuda.max_memory_allocated() - base) / 2**20,
            'output': model.output.cpu()})
        bands.clear()

    return [mock.patch.object(model_cls, 'test', timed_test),
            mock.patch.object(model_cls, '_eval_forward', recorded_forward)]


def model_class(config):
    """The model class that a training config names."""
    import basicsr4rs_torch.models  # noqa: F401  registers every model class
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.registry import MODEL_REGISTRY
    return MODEL_REGISTRY.get(yaml_load(config)['model_type'])


def lq_rows(model, step):
    """``after_step``: the LQ rows the step trained on."""
    step['lq_rows'] = model.lq.shape[2]


def fresh_run(opt, wrappers):
    """A clean start for a training phase: the experiment's folders gone (no
    archived copies, no resume), the kernels' counts at 0 and the peak
    memory counter reset. Returns the experiment's folder."""
    import glob
    import shutil
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):
        shutil.rmtree(old)
    for wr in wrappers.values():
        wr.launches = 0
    torch.cuda.reset_peak_memory_stats()
    return exp_dir


def check_steps(steps, total_iter, loss_key, per_step):
    """Print each step's record; fail unless steps 1..total_iter ran, each
    with a finite loss and ``per_step[kernel]`` launches of each kernel
    named. Returns the mean ms of steps 3..total_iter."""
    for st in steps:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, {loss_key} {st[loss_key]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items() if v))
    if [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'expected steps 1..{total_iter}, ran {[st["iter"] for st in steps]}')
    for st in steps:
        if not math.isfinite(st[loss_key]):
            fail(f'{loss_key} is not finite at step {st["iter"]}')
        for name, count in per_step.items():
            if st['launches'][name] != count:
                fail(f'step {st["iter"]}: {st["launches"][name]} launches of {name}, '
                     f'expected {count}')
    timed = [st['ms'] for st in steps[2:]]
    step_ms = sum(timed) / len(timed)
    print(f'training step: {step_ms:.3f} ms mean of steps 3..{total_iter} (min {min(timed):.3f}, '
          f'max {max(timed):.3f}; CUDA events around optimize_parameters, after 2 warm-up '
          f'steps); peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    return step_ms


SPLIT_KERNELS = ('swin_attn_block_fwd', 'swin_attn_block_bwd', 'mlp_block_fwd', 'mlp_block_bwd')


def follow_first_batch(model, record):
    """Keep SwinIR's first batch: the loss is followed on it."""
    if 'fixed' not in record:
        record['fixed'] = (model.lq.clone(), model.gt.clone())
        record['fixed_loss_before'] = fixed_batch_loss(model, record['fixed'])


def keep_fed_batch(model, record):
    """Keep the first batch as fed (``lq``, ``gt`` and what ``feed_data``
    made of them): a profile of the model's steps runs on it."""
    record.setdefault('batch', {k: v.clone() for k, v in vars(model).items()
                                if k in ('lq', 'gt', 'lq_up', 'reg_input')})


def profile_fed_steps(model, record, wrappers, json_name):
    """One training step of ``model`` on the kept batch (after one
    unprofiled), device time by kernel; the launches they make belong to no
    main path's count."""
    for key, value in record['batch'].items():
        setattr(model, key, value)
    model.tt = model.noise = None
    counts = {k: wr.launches for k, wr in wrappers.items()}
    model.optimize_parameters(0)
    profile_device_time(lambda: model.optimize_parameters(0), 1, 'step', tuple(wrappers),
                        json_name)
    for k, wr in wrappers.items():
        wr.launches = counts[k]


def fixed_batch_loss(model, batch):
    """The pixel loss of the training network in eval mode on a fixed batch."""
    lq, gt = batch
    net = model.net_g
    net.eval()
    with torch.no_grad():
        loss = float(model.cri_pix(net(lq), gt))
    net.train()
    return loss


def check_ema_and_checkpoint(model, fresh, ckpt_path):
    """The EMA network has left the trained one, and the saved ``.pth`` holds
    ``params`` and ``params_ema`` that load into ``fresh`` (a new network of
    the same options), ``params_ema`` equal to the EMA network."""
    diff = max((p - e).abs().max().item() for p, e in
               zip(model.net_g.parameters(), model.net_g_ema.parameters()))
    print(f'max |net_g - net_g_ema| over the parameters: {diff:.3e}')
    if not diff > 0:
        fail('the EMA network equals the trained network')
    ckpt = torch.load(ckpt_path, map_location='cpu', weights_only=True)
    if sorted(ckpt) != ['params', 'params_ema']:
        fail(f'{ckpt_path} holds {sorted(ckpt)}')
    for key in ('params', 'params_ema'):
        model.load_network(fresh, ckpt_path, True, key)
    for (name, p), q in zip(fresh.named_parameters(), model.net_g_ema.parameters()):
        if not torch.equal(p, q.cpu()):
            fail(f'{ckpt_path}: params_ema[{name}] differs from the EMA network')
    print(f'{ckpt_path}: params and params_ema load back, params_ema equals the EMA network')


def train():
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    phase('6. train SwinIR-M x4 through basicsr4rs_torch.train on cuda:0 '
          '(batch 4, GT 192: 9216 tokens a step)')
    write_train_inputs()
    opt = yaml_load(TRAIN_CONFIG)
    total_iter = opt['train']['total_iter']
    blocks = sum(opt['network_g']['depths'])
    wrappers = training_kernels()
    exp_dir = fresh_run(opt, wrappers)
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline([], record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    steps = record['steps']
    # validation at every val_freq and once more after the loop
    validations = total_iter // opt['val']['val_freq'] + 1
    print(f'pipeline wall time {wall:.3f} s for {len(steps)} steps, {validations} validations, '
          'checkpoints')
    step_ms = check_steps(steps, total_iter, 'l_pix', dict.fromkeys(SPLIT_KERNELS, blocks))
    # each validation image, and the fixed batch before step 1, is one forward
    # of the joint kernel per block
    if launches['swin_block_joint_fwd'] != blocks * (validations + 1):
        fail(f'{launches["swin_block_joint_fwd"]} launches of the joint kernel, expected '
             f'{blocks} x ({validations} validation images + 1 fixed batch)')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items()))
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before '
          f'step 1, {loss_after:.6f} after step {total_iter} '
          f'(Adam, lr {opt["train"]["optim_g"]["lr"]}, the config\'s)')
    if not loss_after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')

    # EMA, checkpoint, resume
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    check_ema_and_checkpoint(model, SwinIR(**net_opt),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))

    resumed = {'steps': [], 'fixed': record['fixed'], 'fixed_loss_before': 0.}
    # the resumed run also takes its batches through the CUDA prefetcher
    run_train_pipeline(['--auto_resume', '--force_yml',
                        f'train:total_iter={total_iter + RESUME_ITERS}',
                        'datasets:train:prefetch_mode=cuda'], resumed)
    iters = [st['iter'] for st in resumed['steps']]
    print(f'resumed from {total_iter}.state (prefetch_mode: cuda): ran steps {iters}, l_pix '
          + ' '.join(f'{st["l_pix"]:.6f}' for st in resumed['steps']))
    if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
        fail(f'resume should continue at step {total_iter + 1}, ran {iters}')
    profile_training_steps(model, record['fixed'])
    return launches, step_ms, peak


# ------------------------------------------------------------ data parallel
DIST_DIR = 'results/chip_smoke/dist'
DIST_DATA_DIR = 'datasets/SwinIR_M_x4_dist'
DIST_ITERS, DIST_RESUME_ITERS = 10, 2   # phase 63: steps, then steps after --auto_resume
DIST_ROWS, DIST_STEPS, DIST_LR = 2, 2, 1e-2   # phase 64: rows a rank a step, steps, SGD's rate
STRIDE_WARNING = 'Grad strides do not match bucket view strides'
DIST_TIMEOUT = 600   # seconds from a launcher's start to its last rank's end


def dist_rank(job_file):
    """One rank of phase 63, 64, 65 or 72, started by torchrun: ``basicsr4rs_torch.
    train``'s pipeline with each command line of the job in turn (the code
    path of ``python -m basicsr4rs_torch.train -opt <yml> --launcher
    pytorch``; a second line with ``--auto_resume`` resumes in the same
    process), every step timed by CUDA events with its kernel launches, the
    launches of each run in all, and every warning; or phase 65's model
    jobs (``models``, ``dist_models_rank``); written as JSON for the parent.
    ``configs`` gives each command line its own config (else ``config``);
    with ``record_tests`` each validation image's record goes with its run
    and its outputs to ``<out>.run<i>.rank<r>.val.pt``. A job with ``after``
    trains once that file exists (the card's other phase has ended); rank 0
    of a job with ``done`` writes that file at its end."""
    import warnings

    import torch._dynamo  # noqa: F401  the first DDP's imports, done while
    import torch.distributed.tensor  # noqa: F401  the other phase trains

    from basicsr4rs_torch.utils.dist_util import close_dist, get_dist_info
    with open(job_file) as f:
        job = json.load(f)
    deadline = time.monotonic() + DIST_TIMEOUT
    while job.get('after') and not os.path.exists(job['after']):
        if time.monotonic() > deadline:
            fail(f'{job["after"]} did not appear within {DIST_TIMEOUT} s')
        time.sleep(0.2)
    wrappers = training_kernels()
    runs = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            if job.get('models'):   # phase 65
                runs = dist_models_rank(job)
            argvs = job['argv'] or []
            for config, argv in zip(job.get('configs') or [job['config']] * len(argvs), argvs):
                record = {'steps': []}
                for wr in wrappers.values():
                    wr.launches = 0
                model = run_train_pipeline(argv, record, config=config,
                                           model_cls=model_class(config),
                                           before_first_step=lambda *_: None,
                                           after_step=lq_rows,
                                           record_tests=job.get('record_tests', False))
                torch.cuda.synchronize()
                tests = record.get('tests', [])
                if tests:
                    torch.save([t.pop('output') for t in tests],
                               f'{job["out"]}.run{len(runs)}.rank{get_dist_info()[0]}.val.pt')
                runs.append({'steps': record['steps'], 'tests': tests,
                             'metrics': {k: float(v) for k, v in
                                         getattr(model, 'metric_results', {}).items()},
                             'launches': {k: wr.launches for k, wr in wrappers.items()},
                             'net': type(model.net_g).__name__, 'device': str(model.device)})
        rank, world_size = get_dist_info()
        with open(f'{job["out"]}.rank{rank}.json', 'w') as f:
            json.dump({'rank': rank, 'world_size': world_size, 'runs': runs,
                       'warnings': [str(w.message) for w in caught],
                       'peak_mib': torch.cuda.max_memory_allocated() / 2**20}, f)
        if job.get('done') and rank == 0:
            open(job['done'], 'w').close()
    finally:
        close_dist()


def start_torchrun(nproc, config, argv, out, after=None, done=None, models=None,
                   configs=None, record_tests=False):
    """``chip_smoke.py rank`` on ``nproc`` ranks under ``torchrun
    --standalone`` (a free port) in a session of its own, each running the
    pipeline with the command lines ``argv``, or phase 65's ``models``
    (``after``, ``done``, ``configs``, ``record_tests``: see ``dist_rank``).
    Returns what ``finish_torchrun`` takes."""
    os.makedirs(DIST_DIR, exist_ok=True)
    job_file = f'{out}.job.json'
    with open(job_file, 'w') as f:
        json.dump({'config': config, 'argv': argv, 'out': out, 'after': after, 'done': done,
                   'models': models, 'configs': configs, 'record_tests': record_tests}, f)
    for rank in range(nproc):
        if os.path.exists(f'{out}.rank{rank}.json'):
            os.remove(f'{out}.rank{rank}.json')
    log = open(f'{out}.log', 'w')
    command = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', str(nproc), os.path.join(ROOT, 'chip_smoke.py'), 'rank',
               job_file]
    proc = subprocess.Popen(command, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    return dict(proc=proc, log=log, out=out, nproc=nproc, t0=time.perf_counter())


def stop_torchrun(run):
    """End the run's launcher and ranks, whatever their state."""
    if run['proc'].poll() is None:
        os.killpg(run['proc'].pid, 9)
        run['proc'].wait()
    run['log'].close()


def finish_torchrun(run, others=()):
    """Wait for ``run``; fail (stopping ``others`` first) unless every rank
    ended well within ``DIST_TIMEOUT`` s of the start and without DDP's
    stride warning. Returns the ranks' records and the wall time."""
    out, nproc = run['out'], run['nproc']
    try:
        run['proc'].wait(timeout=max(1., DIST_TIMEOUT - (time.perf_counter() - run['t0'])))
    except subprocess.TimeoutExpired:
        pass
    wall = time.perf_counter() - run['t0']
    rc = run['proc'].poll()
    stop_torchrun(run)
    with open(f'{out}.log') as f:
        text = f.read()
    if rc != 0:
        for other in others:
            stop_torchrun(other)
        print(text[-8000:])
        fail(f'torchrun on {nproc} ranks ' + (f'did not end within {DIST_TIMEOUT} s' if rc is None
                                              else f'exited with {rc}') + f' (log: {out}.log)')
    ranks = []
    for rank in range(nproc):
        with open(f'{out}.rank{rank}.json') as f:
            ranks.append(json.load(f))
    if STRIDE_WARNING in text or any(STRIDE_WARNING in w for r in ranks for w in r['warnings']):
        fail(f'DDP warned: {STRIDE_WARNING} (a kernel handed back a gradient of other strides)')
    return ranks, wall


def check_dist_steps(steps, iters, blocks, who):
    if [st['iter'] for st in steps] != list(iters):
        fail(f'{who}: ran steps {[st["iter"] for st in steps]}, expected {list(iters)}')
    for st in steps:
        print(f'{who} step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items() if v))
        if not math.isfinite(st['l_pix']):
            fail(f'{who}: l_pix is not finite at step {st["iter"]}')
        for name in SPLIT_KERNELS:
            if st['launches'][name] != blocks:
                fail(f'{who} step {st["iter"]}: {st["launches"][name]} launches of {name}, '
                     f'expected {blocks}')


def one_rank_argv():
    """Phase 63's command lines: training steps with a checkpoint and one
    validation, then ``--auto_resume`` for more."""
    name = 'chip_smoke_dist_one_rank'
    shutil.rmtree(os.path.join('experiments', name), ignore_errors=True)
    force = [f'name={name}', 'val:val_freq=1000', f'logger:save_checkpoint_freq={DIST_ITERS}']
    return [['--launcher', 'pytorch', '--force_yml', *force, f'train:total_iter={DIST_ITERS}'],
            ['--launcher', 'pytorch', '--auto_resume', '--force_yml', *force,
             f'train:total_iter={DIST_ITERS + DIST_RESUME_ITERS}']]


def dist_one_rank(ranks, wall, split_step_ms, card):
    """Phase 63: one rank through the real launcher on NCCL: training steps,
    a checkpoint and one validation, then ``--auto_resume``; K2 to K5 a step,
    K1 in the validation; the step beside phase 6's one-process step."""
    from basicsr4rs_torch.utils.options import yaml_load
    phase('63. data parallel, one rank: torchrun --standalone --nproc_per_node 1, NCCL, '
          'basicsr4rs_torch.train --launcher pytorch on SwinIR-M x4 (batch 4, GT 192)')
    blocks = sum(yaml_load(TRAIN_CONFIG)['network_g']['depths'])
    first, resumed = ranks[0]['runs']
    print(f'torchrun wall time {wall:.3f} s from the start of phases 63 and 64 (the launcher, '
          'the process, CUDA and NCCL set-up, waiting for phase 64\'s ranks, two pipelines); '
          f'network {first["net"]} on {first["device"]}; peak device memory '
          f'{ranks[0]["peak_mib"]:.1f} MiB')
    if first['net'] != 'DistributedDataParallel' or first['device'] != 'cuda:0':
        fail(f'the rank trained {first["net"]} on {first["device"]}')
    check_dist_steps(first['steps'], range(1, DIST_ITERS + 1), blocks, 'rank 0')
    check_dist_steps(resumed['steps'], range(DIST_ITERS + 1, DIST_ITERS + DIST_RESUME_ITERS + 1),
                     blocks, 'rank 0, resumed')
    for run in (first, resumed):   # one validation image after each run: K1 per block
        if run['launches']['swin_block_joint_fwd'] != blocks:
            fail(f'{run["launches"]["swin_block_joint_fwd"]} K1 launches in a run, expected '
                 f'{blocks} (one validation image)')
    ckpt = torch.load(os.path.join('experiments', 'chip_smoke_dist_one_rank', 'models',
                                   f'net_g_{DIST_ITERS}.pth'), map_location='cpu',
                      weights_only=True)
    if sorted(ckpt) != ['params', 'params_ema'] or any(
            k.startswith('module.') for k in ckpt['params']):
        fail(f'net_g_{DIST_ITERS}.pth holds {sorted(ckpt)} with keys like '
             f'{next(iter(ckpt["params"]))}')
    timed = [st['ms'] for st in first['steps'][2:]]
    step_ms = sum(timed) / len(timed)
    print(f'{card}: training step under DDP on one rank {step_ms:.3f} ms (mean of steps 3..'
          f'{DIST_ITERS}, min {min(timed):.3f}, max {max(timed):.3f}; CUDA events around '
          f'optimize_parameters) against {split_step_ms:.3f} ms one process without DDP (phase '
          f'6, this call): DDP\'s cost at one rank {step_ms - split_step_ms:+.3f} ms '
          f'({100 * (step_ms / split_step_ms - 1):+.1f}%)')
    return {k: first['launches'][k] + resumed['launches'][k] for k in first['launches']}


def write_dist_inputs():
    """8 GT 192x192 / LQ 48x48 pairs for phase 64 (the crop is the whole GT:
    no random draw touches the data) and one validation pair."""
    write_pairs(DIST_DATA_DIR, 5, [('GT', 'LQ', 8, 192), ('val_GT', 'val_LQ', 1, 256)])


def dist_config(name, rows, init):
    """The SwinIR-M x4 training config for phase 64, ``rows`` a rank a
    step, from ``init``, without DropPath, flips or crops, with SGD (Adam
    would turn the rounding of gradients that are noise into steps of the
    full rate)."""
    import yaml

    from basicsr4rs_torch.utils.options import yaml_load
    opt = json.loads(json.dumps(yaml_load(TRAIN_CONFIG)))
    opt['name'] = name
    opt['dist_params'] = {'backend': 'gloo'}
    opt['datasets']['train'].update(
        dataroot_gt=f'{DIST_DATA_DIR}/GT', dataroot_lq=f'{DIST_DATA_DIR}/LQ', gt_size=192,
        use_hflip=False, use_rot=False, batch_size_per_gpu=rows)
    opt['datasets']['val'].update(dataroot_gt=f'{DIST_DATA_DIR}/val_GT',
                                  dataroot_lq=f'{DIST_DATA_DIR}/val_LQ')
    opt['network_g']['drop_path_rate'] = 0.0
    opt['path'].update(pretrain_network_g=init)
    opt['train'].update(total_iter=DIST_STEPS, optim_g={'type': 'SGD', 'lr': DIST_LR},
                        scheduler={'type': 'ConstantLR'})
    opt['val']['val_freq'] = 1000
    opt['logger']['save_checkpoint_freq'] = DIST_STEPS
    path = os.path.join(DIST_DIR, f'{name}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    shutil.rmtree(os.path.join('experiments', name), ignore_errors=True)
    return path


def two_ranks_inputs():
    """Phase 64's data, its init ``.pth`` and its two configs (two ranks,
    one process)."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    write_dist_inputs()
    os.makedirs(DIST_DIR, exist_ok=True)
    net_opt = dict(yaml_load(TRAIN_CONFIG)['network_g'], drop_path_rate=0.0)
    net_opt.pop('type')
    init = os.path.join(DIST_DIR, 'init.pth')
    torch.save({'params': SwinIR(**net_opt, generator=torch.Generator().manual_seed(3))
                .state_dict()}, init)
    return (init, dist_config('chip_smoke_dist_two_ranks', DIST_ROWS, init),
            dist_config('chip_smoke_dist_one_process', 2 * DIST_ROWS, init))


def params_agree(name, who, got, want, start):
    """Weights after the steps (``got``: of several ranks) against the one
    process's (``want``), both from ``start``: each entry within
    ``F32_TOL``, and the steps taken within ``F32_SUM_TOL`` of the largest
    step (K3's and K5's atomic sums). Returns the largest step."""
    atol, rtol = F32_TOL
    step_err = step_max = param_err = 0.
    elementwise = True
    for key, value in got.items():
        if not value.is_floating_point() or key not in start:
            continue
        moved_got, moved_want = value - start[key], want[key] - start[key]
        step_err = max(step_err, (moved_got - moved_want).abs().max().item())
        step_max = max(step_max, moved_want.abs().max().item())
        diff = (value - want[key]).abs()
        param_err = max(param_err, diff.max().item())
        elementwise &= bool((diff <= atol + rtol * want[key].abs()).all())
    print(f'{name}: largest parameter difference {param_err:.3e} (F32_TOL elementwise: '
          f'{"held" if elementwise else "BROKEN"}); the steps taken differ by {step_err:.3e} of '
          f'a largest step {step_max:.3e} ({step_err / max(step_max, 1e-30):.2e} of it; '
          f'F32_SUM_TOL {F32_SUM_TOL})')
    if not (elementwise and step_max > 0 and step_err <= F32_SUM_TOL * step_max):
        fail(f'{name}: {who} do not train as one process at the global batch')
    return step_max


def dist_two_ranks(ranks, wall, init, one, card):
    """Phase 64: two ranks on the one card over gloo against one process at
    the global batch, from one ``.pth`` on the same items: the parameters
    and the EMA after the steps, and both step times."""
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'64. data parallel, two ranks on the one card over gloo: {DIST_STEPS} SGD steps of '
          f'SwinIR-M x4 at {DIST_ROWS} rows a rank against one process at {2 * DIST_ROWS} rows, '
          'from one .pth on the same items')
    blocks = sum(yaml_load(TRAIN_CONFIG)['network_g']['depths'])
    print(f'torchrun wall time {wall:.3f} s (two processes on cuda:0, gloo)')
    for r in ranks:
        run = r['runs'][0]
        if run['net'] != 'DistributedDataParallel' or run['device'] != 'cuda:0':
            fail(f'rank {r["rank"]} trained {run["net"]} on {run["device"]}')
        check_dist_steps(run['steps'], range(1, DIST_STEPS + 1), blocks, f'rank {r["rank"]}')
    wrappers = training_kernels()
    for wr in wrappers.values():
        wr.launches = 0
    record = {'steps': []}
    run_train_pipeline([], record, config=one, before_first_step=lambda *_: None)
    torch.cuda.synchronize()
    check_dist_steps(record['steps'], range(1, DIST_STEPS + 1), blocks, 'one process')
    launches = {k: wr.launches + sum(r['runs'][0]['launches'][k] for r in ranks)
                for k, wr in wrappers.items()}
    for got, want in zip(ranks[0]['runs'][0]['steps'], record['steps']):
        print(f'step {got["iter"]}: l_pix {got["l_pix"]:.6f} (the ranks\' mean) against '
              f'{want["l_pix"]:.6f} (one process)')
        if not abs(got['l_pix'] - want['l_pix']) <= 1e-4 * abs(want['l_pix']):
            fail('the two ranks\' loss is not one process\'s')
    start = torch.load(init, map_location='cpu', weights_only=True)['params']
    pth = f'net_g_{DIST_STEPS}.pth'
    got = torch.load(os.path.join('experiments', 'chip_smoke_dist_two_ranks', 'models', pth),
                     map_location='cpu', weights_only=True)
    want = torch.load(os.path.join('experiments', 'chip_smoke_dist_one_process', 'models', pth),
                      map_location='cpu', weights_only=True)
    for key in ('params', 'params_ema'):
        if got[key].keys() != want[key].keys() or any(k.startswith('module.') for k in got[key]):
            fail(f'{key}: the two ranks saved other keys than one process')
    step_max = params_agree(f'params after {DIST_STEPS} steps', 'the two ranks',
                            got['params'], want['params'], start)
    # The EMA moves by (1 - decay) of a step, about a thousandth: below the
    # step rule's reach at float32's resolution of the weights. Each of its
    # two updates rounds to the weight's ulp, and the parameters it averages
    # may differ by what the step rule allows; an EMA that never moved, or
    # that is the weights themselves, must break the same rule.
    decay = yaml_load(TRAIN_CONFIG)['train']['ema_decay']
    slack = 2 * (1 - decay) * F32_SUM_TOL * step_max

    def ema_misses(ema):
        misses = 0
        for name, w in want['params_ema'].items():
            if w.is_floating_point() and name in start:
                ulp = torch.nextafter(w.abs(), torch.tensor(math.inf)) - w.abs()
                misses += int(((ema[name] - w).abs() > 4 * ulp + slack).sum())
        return misses

    ema_err = max((v - want['params_ema'][k]).abs().max().item()
                  for k, v in got['params_ema'].items() if v.is_floating_point())
    ema_moved = max((want['params_ema'][k] - v).abs().max().item()
                    for k, v in start.items() if v.is_floating_point())
    misses, stale, weights = (ema_misses(got['params_ema']), ema_misses(start),
                              ema_misses(want['params']))
    print(f'params_ema after {DIST_STEPS} steps (decay {decay}): largest difference {ema_err:.3e} '
          f'against an EMA that moved by at most {ema_moved:.3e}; entries beyond 4 ulps of the '
          f'weight + {slack:.1e}: {misses} (an EMA that never moved: {stale}; the weights '
          f'themselves: {weights})')
    if misses or not stale or not weights:
        fail('params_ema: the two ranks\' EMA is not one process\'s, or the check cannot tell '
             'a wrong one')
    two_ms = [[st['ms'] for st in r['runs'][0]['steps']] for r in ranks]
    one_ms = [st['ms'] for st in record['steps']]
    print(f'{card}: step times (CUDA events around optimize_parameters; step 1 includes the '
          'first calls\' set-up) ' + '; '.join(
              f'rank {i}: ' + ', '.join(f'{ms:.3f}' for ms in t) for i, t in enumerate(two_ms))
          + ' ms on two ranks sharing the card over gloo; one process at the global batch: '
          + ', '.join(f'{ms:.3f}' for ms in one_ms) + ' ms. These show the merge is right on '
          'the card; they are not a rate of the system.')
    return launches


# ------------------------------------------------ data parallel, two networks
DIST_MODEL_STEPS, DIST_MODEL_LR, DIST_MODEL_EMA = 2, 1e-3, 0.5
# the two ranks against one process: each network's first-step gradient
# within this share of its largest entry, and each tensor's move over the
# steps within this share of the network's largest move. Float32 alone
# takes ESRGAN's discriminator's first gradient 1.1e-2 of its largest entry
# from float64's at these widths (the two ranks' 3.7e-3; the CPU, both in
# the same run), the video GAN's 2e-3 at the tests' widths; a rank's own
# statistics move it further (the control run of ESRGAN must fail this).
DIST_MODEL_TOL = 3e-2


def dist_model_specs():
    """Phase 65's four jobs at the published widths, each from one seed:
    config, model type, rows a rank, the networks compared, and how each
    was cut (SGD at ``DIST_MODEL_LR`` for Adam, whose first step is the
    gradient's sign; EMA ``DIST_MODEL_EMA`` for 0.999, whose move would sit
    under float32's resolution of the weights; float32 for use_amp)."""
    sgd = {'type': 'SGD', 'lr': DIST_MODEL_LR}
    return [
        dict(name='esrgan', config=ESRGAN_TRAIN, rows=2, nets=['net_g', 'net_g_ema', 'net_d'],
             train=dict(optim_g=sgd, optim_d=sgd, ema_decay=DIST_MODEL_EMA),
             title='ESRGAN x4 (RRDBNet 64 x 23, VGGStyleDiscriminator 64, 9 synced BatchNorms; '
                   'GT 128)'),
        # the same on the ranks with each rank's own statistics and means: the
        # check must fail it
        dict(name='esrgan_control', config=ESRGAN_TRAIN, rows=2, nets=['net_g', 'net_d'],
             train=dict(optim_g=sgd, optim_d=sgd, ema_decay=DIST_MODEL_EMA), control=True,
             title='ESRGAN x4 with each rank\'s own statistics and means (a control)'),
        # R1 and the path length both on step 2; the stddev groups of 2 (the
        # published 4 does not divide the global batch of 6); Adam as
        # published with eps 1 in both runs (at 1e-8 its first step is the
        # gradient's sign, which float32 flips near 0)
        dict(name='stylegan2', config=STYLEGAN2_TRAIN, rows=3, nets=['net_g', 'net_g_ema', 'net_d'],
             train=dict(net_d_reg_every=2, net_g_reg_every=2), network_d=dict(stddev_group=2),
             adam_eps=1., title='StyleGAN2 256 Cmul2 (R1 and the path length on step 2, path '
                                'batch 3 split 2 + 1; stddev groups of 2)'),
        dict(name='videogan', config=GAN_VIDEO_TRAIN, rows=1, nets=['net_g', 'net_g_ema', 'net_d'],
             train=dict(optim_g=sgd, optim_d=sgd, ema_decay=DIST_MODEL_EMA),
             title='the video GAN (BasicVSR 64 x 30 on one 15-frame clip a rank, '
                   'VGGStyleDiscriminator 32 at 256; K8, K9)'),
        dict(name='joint', config=ALIGN_JOINT_TRAIN, rows=2, nets=['net_g', 'net_g_ema'],
             train=dict(optim_g=sgd, ema_decay=DIST_MODEL_EMA, use_amp=False),
             title='AlignJointDiffModel (GT 66, float32; K6, K7)')]


def dist_model_opt(spec):
    """The spec's config as a model's options: no datasets, the VGG of
    ``write_vgg19``, the spec's cuts."""
    from basicsr4rs_torch.utils.options import yaml_load
    opt = json.loads(json.dumps(yaml_load(spec['config'])))
    for key in ('datasets', 'logger', 'dist_params'):
        opt.pop(key, None)
    opt.update(num_gpu=1, is_train=True, manual_seed=0,
               path={'strict_load_g': True, 'strict_load_d': True})
    opt['train'].update(spec.get('train', {}))
    opt['network_d' if 'network_d' in opt else 'network_g'].update(spec.get('network_d', {}))
    if opt['train'].get('perceptual_opt'):
        opt['train']['perceptual_opt']['pretrain_path'] = VGG_WEIGHTS
    return opt


def dist_model_batches(spec, opt):
    """``DIST_MODEL_STEPS`` global batches of two ranks' rows on the host
    (smooth random images; the second rank's rows darker), with the
    replayed draws of StyleGAN2's steps or the joint model's timesteps and
    noise."""
    import numpy as np
    rng = np.random.RandomState(65)
    n = 2 * spec['rows']

    def images(count, h, w, low=0.):
        a = np.stack([smooth_image(rng, h, w) for _ in range(count)]).astype(np.float32) / 255.
        a[count // 2:] *= 0.6
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) * (1 - low) + low

    gen = torch.Generator().manual_seed(65)
    batches, draws = [], []
    for step in range(1, DIST_MODEL_STEPS + 1):
        if spec['name'].startswith('esrgan'):
            gt = images(n, 128, 128)
            batches.append({'gt': gt, 'lq': torch.nn.functional.interpolate(
                gt, scale_factor=0.25, mode='bicubic', antialias=True)})
        elif spec['name'] == 'videogan':
            gt = images(n * 15, 256, 256).view(n, 15, 3, 256, 256)
            lq = torch.nn.functional.interpolate(gt.flatten(0, 1), scale_factor=0.25,
                                                 mode='bicubic', antialias=True)
            batches.append({'gt': gt, 'lq': lq.view(n, 15, 3, 64, 64)})
        elif spec['name'] == 'stylegan2':
            batches.append({'gt': images(n, 256, 256) * 2 - 1})
            draws.append(stylegan2_global_draws(opt, n, step, gen))
        else:
            batches.append({'lq': {'rgb': images(n, 22, 22) * 2 - 1,
                                   'nss': images(n, 22, 22) * 2 - 1},
                            'gt': {'rgb': images(n, 66, 66) * 2 - 1,
                                   'nss': images(n, 33, 33) * 2 - 1},
                            'tt': torch.randint(0, opt['diffusion']['steps'], (n,), generator=gen),
                            'noise': torch.randn((n, 6, 64, 64), generator=gen)})
    path = os.path.join(DIST_DIR, f'{spec["name"]}_batches.pt')
    torch.save({'batches': batches, 'draws': draws}, path)
    return path


def stylegan2_global_draws(opt, n, step, gen):
    """One step's draws for ``n`` rows (``StyleGAN2Model.draw_step``'s keys):
    mixed codes on step 1, the path batch's on a regularised step."""
    g = opt['network_g']
    log_size = int(math.log2(g['out_size']))
    sizes = [2**((i + 5) // 2) for i in range((log_size - 2) * 2 + 1)]
    every = opt['train']['net_g_reg_every']

    def codes(rows):
        z1, z2 = torch.randn((2, rows, g['num_style_feat']), generator=gen)
        return [z1, z2 if step == 1 else z1]

    def maps(rows):
        return [torch.randn((rows, 1, s, s), generator=gen) for s in sizes]

    draw = {'d_codes': codes(n), 'd_noise': maps(n), 'g_codes': codes(n), 'g_noise': maps(n)}
    if step % every == 0:
        rows = max(1, n // opt['train'].get('path_batch_shrink', 2))
        draw.update(path_codes=codes(rows), path_noise=maps(rows),
                    path_proj=torch.randn((rows, 3, g['out_size'], g['out_size']), generator=gen))
    return draw


def split_rows(n, rank, world_size):
    """The rows ``[start, stop)`` of ``n`` that ``rank`` takes (the first
    ``n % world_size`` ranks one more)."""
    base, extra = divmod(n, world_size)
    start = rank * base + min(rank, extra)
    return start, start + base + int(rank < extra)


def rank_batch(value, rank, world_size, device):
    if isinstance(value, dict):
        return {k: rank_batch(v, rank, world_size, device) for k, v in value.items()}
    start, stop = split_rows(len(value), rank, world_size)
    return value[start:stop].to(device)


def dist_model_steps(spec, rank, world_size):
    """One job of phase 65 in this process (a rank of the group, or the one
    process at the global batch): the model built from ``spec``'s seed (a
    rank other than 0 from another seed, which rank 0's broadcast must
    replace), ``DIST_MODEL_STEPS`` steps on its rows timed by CUDA events
    around ``optimize_parameters``, the gradient exchange's time, the
    gradients each optimizer was handed on step 1, K6 to K9's launches, the
    logged losses, and the networks before and after."""
    from basicsr4rs_torch.models import base_model, build_model
    from basicsr4rs_torch.models.base_model import BaseModel
    from basicsr4rs_torch.models.stylegan2_model import StyleGAN2Model
    opt = dist_model_opt(spec)
    opt.update(dist=world_size > 1, rank=rank, world_size=world_size)
    data = torch.load(spec['batches'], weights_only=False)
    wrappers = {**attention_wrappers(), **sampler_wrappers()}
    patches = contextlib.ExitStack()
    if spec.get('control'):   # the sum over the ranks of statistics and means: none
        from basicsr4rs_torch.utils import dist_util
        patches.enter_context(mock.patch.object(dist_util._SumOverRanks, 'apply', lambda t: t))
    if spec.get('adam_eps'):
        get_optimizer = BaseModel.get_optimizer
        patches.enter_context(mock.patch.object(
            BaseModel, 'get_optimizer', lambda self, kind, params, lr, **kw: get_optimizer(
                self, kind, params, lr, eps=spec['adam_eps'], **kw)))
    if data['draws']:
        draws = iter(data['draws'])

        def draw_step(model, batch, regularize_g):
            step = next(draws)
            out = {k: [t[rank * batch:(rank + 1) * batch].cuda() for t in step[k]]
                   for k in ('d_codes', 'd_noise', 'g_codes', 'g_noise')}
            if regularize_g:
                start, stop = split_rows(len(step['path_proj']), rank, world_size)
                if stop - start != model.path_rows(batch):
                    fail(f'rank {rank}: {model.path_rows(batch)} path rows, expected '
                         f'{stop - start}')
                out.update({k: [t[start:stop].cuda() for t in step[k]]
                            for k in ('path_codes', 'path_noise')},
                           path_proj=step['path_proj'][start:stop].cuda())
            return out
        patches.enter_context(mock.patch.object(StyleGAN2Model, 'draw_step', draw_step))
    exchange_ms = []
    average = base_model._average_gradients

    def timed_average(*nets):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(*nets)
        torch.cuda.synchronize()
        exchange_ms.append(1e3 * (time.perf_counter() - t0))
    patches.enter_context(mock.patch.object(base_model, '_average_gradients', timed_average))
    with patches:
        torch.manual_seed(1000 + rank)
        model = build_model(opt)
        nets = {label: model.get_bare_model(getattr(model, label)) for label in spec['nets']}
        before = {label: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                  for label, net in nets.items()}
        names = {p: f'{label}.{k}' for label, net in nets.items() if label != 'net_g_ema'
                 for k, p in net.named_parameters()}
        grads = {}

        def keep(optimizer, args, kwargs):
            if not steps:
                grads.update({names[p]: p.grad.detach().cpu().clone()
                              for group in optimizer.param_groups for p in group['params']
                              if p.grad is not None})
        for optimizer in model.optimizers:
            optimizer.register_step_pre_hook(keep)
        for wr in wrappers.values():
            wr.launches = 0
        steps = []
        for step, batch in enumerate(data['batches'], 1):
            model.feed_data(rank_batch(batch, rank, world_size, model.device))
            exchange_ms.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model.optimize_parameters(step)
            end.record()
            torch.cuda.synchronize()
            steps.append({'ms': start.elapsed_time(end), 'exchange_ms': sum(exchange_ms),
                          'losses': model.get_current_log()})
    launches = {k: wr.launches for k, wr in wrappers.items()}
    after = {label: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
             for label, net in nets.items()}
    result = {'steps': steps, 'launches': launches, 'grads': grads, 'before': before,
              'after': after, 'wrapped': {label: type(getattr(model, label)).__name__
                                          for label in nets},
              'mean_path_length': float(getattr(model, 'mean_path_length', 0.))}
    if world_size > 1:   # every rank holds rank 0's weights: its largest difference from them
        import torch.distributed as dist
        flat = torch.cat([v.double().reshape(-1).cuda() for state in after.values()
                          for v in state.values()])
        mine = flat.clone()
        dist.broadcast(flat, 0)
        spread = (mine - flat).abs().max().reshape(1)
        dist.all_reduce(spread, op=dist.ReduceOp.MAX)
        result['rank_spread'] = spread.item()
    del model, nets
    torch.cuda.empty_cache()
    return result


def dist_models_rank(job):
    """The ranks' side of phase 65: each job of ``job['models']`` in turn;
    rank 0 saves the runs, every rank its times and launches."""
    from basicsr4rs_torch.utils.dist_util import get_dist_info, init_dist
    init_dist('pytorch', 'gloo')   # the card rank % count: both share cuda:0
    rank, world_size = get_dist_info()
    runs = {}
    for spec in job['models']:
        runs[spec['name']] = dist_model_steps(spec, rank, world_size)
    if rank == 0:
        torch.save(runs, f'{job["out"]}.runs.pt')
    return {name: {'steps': run['steps'], 'launches': run['launches']}
            for name, run in runs.items()}


def dist_model_errors(spec, two, one):
    """Each network's largest difference of the two ranks from one process:
    (its step 1 gradient's, against the largest gradient entry; its move's
    over the steps, against the largest move)."""
    worst = {}
    for key, want in one['grads'].items():
        net = key.split('.')[0]
        err, big = worst.get(net, (0., 0.))
        worst[net] = (max(err, (two['grads'][key] - want).abs().max().item()),
                      max(big, want.abs().max().item()))
    out = {}
    for label in spec['nets']:
        moved = err = 0.
        for k, v in one['after'][label].items():
            if v.is_floating_point():
                moved = max(moved, (v - one['before'][label][k]).abs().max().item())
                err = max(err, (two['after'][label][k] - v).abs().max().item())
        out[label] = {'move': (err, moved), 'grad': worst.get(label)}
    return out


def dist_model_misses(errors):
    return [f'{label} {kind}' for label, e in errors.items() for kind in ('grad', 'move')
            if e[kind] is not None and not e[kind][0] <= DIST_MODEL_TOL * e[kind][1]]


def dist_model_check(spec, two, one, card, number):
    """One job of phase 65: the two ranks (rank 0's run, the ranks' spread)
    against the one process at the global batch."""
    phase(f'65{number}. {spec["title"]}: two ranks of {spec["rows"]} rows against one process '
          f'of {2 * spec["rows"]}, {DIST_MODEL_STEPS} steps')
    print(f'networks on the ranks: {two["wrapped"]}; largest difference between the ranks\' '
          f'weights and buffers after the steps {two["rank_spread"]:.3e}')
    if two['rank_spread'] != 0 and not spec.get('control'):   # the control's own statistics
        fail('the ranks hold different weights')
    errors = dist_model_errors(spec, two, one)
    for label, e in errors.items():
        line = (f'{label}: largest move {e["move"][1]:.3e}, two ranks against one process '
                f'{e["move"][0]:.3e} ({e["move"][0] / max(e["move"][1], 1e-30):.2e} of it)')
        if e['grad']:
            line += (f'; step 1 gradients differ by {e["grad"][0]:.3e} of a largest '
                     f'{e["grad"][1]:.3e} ({e["grad"][0] / e["grad"][1]:.2e})')
        print(line)
    misses = dist_model_misses(errors)
    if spec.get('control'):
        print(f'beyond DIST_MODEL_TOL {DIST_MODEL_TOL}: {misses} (the control must be)')
        if not misses:
            fail('the check cannot tell each rank\'s own statistics from the global batch\'s')
        return
    if misses or any(not e['move'][1] > 0 for e in errors.values()):
        fail(f'{misses}: the two ranks do not train as one process at the global batch '
             f'(DIST_MODEL_TOL {DIST_MODEL_TOL})')
    for i, (got, want) in enumerate(zip(two['steps'], one['steps']), 1):
        print(f'step {i}: ' + ', '.join(f'{k} {v:.6g} ({want["losses"][k]:.6g})'
                                        for k, v in got['losses'].items())
              + ' (two ranks\' mean; one process in brackets)')
        for k, v in got['losses'].items():
            w = want['losses'][k]
            if not (math.isfinite(v) and abs(v - w) <= 1e-3 * abs(w) + 1e-5):
                fail(f'step {i}: {k} {v} on two ranks, {w} in one process')
    if spec['name'] == 'stylegan2':
        got, want = two['mean_path_length'], one['mean_path_length']
        print(f'mean_path_length {got:.6f} on the ranks, {want:.6f} in one process')
        if not (want > 0 and abs(got - want) <= 1e-3 * want):
            fail('mean_path_length is not one process\'s')
    print(f'{card}: step times (CUDA events around optimize_parameters; step 1 includes the '
          'first calls\' set-up) rank 0 ' + ', '.join(f'{st["ms"]:.3f}' for st in two['steps'])
          + ' ms, of which the gradient exchange (host clock, synchronised) '
          + ', '.join(f'{st["exchange_ms"]:.3f}' for st in two['steps'])
          + ' ms, on two ranks sharing the card over gloo; one process at the global batch '
          + ', '.join(f'{st["ms"]:.3f}' for st in one['steps']) + ' ms')


def dist_two_networks(ranks, wall, card):
    """Phase 65: the four jobs on two gloo ranks sharing the card, then each
    in this process at the global batch; K6 to K9's launches of both."""
    phase('65. data parallel, two networks: ESRGAN, StyleGAN2, the video GAN and the joint '
          'align model on two ranks sharing the card over gloo, each against one process at '
          'the global batch')
    print(f'torchrun wall time {wall:.3f} s (two processes on cuda:0, gloo)')
    two = torch.load(os.path.join(DIST_DIR, 'two_networks.runs.pt'), weights_only=False)
    launches = collections.Counter()
    for r in ranks:
        for name, run in r['runs'].items():
            print(f'rank {r["rank"]}, {name}: launches ' + ' '.join(
                f'{k}={v}' for k, v in run['launches'].items() if v))
            launches.update(run['launches'])
    one = None
    for number, spec in zip('abcde', dist_model_specs()):
        spec['batches'] = os.path.join(DIST_DIR, f'{spec["name"].split("_")[0]}_batches.pt')
        if not spec.get('control'):   # the control is held against the job before it
            one = dist_model_steps(spec, 0, 1)
            launches.update(one['launches'])
        dist_model_check(spec, two[spec['name']], one, card, number)
    for name, wanted in (('videogan', ('deform_sample_fwd', 'deform_sample_bwd')),
                         ('joint', ('window_attention_fwd', 'window_attention_bwd'))):
        for r in ranks:
            missing = [k for k in wanted if not r['runs'][name]['launches'][k]]
            if missing:
                fail(f'rank {r["rank"]}, {name}: {missing} never launched')
    return dict(launches)


def two_networks_inputs():
    """Phase 65's batches (and StyleGAN2's draws, the joint model's noise)
    and the job every rank runs."""
    write_vgg19()
    specs = []
    for spec in dist_model_specs():
        spec['batches'] = (specs[-1]['batches'] if spec.get('control')
                           else dist_model_batches(spec, dist_model_opt(spec)))
        specs.append(spec)
    return specs


def dist_paths(launches, split_step_ms, card):
    """Phases 63, 64 and 65, their kernel launches added to ``launches``. The
    three launchers start together, so that their processes' set-up
    (imports, CUDA, the process groups) overlaps; the card trains one phase
    at a time: 64's two ranks, then 63's rank, then 64's one process, then
    65's two ranks and its one-process runs."""
    t0 = time.perf_counter()
    phase('63, 64, 65. the data-parallel launchers start: one rank on NCCL, two ranks on gloo, '
          'two ranks on gloo with two networks')
    init, two, one = two_ranks_inputs()
    specs = two_networks_inputs()
    markers = [os.path.join(DIST_DIR, f'{name}.done') for name in ('two_ranks', 'models_ready')]
    for marker in markers:
        if os.path.exists(marker):
            os.remove(marker)
    two_run = start_torchrun(2, two, [['--launcher', 'pytorch']],
                             os.path.join(DIST_DIR, 'two_ranks'), done=markers[0])
    one_run = start_torchrun(1, TRAIN_CONFIG, one_rank_argv(), os.path.join(DIST_DIR, 'one_rank'),
                             after=markers[0])
    models_run = start_torchrun(2, None, None, os.path.join(DIST_DIR, 'two_networks'),
                                after=markers[1], models=specs)
    two_ranks, two_wall = finish_torchrun(two_run, others=[one_run, models_run])
    one_rank, one_wall = finish_torchrun(one_run, others=[models_run])
    for counts in (dist_one_rank(one_rank, one_wall, split_step_ms, card),
                   dist_two_ranks(two_ranks, two_wall, init, one, card)):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    print(f'phases 63 and 64: {time.perf_counter() - t0:.1f} s')
    t1 = time.perf_counter()
    open(markers[1], 'w').close()
    model_ranks, models_wall = finish_torchrun(models_run)
    for name, count in dist_two_networks(model_ranks, models_wall, card).items():
        launches[name] = launches.get(name, 0) + count
    print(f'phase 65: {time.perf_counter() - t1:.1f} s after phase 64 (its ranks\' set-up '
          f'overlapped 63 and 64); phases 63 to 65: {time.perf_counter() - t0:.1f} s')


# ------------------------------------------------------- the spatial axis
# phase 72: basicsr4rs_torch.train under torchrun --launcher pytorch with
# parallel: {data: 1, spatial: 2}, on two gloo ranks sharing the card,
# against the same pipeline in one process: SwinIR-M x4 3 SGD steps at B=4,
# GT 256 (LQ bands of 32 rows, four window rows) through the CUDA
# prefetcher, MSRResNet x4 one step at its config's batch and GT; each then
# validates one LQ tile of 256x256 (bands of 128 rows)
SPATIAL_STEPS, SPATIAL_BATCH, SPATIAL_GT, SPATIAL_EVAL_LQ = 3, 4, 256, 256
SPATIAL_TRAIN_IMAGES = 16   # the larger of SwinIR's 3 x 4 and MSRResNet's batch
SPATIAL_OUT = os.path.join(DIST_DIR, 'spatial')
SPATIAL_DATA_DIR = 'datasets/spatial_x4'


def spatial_specs():
    """Phase 72's two models: name, config, steps, batch, GT size, SGD's
    rate and the prefetcher."""
    from basicsr4rs_torch.utils.options import yaml_load
    ms = yaml_load(MS_TRAIN_CONFIG)['datasets']['train']
    # MSRResNet's convolutions start at a tenth of the Kaiming scale: at
    # phase 64's rate its largest step (9e-6) is near the float32 resolution
    # of its weights, which the step rule would read as disagreement
    return [{'name': 'swinir', 'config': TRAIN_CONFIG, 'steps': SPATIAL_STEPS,
             'batch': SPATIAL_BATCH, 'gt': SPATIAL_GT, 'lr': DIST_LR, 'prefetch': 'cuda'},
            {'name': 'msrresnet', 'config': MS_TRAIN_CONFIG, 'steps': 1,
             'batch': ms['batch_size_per_gpu'], 'gt': ms['gt_size'], 'lr': 1., 'prefetch': None}]


def spatial_config(spec, init, parallel):
    """A phase 72 training config: the spec's file on phase 72's data, from
    ``init``, SGD at a constant rate for the spec's steps with a checkpoint
    after them, one validation after the loop, and ``parallel`` where given
    (the ranks over gloo); the one process's loader without threads, so
    that its draws come in the ranks' order (``train.py`` runs a spatial
    group's loader without threads)."""
    import yaml

    from basicsr4rs_torch.utils.options import yaml_load
    opt = json.loads(json.dumps(yaml_load(spec['config'])))
    opt['name'] = f'chip_smoke_spatial_{spec["name"]}_{"two_ranks" if parallel else "one_process"}'
    opt['dist_params'] = {'backend': 'gloo'}
    opt['datasets']['train'].update(
        dataroot_gt=f'{SPATIAL_DATA_DIR}/GT', dataroot_lq=f'{SPATIAL_DATA_DIR}/LQ',
        gt_size=spec['gt'], batch_size_per_gpu=spec['batch'], prefetch_mode=spec['prefetch'])
    if not parallel:
        opt['datasets']['train']['num_worker_per_gpu'] = 0
    opt['datasets']['val'].update(dataroot_gt=f'{SPATIAL_DATA_DIR}/val_GT',
                                  dataroot_lq=f'{SPATIAL_DATA_DIR}/val_LQ')
    opt['path'].update(pretrain_network_g=init)
    opt['train'].update(total_iter=spec['steps'], optim_g={'type': 'SGD', 'lr': spec['lr']},
                        scheduler={'type': 'ConstantLR'})
    opt['val']['val_freq'] = 1000
    opt['logger']['save_checkpoint_freq'] = spec['steps']
    if parallel:
        opt['parallel'] = parallel
    path = os.path.join(DIST_DIR, f'{opt["name"]}.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    shutil.rmtree(os.path.join('experiments', opt['name']), ignore_errors=True)
    return path


def spatial_inputs():
    """Phase 72's data (16 GT 256x256 pairs: SwinIR's crop is the whole GT,
    MSRResNet's a draw; one validation pair of LQ 256x256), each model's
    init ``.pth`` (from a seed) and its two configs; the specs with their
    paths."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    os.makedirs(DIST_DIR, exist_ok=True)
    write_pairs(SPATIAL_DATA_DIR, 72, [('GT', 'LQ', SPATIAL_TRAIN_IMAGES, SPATIAL_GT),
                                       ('val_GT', 'val_LQ', 1, SCALE * SPATIAL_EVAL_LQ)])
    specs = spatial_specs()
    for spec in specs:
        torch.manual_seed(9)
        spec['init'] = f'{SPATIAL_OUT}.{spec["name"]}.init.pth'
        net = build_network(dict(yaml_load(spec['config'])['network_g']))
        torch.save({'params': net.state_dict()}, spec['init'])
        spec['two'] = spatial_config(spec, spec['init'], {'data': 1, 'spatial': 2})
        spec['one'] = spatial_config(spec, spec['init'], None)
    return specs


def check_spatial_run(name, who, run, spec, blocks, rows):
    """A phase 72 run of one side: the bare network on cuda:0, its steps
    (K2 to K5 a block each, on ``rows`` LQ rows), one validation image (K1 a
    block)."""
    check_dist_steps(run['steps'], range(1, spec['steps'] + 1), blocks, f'{name} {who}')
    if run['net'] in ('DistributedDataParallel', 'DataParallel') or run['device'] != 'cuda:0':
        fail(f'{name} {who} trained {run["net"]} on {run["device"]}')
    if [st['lq_rows'] for st in run['steps']] != [rows] * spec['steps']:
        fail(f'{name} {who}: trained on {[st["lq_rows"] for st in run["steps"]]} LQ rows, '
             f'expected {rows} a step')
    if len(run['tests']) != 1 or run['tests'][0]['launches']['swin_block_joint_fwd'] != blocks:
        fail(f'{name} {who}: {len(run["tests"])} validation images, launches '
             f'{[t["launches"] for t in run["tests"]]}; expected one of {blocks} K1 launches')


def spatial_paths(ranks, wall, specs, card):
    """Phase 72: each model's pipeline on the two ranks against one process,
    from one ``.pth`` on the same items: steps, losses, the checkpoint's
    parameters, the validation's gathered output and metric; K1 to K5's
    launches of both sides."""
    phase('72. the spatial axis: basicsr4rs_torch.train --launcher pytorch with parallel: {data: '
          '1, spatial: 2} on two gloo ranks sharing the card, against one process: SwinIR-M x4 '
          f'{SPATIAL_STEPS} SGD steps (B={SPATIAL_BATCH}, GT {SPATIAL_GT}: LQ bands of '
          f'{SPATIAL_GT // SCALE // 2} rows), MSRResNet x4 one step, each then a validation of '
          f'an LQ tile of {SPATIAL_EVAL_LQ}x{SPATIAL_EVAL_LQ}')
    from basicsr4rs_torch.utils.options import yaml_load
    t0 = time.perf_counter()
    print(f'torchrun wall time {wall:.3f} s from its start (two processes on cuda:0, gloo; the '
          'halos staged through the host)')
    launches = collections.Counter()
    atol, rtol = F32_TOL
    for i, spec in enumerate(specs):
        name = spec['name']
        net_opt = yaml_load(spec['config'])['network_g']
        blocks = sum(net_opt['depths']) if net_opt['type'] == 'SwinIR' else 0
        wrappers = training_kernels()
        for wr in wrappers.values():
            wr.launches = 0
        record = {'steps': []}
        model = run_train_pipeline([], record, config=spec['one'],
                                   model_cls=model_class(spec['one']),
                                   before_first_step=lambda *_: None, after_step=lq_rows,
                                   record_tests=True)
        torch.cuda.synchronize()
        one = {'steps': record['steps'], 'tests': record['tests'],
               'net': type(model.net_g).__name__, 'device': str(model.device),
               'metrics': {k: float(v) for k, v in model.metric_results.items()}}
        del model
        launches.update({k: wr.launches for k, wr in wrappers.items()})
        check_spatial_run(name, 'one process', one, spec, blocks, spec['gt'] // SCALE)
        for r in ranks:
            run = r['runs'][i]
            check_spatial_run(name, f'rank {r["rank"]}', run, spec, blocks,
                              spec['gt'] // SCALE // 2)
            if run['net'] != one['net']:
                fail(f'{name} rank {r["rank"]} trained {run["net"]}, one process {one["net"]}')
            launches.update(run['launches'])
        for got, want in zip(ranks[0]['runs'][i]['steps'], one['steps']):
            print(f'{name} step {got["iter"]}: l_pix {got["l_pix"]:.6f} (the ranks\' mean) '
                  f'against {want["l_pix"]:.6f} (one process)')
            if not abs(got['l_pix'] - want['l_pix']) <= 1e-4 * abs(want['l_pix']):
                fail(f'{name}: the two bands\' loss is not one process\'s')
        start = torch.load(spec['init'], map_location='cpu', weights_only=True)['params']
        pth = f'net_g_{spec["steps"]}.pth'
        params = [torch.load(os.path.join('experiments', yaml_load(config)['name'], 'models',
                                          pth), map_location='cpu', weights_only=True)['params']
                  for config in (spec['two'], spec['one'])]
        params_agree(f'{name} after {spec["steps"]} step(s)', 'the two bands', *params, start)
        want = one['tests'][0]
        for r in ranks:
            test = r['runs'][i]['tests'][0]
            out = torch.load(f'{SPATIAL_OUT}.run{i}.rank{r["rank"]}.val.pt', weights_only=True)[0]
            err = (out - want['output']).abs()
            held = bool((err <= atol + rtol * want['output'].abs()).all())
            print(f'{name} validation, rank {r["rank"]}: its output (the bands gathered) against '
                  f'one process, largest difference {err.max().item():.3e} (F32_TOL elementwise: '
                  f'{"held" if held else "BROKEN"}); on bands {test["on_bands"]}, one process '
                  f'{want["on_bands"]}; {card}: {test["ms"]:.3f} ms, peak {test["peak_mib"]:.1f} '
                  'MiB above the call\'s start, K1 '
                  f'{test["launches"]["swin_block_joint_fwd"]}; one process {want["ms"]:.3f} ms, '
                  f'peak {want["peak_mib"]:.1f} MiB, K1 '
                  f'{want["launches"]["swin_block_joint_fwd"]}')
            if not (held and test['on_bands'] == [True] and want['on_bands'] == [False]):
                fail(f'{name}: the validation on bands is not one process\'s forward')
            got_metric = r['runs'][i]['metrics']
            print(f'{name} validation, rank {r["rank"]}: merged {got_metric} against one process '
                  f'{one["metrics"]}')
            if got_metric.keys() != one['metrics'].keys() or any(
                    not abs(v - one['metrics'][k]) <= 1e-3 * abs(one['metrics'][k])
                    for k, v in got_metric.items()):
                fail(f'{name}: the merged metric is not one process\'s')
        print(f'{name} steps (CUDA events around optimize_parameters): ' + '; '.join(
            f'rank {r["rank"]} ' + ', '.join(f'{st["ms"]:.3f}' for st in r['runs'][i]['steps'])
            for r in ranks) + ' ms; one process ' + ', '.join(
            f'{st["ms"]:.3f}' for st in one['steps']) + ' ms')
    print(f'{card}: two ranks sharing one card over gloo show that the bands compute the one '
          'process\'s function and what each rank holds; their times are not a rate of the '
          f'system ({time.perf_counter() - t0:.1f} s after the ranks ended)')
    return dict(launches)


def start_spatial(after=None):
    """Phase 72's inputs and its torchrun of two ranks, each running both
    models' pipelines (``after``: see ``dist_rank``); what ``finish_spatial``
    takes."""
    specs = spatial_inputs()
    run = start_torchrun(2, None, [['--launcher', 'pytorch']] * len(specs), SPATIAL_OUT,
                         after=after, configs=[spec['two'] for spec in specs],
                         record_tests=True)
    run['specs'] = specs
    return run


def finish_spatial(run, card):
    """Phase 72: wait for its ranks, then check them against one process."""
    t0 = time.perf_counter()
    ranks, wall = finish_torchrun(run)
    launches = spatial_paths(ranks, wall, run['specs'], card)
    print(f'phase 72: {time.perf_counter() - t0:.1f} s from the wait for its ranks to its end')
    return launches


def device_time_by_group(prof, ours):
    """(rows, groups, busy ms) of a ``torch.profiler`` trace: every device
    kernel and memory operation as (name, ms, count), and their sums by
    group: each of our kernels (``ours``, names that a kernel's name holds,
    or {group: such a name}, the first that matches), cuDNN convolutions,
    GroupNorm, library GEMMs, memory operations, the rest."""
    from torch.autograd import DeviceType
    # kernels and memory operations only: a host annotation (Optimizer.step#...)
    # also shows on the device timeline, over the kernels it spans; the spin
    # kernels are profile_device_time's pad
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and '#' not in e.key and 'spin_kernel' not in e.key]
    groups = {}
    ours = ours if isinstance(ours, dict) else {k: k for k in ours}
    for key, ms, count in rows:
        group = next((k for k, needle in ours.items() if needle in key), None)
        if group is None:
            low = key.lower()
            group = ('memset / memcpy' if low.startswith('mem') else
                     'convolutions (cuDNN)' if any(w in low for w in (
                         'cudnn', 'conv', 'fprop', 'wgrad', 'dgrad', 'winograd', 'nchw', 'nhwc',
                         'fft', 'cf32', 'pointwise_mult_and_sum'))
                     else 'GroupNorm' if any(w in low for w in (
                         'groupnorm', 'group_norm', 'rowwisemoments', 'computefusedparams',
                         'computeinternalgradients', 'gammabeta'))
                     else 'GEMMs (cuBLAS: Linear layers)' if any(w in low for w in (
                         'gemm', 'cublas', 'cutlass'))
                     else 'other PyTorch kernels')
        total, n = groups.get(group, (0., 0))
        groups[group] = (total + ms, n + count)
    return rows, groups, sum(ms for _, ms, _ in rows)


def print_device_time(rows, groups, busy_ms, window_ms, units, unit):
    print(f'{units} {unit}s: {window_ms / units:.3f} ms a {unit} by CUDA events (profiler on), '
          f'device busy {busy_ms / units:.3f} ms a {unit} = {100 * busy_ms / window_ms:.1f}% of '
          'the window')
    for group, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f'  {ms / units:8.3f} ms a {unit}  {100 * ms / busy_ms:5.1f}%  {count // units:5d} '
              f'launches a {unit}  {group}')
    print('  the 8 longest kernels:')
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f'  {ms / units:8.3f} ms a {unit}  {count // units:5d} x  {key[:90]}')


def profile_device_time(run, units, unit, ours, json_name):
    """Where the device time of ``units`` calls of ``run`` goes, under
    ``torch.profiler``: summed by group, printed, and written to
    ``results/chip_smoke/<json_name>``. Reported, not required: a profiler
    that sees no device time only says so. Returns the groups as
    {name: (ms, launches)} over all units, or None.

    The device's activity alone is traced. Late in a long process the trace
    loses the first device records of a session (the count grows with the
    process's age, and an idle gap after the profiler starts does not keep
    them), so each session opens with ``PROFILE_PAD`` spin kernels that the
    sums leave out, and the window starts once they have run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD[0]):
            torch.cuda._sleep(PROFILE_PAD[1])
        torch.cuda.synchronize()
        start.record()
        for _ in range(units):
            run()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    rows, groups, busy_ms = device_time_by_group(prof, ours)
    if busy_ms == 0:
        print('the profiler recorded no device time')
        return None
    print_device_time(rows, groups, busy_ms, window_ms, units, unit)
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, json_name), 'w') as f:
        json.dump({unit + 's': units, 'window_ms': window_ms, 'device_busy_ms': busy_ms,
                   'groups': {k: {'ms': v[0], 'launches': v[1]} for k, v in groups.items()},
                   'kernels': [{'name': k, 'ms': ms, 'launches': n} for k, ms, n in rows]}, f)
    return groups


def profile_training_steps(model, batch, steps=3):
    """Three SwinIR training steps on a fixed batch, device time by kernel."""
    phase(f'6b. device time of {steps} training steps by kernel (torch.profiler)')
    model.lq, model.gt = batch
    for _ in range(2):
        model.optimize_parameters(0)
    # K2's two launches by their kernels' names; the last: K3's and K5's LayerNorm launch
    ours = ('swin_attn_fwd_head', 'swin_attn_fwd_proj', 'swin_attn_block_bwd', 'mlp_block_fwd',
            'mlp_block_bwd', 'swin_block_joint_fwd', 'branch_ln_bwd')
    profile_device_time(lambda: model.optimize_parameters(0), steps, 'step', ours,
                        'train_step_profile.json')


def compare_gradients(what, loss_k, grads_k, loss_p, grads_p, scale='tensor',
                      names=('kernels', 'plain')):
    """Hold one batch's loss and parameter gradients through the kernels
    against those through the plain versions: each gradient within
    GRAD_TOLERANCE of the plain one's largest entry (``scale='tensor'``),
    or of the largest entry of the network's whole plain gradient
    (``'network'``: the recurrent video networks, whose SpyNet gradients
    pass through every warp of the clip after them; the per-tensor figure
    is printed beside it)."""
    largest = max(g.abs().max().item() for g in grads_p.values())
    floor = 1e-6 * largest
    worst, worst_name, worst_net = 0., '', 0.
    for name, g in grads_p.items():
        if not torch.isfinite(grads_k[name]).all():
            fail(f'non-finite gradient of {name}')
        diff = (grads_k[name] - g).abs().max().item()
        rel = diff / max(g.abs().max().item(), floor)
        worst_net = max(worst_net, diff / largest)
        if rel > worst:
            worst, worst_name = rel, name
    held = worst if scale == 'tensor' else worst_net
    print(f'loss {loss_k:.7f} ({names[0]}) vs {loss_p:.7f} ({names[1]}); {len(grads_p)} parameter '
          f'gradients, largest max|difference| / max|{names[1]}| of the tensor: {worst:.3e} at '
          f'{worst_name}; of the network: {worst_net:.3e} (tolerance {GRAD_TOLERANCE} '
          f'{"a tensor" if scale == "tensor" else "of the network"})')
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or held > GRAD_TOLERANCE:
        fail(f'{what}: loss or gradients disagree between {names[0]} and {names[1]}')


def check_model_gradients(number='7', config=TRAIN_CONFIG, lq_shape=(4, 3, 48, 48)):
    """One training batch of the SwinIR of ``config`` forward and backward
    through the kernels and through their plain versions, in float32, with
    the same DropPath masks: the output, the loss and every parameter's
    gradient."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.utils.options import yaml_load
    net_opt = dict(yaml_load(config)['network_g'])
    net_opt.pop('type')
    b, c, h, w = lq_shape
    phase(f'{number}. whole model, forward and backward: kernels vs plain versions, one training '
          f'batch ({os.path.basename(config)}: {b} x {c} x {h}x{w})')
    net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0)).cuda().train()
    gen = torch.Generator().manual_seed(2)
    scale = net_opt['upscale']
    lq = torch.rand(lq_shape, generator=gen).cuda()
    gt = torch.rand(b, c, scale * h, scale * w, generator=gen).cuda()

    def loss_and_grads():
        net.seed_drop_path(123, 'cuda')   # the same DropPath masks in both runs
        net.zero_grad(set_to_none=True)
        out = net(lq)
        loss = (out - gt).abs().mean()
        loss.backward()
        return out.detach(), loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    out_k, loss_k, grads_k = loss_and_grads()
    plain = [(S, 'swin_attn_block_forward', S.reference_swin_attn_block),
             (S, 'swin_attn_block_backward', S.reference_swin_attn_block_backward),
             (M, 'mlp_block_forward', M.reference_mlp_block),
             (M, 'mlp_block_backward', M.reference_mlp_block_backward)]
    counts = {k: wr.launches for k, wr in training_kernels().items()}
    patches = [mock.patch.object(mod, name, fn) for mod, name, fn in plain]
    for p in patches:
        p.start()
    try:
        out_p, loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    if counts != {k: wr.launches for k, wr in training_kernels().items()}:
        fail('the plain run launched a kernel')
    err = (out_k - out_p).abs().max().item()
    print(f'output {tuple(out_k.shape)}: max abs difference {err:.3e} (max|plain| '
          f'{out_p.abs().max().item():.3e}; tolerance {MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('whole-model outputs disagree between kernels and plain versions')
    compare_gradients(os.path.basename(config), loss_k, grads_k, loss_p, grads_p)
    del net, grads_k, grads_p


# ------------------------------------------------------------------ ResShift
RS_CONFIG = 'options/test/ResShift/test_ResShift_x4_synthetic.yml'
RS_TRAIN_CONFIG = 'options/train/ResShift/train_ResShift_x4_synthetic.yml'
RS_DATA_DIR = 'datasets/ResShift_x4_synthetic'
RS_REQUESTS, RS_LQ, RS_TRAIN_IMAGES = 4, 64, 32
RS_LAYERS = 9   # Swin layers of the UNet: four down, the middle one, four up
RS_AMP_ITERS = 2
# kernels vs plain versions through 15 reverse steps, on the latent and on the
# [-1, 1] image: float32 sums in another order through 270 attention calls
RS_SAMPLE_TOLERANCE = 1e-3


def attention_wrappers():
    from basicsr4rs_torch.ops import window_attention as A
    return {'window_attention_fwd': A.window_attention_forward,
            'window_attention_bwd': A.window_attention_backward}


def attention_dtype_spies():
    """The attention kernels' wrappers, and patches that count the dtype
    each launch is made in."""
    from basicsr4rs_torch.ops import window_attention as A
    dtypes = collections.Counter()
    spies = []
    for attr in ('_launch_forward', '_launch_backward'):
        def spy(qkv, *args, _inner=getattr(A, attr), _attr=attr):
            dtypes[(_attr, str(qkv.dtype))] += 1
            return _inner(qkv, *args)
        spies.append(mock.patch.object(A, attr, spy))
    return attention_wrappers(), dtypes, spies


def resshift_options(config):
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(config)
    steps = opt['diffusion']['steps']
    per_forward = RS_LAYERS * opt['network_g']['swin_depth']
    return opt, steps, per_forward


def random_resshift_weights(opt, seed=0):
    """(UNet, first stage) with random weights made from ``seed`` and every
    parameter non-zero: the zero-initialised convolutions, which make a fresh
    UNet answer 0 to everything, get the other convolutions' init, and the
    codebook is spread over the latents' range ([-1, 1]) instead of the
    init's +-1/8192, so that the decoded image depends on the latent."""
    from basicsr4rs_torch.archs.arch_util import default_conv_init_
    from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
    from basicsr4rs_torch.archs.unet_arch import UNetModelSwin
    gen = torch.Generator().manual_seed(seed)
    net = UNetModelSwin(**{k: v for k, v in opt['network_g'].items() if k != 'type'},
                        generator=gen)
    with torch.no_grad():
        for m in net.modules():
            if getattr(m, 'zero_init', False):
                default_conv_init_(m, gen)
    stage = VQModelTorch(**{k: v for k, v in opt['autoencoder'].items() if k != 'type'},
                         generator=gen)
    with torch.no_grad():
        stage.quantize.embedding.weight.uniform_(-1., 1., generator=gen)
    return net, stage


def write_resshift_inputs(opt):
    """Synthetic pairs (GT 256x256, LQ 64x64: 4 to serve, 32 to train on,
    one to validate) and the seed-0 random weights the test config names."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(2)
    size = SCALE * RS_LQ
    for gt_dir, lq_dir, count in (('test_GT', 'test_LQ', RS_REQUESTS),
                                  ('GT', 'LQ', RS_TRAIN_IMAGES), ('val_GT', 'val_LQ', 1)):
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(RS_DATA_DIR, sub), exist_ok=True)
        for i in range(count):
            gt = smooth_image(rng, size, size)
            lq = cv2.resize(gt, (RS_LQ, RS_LQ), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(RS_DATA_DIR, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(RS_DATA_DIR, lq_dir, f'{i:04d}.png'), lq)
    net, stage = random_resshift_weights(opt)
    for module, key in ((net, 'pretrain_network_g'), (stage, 'pretrain_network_ae')):
        os.makedirs(os.path.dirname(opt['path'][key]), exist_ok=True)
        torch.save({'params': module.state_dict()}, opt['path'][key])


def serve_resshift():
    import cv2
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import window_attention as A
    phase('8. serve ResShift x4 through basicsr4rs_torch.test on cuda:0 (LQ 64x64, batch 1, '
          '15 reverse steps on a 64x64x3 latent, VQ-f4 decode to 256x256)')
    opt, steps, per_forward = resshift_options(RS_CONFIG)
    write_resshift_inputs(opt)
    per_request = per_forward * steps
    wrappers = attention_wrappers()
    for w in wrappers.values():
        w.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', RS_CONFIG]
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrappers['window_attention_fwd'].launches
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, {RS_REQUESTS} requests, '
          f'metrics, image writes); window_attention_fwd launches {launches} = '
          f'{launches / RS_REQUESTS:g} per request ({per_forward} per UNet forward x {steps} steps)')
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != per_request * RS_REQUESTS or wrappers['window_attention_bwd'].launches:
        fail(f'expected {per_request} forward launches per request and no backward launch, '
             f'counted {launches} and {wrappers["window_attention_bwd"].launches}')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{name} is not finite')
    out_dir = os.path.join(model.opt['path']['visualization'], 'RGB', 'ResShift_x4_synthetic')
    size = SCALE * RS_LQ
    for i in range(RS_REQUESTS):
        img = cv2.imread(os.path.join(out_dir, f'{i:04d}', 'result.png'))
        if img is None or img.shape != (size, size, 3):
            fail(f'saved image {i}: {None if img is None else img.shape}')
    csv_path = os.path.join(model.opt['path']['visualization'],
                            f'ResShift_x4_synthetic_{model.opt["name"]}.csv')
    with open(csv_path) as f:
        rows = f.read().splitlines()
    if len(rows) != RS_REQUESTS + 1:
        fail(f'{csv_path} has {len(rows)} lines')

    # per-request latency of the model's own test(), after a warm-up request
    dataset_opt = model.opt['datasets']['test_1']
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    loader = list(build_dataloader(build_dataset(dataset_opt), dataset_opt))
    latencies = request_latencies(model, loader, lambda item: (1, 3, size, size),
                                  (wrappers['window_attention_fwd'], per_request))
    for ms in latencies:
        print(f'request LQ {RS_LQ}x{RS_LQ} -> {size}x{size}: {ms:.3f} ms '
              f'({ms / steps:.3f} ms a reverse step, decode included)')
    print(f'request latency: mean {sum(latencies) / len(latencies):.3f} ms of {len(latencies)}; '
          f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')

    # one request through the kernels and through the plain versions, same seed
    kept = {}
    decode = model.base_diffusion.decode_first_stage

    def keep_latent(z, *args, **kwargs):
        kept['z'] = z.clone()
        return decode(z, *args, **kwargs)

    results = []
    with mock.patch.object(model.base_diffusion, 'decode_first_stage', keep_latent):
        for plain in (False, True):
            model.generator.manual_seed(11)
            model.feed_data(loader[1])
            if plain:
                with mock.patch.object(swinir_arch, 'fused_window_attention',
                                       A.reference_window_attention):
                    model.test()
            else:
                model.test()
            with torch.inference_mode():
                codes = model.first_stage.quantize(kept['z'])[2]
            results.append((kept['z'], model.output.clone(), codes))
    if wrappers['window_attention_fwd'].launches != per_request * (2 * RS_REQUESTS + 2):
        fail('the plain request launched a kernel')
    (z_k, img_k, codes_k), (z_p, img_p, codes_p) = results
    z_err = (z_k - z_p).abs().max().item()
    img_err = (img_k - img_p).abs().max().item()
    flipped = int((codes_k != codes_p).sum())
    print(f'kernels vs plain versions, one request, same seed: latent max abs difference '
          f'{z_err:.3e}, image {img_err:.3e} on [-1, 1] (tolerance {RS_SAMPLE_TOLERANCE}); '
          f'{flipped} of {codes_k.numel()} code indices differ')
    # a latent at the border of two codes' cells may fall either way: then,
    # and only then, the image may differ there
    if z_err > RS_SAMPLE_TOLERANCE or flipped > 4 or (flipped == 0 and
                                                      img_err > RS_SAMPLE_TOLERANCE):
        fail('the sampled request differs between kernels and plain versions')

    phase('8b. device time of a sampled request by kernel (torch.profiler)')

    def request():
        model.feed_data(loader[0])
        model.test()

    profile_device_time(request, 1, 'request', tuple(wrappers), 'resshift_request_profile.json')
    print('of which the first stage alone (bicubic x4, VQ-f4 encode of the LQ, quantize and '
          'decode of a latent):')
    lq = model.lq

    def first_stage_only():
        with torch.inference_mode():
            z = model.base_diffusion.encode_first_stage(lq, model.first_stage, up_sample=True)
            model.base_diffusion.decode_first_stage(z, model.first_stage)

    profile_device_time(first_stage_only, 1, 'request', tuple(wrappers),
                        'resshift_first_stage_profile.json')
    return launches


def train_resshift():
    from basicsr4rs_torch.models.resshift_model import ResShiftModel
    opt, steps, per_forward = resshift_options(RS_TRAIN_CONFIG)
    batch = opt['datasets']['train']['batch_size_per_gpu']
    phase(f'9. train ResShift x4 through basicsr4rs_torch.train on cuda:0 (batch {batch}, '
          'GT 256 -> latent 64x64, float32)')
    total_iter = opt['train']['total_iter']
    wrappers = attention_wrappers()
    exp_dir = fresh_run(opt, wrappers)
    record = {'steps': []}
    common = dict(config=RS_TRAIN_CONFIG, model_cls=ResShiftModel, loss_key='loss',
                  wrappers=wrappers, before_first_step=keep_fed_batch)
    t0 = time.perf_counter()
    model = run_train_pipeline([], record, **common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    run = record['steps']
    validations = total_iter // opt['val']['val_freq'] + 1
    print(f'pipeline wall time {wall:.3f} s for {len(run)} steps, {validations} validations '
          f'(one image, {steps} reverse steps each), checkpoints; batch {batch}')
    check_steps(run, total_iter, 'loss', dict.fromkeys(wrappers, per_forward))
    if model.skipped_steps:
        fail(f'{model.skipped_steps} steps were skipped as non-finite')
    want = {'window_attention_fwd': per_forward * (total_iter + steps * validations),
            'window_attention_bwd': per_forward * total_iter}
    if launches != want:
        fail(f'launches in the run {launches}, expected {want}')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items()))

    check_ema_and_checkpoint(model, random_resshift_weights(opt, seed=1)[0],
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))

    resumed = {'steps': []}
    run_train_pipeline(['--auto_resume', '--force_yml',
                        f'train:total_iter={total_iter + RESUME_ITERS}'], resumed, **common)
    iters = [st['iter'] for st in resumed['steps']]
    print(f'resumed from {total_iter}.state: ran steps {iters}, loss '
          + ' '.join(f'{st["loss"]:.6f}' for st in resumed['steps']))
    if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
        fail(f'resume should continue at step {total_iter + 1}, ran {iters}')

    phase('9b. device time of a training step by kernel (torch.profiler)')
    profile_fed_steps(model, record, wrappers, 'resshift_train_step_profile.json')
    del model

    phase(f'9c. {RS_AMP_ITERS} training steps under use_amp: true (bfloat16 autocast)')
    _, dtypes, spies = attention_dtype_spies()
    amp = {'steps': []}
    for sp in spies:
        sp.start()
    try:
        run_train_pipeline(['--force_yml', 'train:use_amp=true', f'train:total_iter={RS_AMP_ITERS}',
                            f'name={opt["name"]}_amp', 'val:val_freq=100',
                            'logger:save_checkpoint_freq=100'], amp, **common)
    finally:
        for sp in spies:
            sp.stop()
    for st in amp['steps']:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, loss {st["loss"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()))
        if not torch.isfinite(torch.tensor(st['loss'])):
            fail(f'the loss under use_amp is not finite at step {st["iter"]}')
    # the steps, then the validation after the loop in forward launches
    bf16 = {name: dtypes[(attr, 'torch.bfloat16')] for name, attr in (
        ('window_attention_fwd', '_launch_forward'), ('window_attention_bwd', '_launch_backward'))}
    print(f'bfloat16 launches: {bf16}')
    if (bf16['window_attention_bwd'] != per_forward * RS_AMP_ITERS
            or bf16['window_attention_fwd'] < per_forward * RS_AMP_ITERS
            or any(dt != 'torch.bfloat16' for _, dt in dtypes)):
        fail(f'under use_amp the attention kernels should run in bfloat16: {bf16}')
    return launches


def check_resshift_gradients():
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import window_attention as A
    from basicsr4rs_torch.utils.gaussian_diffusion import create_gaussian_diffusion
    opt, steps, per_forward = resshift_options(RS_TRAIN_CONFIG)
    batch = opt['datasets']['train']['batch_size_per_gpu']
    phase('10. ResShift, forward and backward: kernels vs plain versions, one training batch '
          f'of {batch}')
    net, stage = random_resshift_weights(opt)
    net, stage = net.cuda().train(), stage.cuda().eval().requires_grad_(False)
    diffusion = create_gaussian_diffusion(**opt['diffusion'])
    gen = torch.Generator().manual_seed(4)
    size = SCALE * RS_LQ
    lq = (torch.rand(batch, 3, RS_LQ, RS_LQ, generator=gen) * 2 - 1).cuda()
    gt = (torch.rand(batch, 3, size, size, generator=gen) * 2 - 1).cuda()
    tt = torch.randint(0, steps, (batch,), generator=gen).cuda()
    noise = torch.randn(batch, 3, RS_LQ, RS_LQ, generator=gen).cuda()

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        losses, _, _ = diffusion.training_losses(None, lambda x, t: net(x, t, lq=lq), gt, lq, tt,
                                                 first_stage_model=stage, noise=noise)
        loss = losses['mse'].mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    wrappers = attention_wrappers()
    counts = {k: w.launches for k, w in wrappers.items()}
    loss_k, grads_k = loss_and_grads()
    if {k: w.launches - counts[k] for k, w in wrappers.items()} != dict.fromkeys(wrappers,
                                                                                per_forward):
        fail('the kernel run did not launch each attention kernel once per Swin block')
    counts = {k: w.launches for k, w in wrappers.items()}
    with mock.patch.object(swinir_arch, 'fused_window_attention', A.reference_window_attention):
        loss_p, grads_p = loss_and_grads()
    if counts != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    compare_gradients('ResShift', loss_k, grads_k, loss_p, grads_p)


def check_l2s_unet():
    """Phase 10b: UNetModelSwin at ``L2S_CONFIG``'s ``network_g`` (window 9,
    as read from the YAML), seed-0 weights, forward and backward at B=2 of
    its 72x72 latents through the kernels and through the plain versions."""
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.archs.arch_util import default_conv_init_
    from basicsr4rs_torch.archs.unet_arch import BasicLayer, UNetModelSwin
    from basicsr4rs_torch.ops import window_attention as A
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(L2S_CONFIG)
    net_opt = {k: v for k, v in opt['network_g'].items() if k != 'type'}
    size, ws, batch = net_opt['image_size'], net_opt['window_size'], 2
    phase(f'10b. UNetModelSwin of {os.path.basename(L2S_CONFIG)} (window {ws}, model channels '
          f'{net_opt["model_channels"]}, Swin {net_opt["swin_embed_dim"]}), forward and backward '
          f'at B={batch} of {size}x{size} latents: kernels vs plain versions')
    gen = torch.Generator().manual_seed(0)
    net = UNetModelSwin(**net_opt, generator=gen)
    with torch.no_grad():   # no zero-initialised convolution: every parameter shows
        for m in net.modules():
            if getattr(m, 'zero_init', False):
                default_conv_init_(m, gen)
    net = net.cuda().train()
    per_forward = sum(len(m.blocks) for m in net.modules() if isinstance(m, BasicLayer))
    channels = net_opt['in_channels']
    x = torch.randn(batch, channels, size, size, generator=gen).cuda()
    lq = torch.randn(batch, channels, net_opt['lq_size'], net_opt['lq_size'], generator=gen).cuda()
    target = torch.randn(batch, net_opt['out_channels'], size, size, generator=gen).cuda()
    tt = torch.randint(0, opt['diffusion']['steps'], (batch,), generator=gen).cuda()

    def run():
        net.zero_grad(set_to_none=True)
        out = net(x, tt, lq=lq)
        loss = (out - target).pow(2).mean()
        loss.backward()
        return out.detach().clone(), loss.item(), {k: q.grad.clone()
                                                   for k, q in net.named_parameters()}

    wrappers = attention_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out_k, loss_k, grads_k = run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f'launches {launches}: {per_forward} Swin blocks a forward')
    if launches != dict.fromkeys(wrappers, per_forward):
        fail(f'expected {per_forward} launches of each attention kernel, counted {launches}')
    with mock.patch.object(swinir_arch, 'fused_window_attention', A.reference_window_attention):
        out_p, loss_p, grads_p = run()
    if launches != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    err = (out_k - out_p).abs().max().item()
    print(f'output: max abs difference {err:.3e} (max|plain| {out_p.abs().max().item():.3e}; '
          f'tolerance {MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('UNetModelSwin at window 9: the outputs disagree')
    compare_gradients('UNetModelSwin at window 9', loss_k, grads_k, loss_p, grads_p)
    del net, grads_k, grads_p
    return launches


# ------------------------------------------ the Landsat -> Sentinel (L2S) path
L2S_DIR = 'results/chip_smoke/l2s'
L2S_SWINIR_TRAIN = 'options/train/SwinIR/train_SwinIR_L2S288_synthetic.yml'
L2S_SWINIR_TEST = 'options/test/SwinIR/test_SwinIR_L2S288_synthetic.yml'
L2S_HM_CONFIG = 'options/train/SwinIR/train_SwinIR_StyleCNN_L2S288_scratch.yml'
L2S_RS_TRAIN = 'options/train/ResShift/train_ResShift_L2S288_synthetic.yml'
L2S_RS_TEST = 'options/test/ResShift/test_ResShift_L2S288_synthetic.yml'
# 5 tiles of 8 windows: 40 samples, of which the configs' split gives 32 to
# training (ResShift-L2S's batch) and 8 to validation
L2S_TILES, L2S_WINDOWS = 5, 8
L2S_BANDS = ('red', 'green', 'blue', 'nir08', 'swir16', 'swir22')
# the validations and the served runs take 2 of them: a split of 38 and 2
L2S_VAL_IMAGES = 2
L2S_VAL_SPLIT = f'split_percent=[{L2S_TILES * L2S_WINDOWS - L2S_VAL_IMAGES},{L2S_VAL_IMAGES}]'


def l2s_output(item):
    """The shape of an L2S request's output: its 6 bands on the 288x288 grid."""
    return (1, 6, 288, 288)


def write_l2s_tree():
    """The synthetic L2S tree the four ``*_L2S288_synthetic.yml`` configs
    read: per window a smooth random reflectance field of each band at 10 m
    (300x300), Sentinel's RGB at 10 m and its NSS group at 20 m (150x150),
    ``sentinel_hm`` the same, and Landsat at 30 m (100x100), each an area
    average of the field, so that Landsat is a 3x downscale of Sentinel and
    the task can be learnt; uint16 digital numbers through the inverses of
    the datasets' norms (Sentinel reflectance x 1e4, Landsat (reflectance +
    0.2) / 2.75e-5), reflectance up to 0.27 in RGB and 0.45 in NSS (the norms
    map 0.3 and 0.5 to 1). Every window scores PSNR 30, SSIM 0.9 in
    ``metric.json`` and ``metric_hm.json``."""
    import shutil

    import cv2
    import numpy as np
    if os.path.isdir(L2S_DIR):
        shutil.rmtree(L2S_DIR)
    rng = np.random.RandomState(5)
    top = (0.3,) * 3 + (0.5,) * 3
    for t in range(L2S_TILES):
        metrics = {}
        for i in range(L2S_WINDOWS):
            window = os.path.join(L2S_DIR, f'tile{t}', f'w{i}', 't0')
            metrics[f'w{i}'] = {'t0': {'psnr': 30.0, 'ssim': 0.9}}
            for src in ('sentinel', 'sentinel_hm', 'landsat'):
                os.makedirs(os.path.join(window, src), exist_ok=True)
            for b, (band, hi) in enumerate(zip(L2S_BANDS, top)):
                coarse = rng.rand(300 // 16 + 2, 300 // 16 + 2).astype(np.float32)
                field = np.clip(cv2.resize(coarse, (300, 300), interpolation=cv2.INTER_CUBIC),
                                0, 1) * 0.9 * hi
                sentinel = field if b < 3 else cv2.resize(field, (150, 150),
                                                          interpolation=cv2.INTER_AREA)
                landsat = cv2.resize(field, (100, 100), interpolation=cv2.INTER_AREA)
                dn_sentinel = np.round(sentinel / 1e-4).astype(np.uint16)
                dn_landsat = np.round((landsat + 0.2) / 2.75e-5).astype(np.uint16)
                for src, dn in (('sentinel', dn_sentinel), ('sentinel_hm', dn_sentinel),
                                ('landsat', dn_landsat)):
                    cv2.imwrite(os.path.join(window, src, f'{band}.tif'), dn)
        for name in ('metric.json', 'metric_hm.json'):
            with open(os.path.join(L2S_DIR, f'tile{t}', name), 'w') as f:
                json.dump(metrics, f)


def check_band_outputs(vis, dataset, names, size):
    """Each image's ``result.png`` under ``RGB/`` and ``NSS/``, three bands of
    ``size`` each."""
    import cv2
    for name in names:
        for group in ('RGB', 'NSS'):
            path = os.path.join(vis, group, dataset, name, 'result.png')
            img = cv2.imread(path)
            if img is None or img.shape != (size, size, 3):
                fail(f'{path}: {None if img is None else img.shape}')


def check_metric_csv(path, metrics, rows):
    """``rows`` images of finite scores in a per-image metric CSV; returns
    the image names."""
    import csv
    with open(path, newline='') as f:
        lines = list(csv.reader(f))
    if lines[0] != [''] + list(metrics) or len(lines) != rows + 1:
        fail(f'{path}: header {lines[0]}, {len(lines) - 1} rows, expected {rows}')
    for line in lines[1:]:
        if not all(math.isfinite(float(v)) for v in line[1:]):
            fail(f'{path}: a score is not finite in {line}')
    return [line[0] for line in lines[1:]]


def train_swinir_l2s():
    """Phase 23: SwinIR-L2S x3 through ``basicsr4rs_torch.train`` at the
    published batch, GT and use_amp. Returns the kernels' launches."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.models.swinir_model import SwinIRL2sModel
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(L2S_SWINIR_TRAIN)
    train_opt = opt['datasets']['train']
    batch, gt_size = train_opt['batch_size_per_gpu'], train_opt['gt_size']
    phase(f'23. train SwinIR-L2S x3 through basicsr4rs_torch.train on cuda:0 (batch {batch}, '
          f'GT {gt_size} from LQ {gt_size // 3} of 6 bands, window 6, use_amp: bfloat16 '
          f'autocast; {batch * (gt_size // 3)**2} tokens a block)')
    write_l2s_tree()
    total_iter = opt['train']['total_iter']
    blocks = sum(opt['network_g']['depths'])
    wrappers = training_kernels()
    exp_dir = fresh_run(opt, wrappers)
    dtypes = collections.Counter()   # what the attention forward kernel is handed under use_amp

    def spy(x, *args, _inner=S._launch_attn_forward):
        dtypes[str(x.dtype)] += 1
        return _inner(x, *args)

    record = {'steps': []}
    t0 = time.perf_counter()
    with mock.patch.object(S, '_launch_attn_forward', spy):
        model = run_train_pipeline(['--force_yml', f'datasets:val:{L2S_VAL_SPLIT}'], record,
                                   config=L2S_SWINIR_TRAIN, model_cls=SwinIRL2sModel,
                                   wrappers=wrappers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: wr.launches for k, wr in wrappers.items()}
    if model.device.type != 'cuda' or not model.use_amp:
        fail(f'the model trained on {model.device}, use_amp {model.use_amp}')
    steps = record['steps']
    val_images = L2S_VAL_IMAGES
    print(f'pipeline wall time {wall:.3f} s for {len(steps)} steps and one validation of '
          f'{val_images} images (LQ 96x96) on net_g_ema')
    check_steps(steps, total_iter, 'l_pix', dict.fromkeys(SPLIT_KERNELS, blocks))
    # each validation image, and the fixed batch before step 1, is one forward
    # of the joint kernel per block
    if launches['swin_block_joint_fwd'] != blocks * (val_images + 1):
        fail(f'{launches["swin_block_joint_fwd"]} launches of the joint kernel, expected '
             f'{blocks} x ({val_images} validation images + 1 fixed batch)')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items()))
    print(f'the attention forward kernel was handed x in {dict(dtypes)} under use_amp '
          '(LayerNorm runs in float32 under autocast; the RSTB adds its bfloat16 '
          'convolution to the float32 stream)')
    if set(dtypes) != {'torch.float32'}:   # phase 24 holds the whole model in float32
        fail(f'under use_amp the Swin blocks were handed {dict(dtypes)}, not float32 alone')
    loss_after = fixed_batch_loss(model, record['fixed'])
    joint = wrappers['swin_block_joint_fwd'].launches
    if joint != launches['swin_block_joint_fwd'] + blocks:   # the fixed batch, once more
        fail(f'the loss on the fixed batch took {joint - launches["swin_block_joint_fwd"]} '
             f'joint kernel launches, expected {blocks}')
    launches['swin_block_joint_fwd'] = joint
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before '
          f'step 1, {loss_after:.6f} after step {total_iter}')
    if not loss_after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')

    check_validation(model, opt, 'L2S_single_val', gt_size)
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    check_ema_and_checkpoint(model, SwinIR(**net_opt),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))

    phase('23b. device time of a SwinIR-L2S training step by kernel (torch.profiler)')
    model.lq, model.gt = record['fixed']
    counts = {k: wr.launches for k, wr in wrappers.items()}
    model.optimize_parameters(0)
    ours = ('swin_attn_fwd_head', 'swin_attn_fwd_proj', 'swin_attn_block_bwd', 'mlp_block_fwd',
            'mlp_block_bwd', 'branch_ln_bwd')
    profile_device_time(lambda: model.optimize_parameters(0), 1, 'step', ours,
                        'swinir_l2s_train_step_profile.json')
    for k, wr in wrappers.items():   # the profiled steps belong to no main path's count
        wr.launches = counts[k]
    del model
    return launches


def serve_swinir_l2s():
    """Phase 25: SwinIR-L2S x3 served through ``basicsr4rs_torch.test``, then
    one request of ``SwinIRHMModel`` on ``SwinIR_StyleCNN``. Returns K1's
    launches."""
    import copy

    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.data import build_dataloader, build_dataset, default_collate
    from basicsr4rs_torch.metrics import calculate_metric
    from basicsr4rs_torch.models import build_model
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    from basicsr4rs_torch.utils.img_util import minusone_one_tensor_to_ubyte_numpy
    from basicsr4rs_torch.utils.options import yaml_load
    phase('25. serve SwinIR-L2S x3 through basicsr4rs_torch.test on cuda:0 (LQ 96x96 of 6 '
          'bands -> 288x288, batch 1, window 6)')
    opt = yaml_load(L2S_SWINIR_TEST)
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    blocks = sum(net_opt['depths'])
    weights = opt['path']['pretrain_network_g']
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    torch.save({'params': SwinIR(**net_opt, generator=torch.Generator().manual_seed(0))
                .state_dict()}, weights)
    fused_swin_block_full.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', L2S_SWINIR_TEST, '--force_yml',
                f'datasets:test_1:{L2S_VAL_SPLIT}']
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_swin_block_full.launches
    dataset_opt = model.opt['datasets']['test_1']
    loader = list(build_dataloader(build_dataset(dataset_opt), dataset_opt))
    print(f'pipeline wall time {wall:.3f} s ({len(loader)} requests, '
          f'{len(opt["val"]["metrics"])} metrics each, 6 of them NIQE, image writes); joint '
          f'kernel launches {launches} = {launches / len(loader):g} per request')
    if model.device.type != 'cuda' or launches != blocks * len(loader):
        fail(f'expected {blocks} joint kernel launches per request on cuda, counted {launches} '
             f'over {len(loader)} requests on {model.device}')
    vis = model.opt['path']['visualization']
    names = check_metric_csv(os.path.join(vis, f'L2S_single_val_{model.opt["name"]}.csv'),
                             opt['val']['metrics'], len(loader))
    check_band_outputs(vis, 'L2S_single_val', names, 288)
    print('metrics (random weights): ' + ', '.join(f'{k} {v:.4f}'
                                                  for k, v in model.metric_results.items()))
    # where the host time of one validation item goes
    dataset = build_dataset(dataset_opt)
    marks = [time.perf_counter()]
    item = dataset[0]
    marks.append(time.perf_counter())
    model.feed_data(default_collate([item]))
    model.test()
    visuals = {k: minusone_one_tensor_to_ubyte_numpy(v, rgb2bgr=False)
               for k, v in model.get_current_visuals().items()}
    marks.append(time.perf_counter())
    by_type = collections.Counter()
    for metric in opt['val']['metrics'].values():
        t_metric = time.perf_counter()
        calculate_metric({'img': visuals['result'], 'img2': visuals['gt']}, metric)
        by_type[metric['type']] += time.perf_counter() - t_metric
    marks.append(time.perf_counter())
    model._save_visuals('host_time', 'one', visuals)
    marks.append(time.perf_counter())
    parts = ('reading and cropping its 12 TIFFs', 'feed, forward and the three visuals',
             f'the {len(opt["val"]["metrics"])} metrics', 'six PNGs')
    print('host time of one validation item: ' + ', '.join(
        f'{name} {1e3 * (b - a):.1f} ms' for name, a, b in zip(parts, marks, marks[1:]))
        + '; the metrics by type: ' + ', '.join(f'{k} {1e3 * v:.1f} ms' for k, v in
                                               by_type.most_common())
        + f' ({os.cpu_count()} CPUs, torch {torch.get_num_threads()} threads)')
    latencies = request_latencies(model, loader[:4], l2s_output)
    print(f'request latency: ' + ', '.join(f'{ms:.3f}' for ms in latencies) + ' ms; mean '
          f'{sum(latencies) / len(latencies):.3f} ms, '
          f'{288 * 288 / (sum(latencies) / len(latencies)) / 1e3:.3f} output MP/s; peak device '
          f'memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    launches = fused_swin_block_full.launches
    hm_opt = yaml_load(L2S_HM_CONFIG)
    parsed = copy.deepcopy(model.opt)
    del model

    # SwinIRHMModel on SwinIR_StyleCNN (the network of the published StyleCNN
    # config; random weights from seed 0): one request, both branches scored
    parsed.update(model_type='SwinIRHMModel', network_g=hm_opt['network_g'],
                  hm_loss_weight=hm_opt['hm_loss_weight'], gt_loss_weight=hm_opt['gt_loss_weight'])
    parsed['path']['pretrain_network_g'] = None
    torch.manual_seed(0)
    hm_model = build_model(parsed)
    before = fused_swin_block_full.launches
    latency = request_latencies(hm_model, loader[:1], l2s_output)[0]
    if fused_swin_block_full.launches - before != 2 * blocks:   # the warm-up and the request
        fail(f'SwinIRHMModel: {fused_swin_block_full.launches - before} joint kernel launches '
             f'for 2 requests, expected {2 * blocks}')
    gt = minusone_one_tensor_to_ubyte_numpy(hm_model.gt.detach().cpu(), rgb2bgr=False)
    scores = {}
    for branch in ('output', 'output_hm'):
        out = getattr(hm_model, branch)
        if out.shape != (1, 6, 288, 288) or not torch.isfinite(out).all():
            fail(f'SwinIRHMModel {branch}: {tuple(out.shape)}')
        img = minusone_one_tensor_to_ubyte_numpy(out.detach().cpu(), rgb2bgr=False)
        for metric in ('psnr_nir', 'ssim_red', 'niqe_swir16'):
            scores[f'{branch} {metric}'] = calculate_metric(
                {'img': img, 'img2': gt}, opt['val']['metrics'][metric])
    if not all(np.isfinite(v) for v in scores.values()):
        fail(f'SwinIRHMModel: a metric is not finite: {scores}')
    print(f'SwinIRHMModel (SwinIR_StyleCNN, {os.path.basename(L2S_HM_CONFIG)}): one request '
          f'{latency:.3f} ms; ' + ', '.join(f'{k} {v:.4f}' for k, v in scores.items()))
    launches += fused_swin_block_full.launches - before
    del hm_model
    return launches


def train_resshift_l2s():
    """Phase 26: ResShift-L2S x3 through ``basicsr4rs_torch.train`` at the
    published batch, GT, window and use_amp. Returns the kernels' launches."""
    from basicsr4rs_torch.models.resshift_l2s_model import ResShiftL2SModel
    opt, steps, per_forward = resshift_options(L2S_RS_TRAIN)
    train_opt = opt['datasets']['train']
    batch, gt_size = train_opt['batch_size_per_gpu'], train_opt['gt_size']
    latent = gt_size // 4
    phase(f'26. train ResShift-L2S x3 through basicsr4rs_torch.train on cuda:0 (batch {batch}, '
          f'GT {gt_size} of 6 bands -> latents {latent}x{latent}, window '
          f'{opt["network_g"]["window_size"]}, use_amp: bfloat16 autocast)')
    total_iter = opt['train']['total_iter']
    wrappers, dtypes, spies = attention_dtype_spies()
    fresh_run(opt, wrappers)
    record = {'steps': []}
    t0 = time.perf_counter()
    for sp in spies:
        sp.start()
    try:
        model = run_train_pipeline(['--force_yml', f'datasets:val:{L2S_VAL_SPLIT}'], record,
                                   config=L2S_RS_TRAIN, model_cls=ResShiftL2SModel,
                                   loss_key='loss', wrappers=wrappers,
                                   before_first_step=keep_fed_batch)
    finally:
        for sp in spies:
            sp.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: wr.launches for k, wr in wrappers.items()}
    if model.device.type != 'cuda' or not model.use_amp:
        fail(f'the model trained on {model.device}, use_amp {model.use_amp}')
    run = record['steps']
    print(f'pipeline wall time {wall:.3f} s for {len(run)} steps and one validation of '
          f'{L2S_VAL_IMAGES} images ({steps} reverse steps each); batch {batch}')
    check_steps(run, total_iter, 'loss', dict.fromkeys(wrappers, per_forward))
    if model.skipped_steps:
        fail(f'{model.skipped_steps} steps were skipped as non-finite')
    want = {'window_attention_fwd': per_forward * (total_iter + steps * L2S_VAL_IMAGES),
            'window_attention_bwd': per_forward * total_iter}
    if launches != want:
        fail(f'launches in the run {launches}, expected {want}')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items())
          + f'; made in {dict(dtypes)}')
    if any(dt != 'torch.bfloat16' for _, dt in dtypes):
        fail('under use_amp the attention kernels should run in bfloat16')
    check_validation(model, opt, 'L2S_single_val', gt_size)

    phase('26b. device time of a ResShift-L2S training step by kernel (torch.profiler)')
    profile_fed_steps(model, record, wrappers, 'resshift_l2s_train_step_profile.json')
    del model
    return launches


def serve_resshift_l2s():
    """Phase 27: ResShift-L2S x3 sampled through ``basicsr4rs_torch.test``, 2
    requests of 15 reverse steps. Returns K6's launches."""
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    opt, steps, per_forward = resshift_options(L2S_RS_TEST)
    phase(f'27. serve ResShift-L2S x3 through basicsr4rs_torch.test on cuda:0 (LQ 96x96 of 6 '
          f'bands, batch 1, {steps} reverse steps on a 72x72x6 latent, VQ-f4 decode 3 bands at '
          'a time to 288x288)')
    net, stage = random_resshift_weights(opt)
    for module, key in ((net, 'pretrain_network_g'), (stage, 'pretrain_network_ae')):
        os.makedirs(os.path.dirname(opt['path'][key]), exist_ok=True)
        torch.save({'params': module.state_dict()}, opt['path'][key])
    del net, stage
    wrappers = attention_wrappers()
    for wr in wrappers.values():
        wr.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', L2S_RS_TEST, '--force_yml',
                f'datasets:test_1:{L2S_VAL_SPLIT}']
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_request = per_forward * steps
    launches = wrappers['window_attention_fwd'].launches
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, {L2S_VAL_IMAGES} '
          f'requests, metrics, image writes); window_attention_fwd launches {launches} = '
          f'{launches / L2S_VAL_IMAGES:g} per request')
    if model.device.type != 'cuda' or launches != per_request * L2S_VAL_IMAGES \
            or wrappers['window_attention_bwd'].launches:
        fail(f'expected {per_request} forward launches per request on cuda and no backward '
             f'launch, counted {launches} on {model.device}')
    vis = model.opt['path']['visualization']
    names = check_metric_csv(os.path.join(vis, f'L2S_single_val_{model.opt["name"]}.csv'),
                             opt['val']['metrics'], L2S_VAL_IMAGES)
    check_band_outputs(vis, 'L2S_single_val', names, 288)
    print('metrics (random weights): ' + ', '.join(f'{k} {v:.4f}'
                                                  for k, v in model.metric_results.items()))
    dataset_opt = model.opt['datasets']['test_1']
    loader = list(build_dataloader(build_dataset(dataset_opt), dataset_opt))
    latencies = request_latencies(model, loader, l2s_output,
                                  (wrappers['window_attention_fwd'], per_request))
    print(f'request latency: ' + ', '.join(f'{ms:.3f}' for ms in latencies) + ' ms (mean '
          f'{np.mean(latencies):.3f}, {np.mean(latencies) / steps:.3f} ms a reverse step, decode '
          f'included); peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    launches = wrappers['window_attention_fwd'].launches

    phase('27b. device time of a ResShift-L2S request by kernel (torch.profiler)')

    def request():
        model.feed_data(loader[0])
        model.test()

    profile_device_time(request, 1, 'request', tuple(wrappers),
                        'resshift_l2s_request_profile.json')
    del model
    return launches


def l2s_paths(launches):
    """Phases 23 to 27: the L2S path. Their launches are added to
    ``launches``."""
    for name, count in train_swinir_l2s().items():
        launches[name] += count
    # the Swin blocks get float32 under use_amp (phase 23): the whole model in float32
    check_model_gradients('24', L2S_SWINIR_TRAIN, (L2S_SHAPE[0], 6) + L2S_SHAPE[1:])
    launches['swin_block_joint_fwd'] += serve_swinir_l2s()
    for name, count in train_resshift_l2s().items():
        launches[name] += count
    launches['window_attention_fwd'] += serve_resshift_l2s()


# ------------------------------------------------- the RS alignment stack
ALIGN_REG_TRAIN = 'options/train/AlignAutoencoder/train_Registration_L2S_Square192_synthetic.yml'
ALIGN_JOINT_TRAIN = 'options/train/AlignResDiff/train_AlignResDiff_3loss_L2S_Square192_synthetic.yml'
ALIGN_JOINT_TEST = 'options/test/AlignResDiff/test_AlignResDiff_3loss_L2S_Square192_synthetic.yml'
SRCNN_TRAIN = 'options/train/SRCNN/train_SRCNN_L2S288_synthetic.yml'
LPIPS_DIR = 'results/chip_smoke/lpips'   # the random weights the synthetic configs name


def write_lpips_weights():
    """Random AlexNet features (std 1/sqrt(fan-in)) and non-negative linear
    heads from seed 0, in the two published files' key layouts, where the
    synthetic configs' LPIPS metrics read them: the repository holds neither."""
    from basicsr4rs_torch.metrics.lpips import _ALEX_CONVS
    gen = torch.Generator().manual_seed(0)
    alex, lins = {}, {}
    for n, (i, cin, cout, k, _, _) in enumerate(_ALEX_CONVS):
        alex[f'features.{i}.weight'] = torch.randn(cout, cin, k, k, generator=gen) * (
            cin * k * k)**-0.5
        alex[f'features.{i}.bias'] = torch.randn(cout, generator=gen) * 0.05
        lins[f'lin{n}.model.1.weight'] = torch.rand(1, cout, 1, 1, generator=gen)
    os.makedirs(LPIPS_DIR, exist_ok=True)
    torch.save(alex, os.path.join(LPIPS_DIR, 'alexnet-owt.pth'))
    torch.save(lins, os.path.join(LPIPS_DIR, 'lpips_alex_v0.1.pth'))


def check_validation(model, opt, dataset, size):
    """The per-image CSV of every metric the config names (L2S_VAL_IMAGES
    rows of finite scores) and the RGB and NSS PNGs of each image."""
    import glob
    vis = model.opt['path']['visualization']
    csvs = glob.glob(os.path.join(vis, f'{dataset}_*.csv'))
    if len(csvs) != 1:
        fail(f'expected one metric CSV under {vis}, found {csvs}')
    names = check_metric_csv(csvs[0], opt['val']['metrics'], L2S_VAL_IMAGES)
    check_band_outputs(vis, dataset, names, size)
    print(f'{csvs[0]}: {L2S_VAL_IMAGES} rows of {len(opt["val"]["metrics"])} finite metrics; RGB '
          'and NSS PNGs of each: ' + ', '.join(f'{k} {v:.4f}' for k, v in
                                              model.metric_results.items()
                                              if k in ('psnr', 'ssim', 'psnr_nir', 'niqe_red',
                                                       'niqe_swir22', 'lpips_red',
                                                       'lpips_swir22')))


def metric_host_time(model, opt):
    """Seconds of each metric type on the first validation item, its
    output and GT as validation scores them."""
    from basicsr4rs_torch.data import build_dataset, default_collate
    from basicsr4rs_torch.metrics import calculate_metric
    from basicsr4rs_torch.utils.img_util import minusone_one_tensor_to_ubyte_numpy
    model.feed_data(default_collate([build_dataset(model.opt['datasets']['val'])[0]]))
    model.test()
    visuals = {k: minusone_one_tensor_to_ubyte_numpy(v, rgb2bgr=False)
               for k, v in model.get_current_visuals().items()}
    by_type = collections.Counter()
    for metric in opt['val']['metrics'].values():
        t0 = time.perf_counter()
        calculate_metric({'img': visuals['result'], 'img2': visuals['gt']}, metric)
        by_type[metric['type']] += time.perf_counter() - t0
    return by_type


def open_channel_gates(net):
    """Each CAB's gate (CAM) starts near sigmoid(0) = 1/2 under torch's
    initialisation, so the 16 of an AlignAutoencoder scale its output by
    about 2^-16: every band of the image then rounds to one uint8 level,
    which NIQE cannot score (in either package). A bias of 3 on each gate's
    last Linear opens it (sigmoid(6), the max and mean descriptors' sum)."""
    from basicsr4rs_torch.archs.arch_util import CAM
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, CAM):
                m.linear_max[2].bias.fill_(3.)
    return net


def train_registration():
    """Phase 28: the registration autoencoder (RegistrationModel on
    StyleResNet) through ``basicsr4rs_torch.train`` at the published widths,
    batch, GT and use_amp, with one validation of the 26 metrics."""
    from basicsr4rs_torch.models.align_single_model import AlignSingleModel, center_crop_to
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(ALIGN_REG_TRAIN)
    train_opt = opt['datasets']['train']
    batch, gt_size = train_opt['batch_size_per_gpu'], train_opt['gt_size']
    val_size = opt['datasets']['val']['gt_size']
    net = opt['network_g']
    phase(f'28. train the registration autoencoder through basicsr4rs_torch.train on cuda:0 '
          f'({net["type"]}: {net["num_in_ch"]} -> {net["num_out_ch"]} bands, {net["num_feat"]} '
          f'features, {net["num_block"]} blocks; batch {batch}, GT {gt_size}, use_amp; from '
          'seed-0 weights with its channel gates opened; no TPU kernel on this path)')
    if not os.path.isdir(L2S_DIR):
        write_l2s_tree()
    write_lpips_weights()
    from basicsr4rs_torch.archs.alignae_arch import AlignAutoencoder
    torch.manual_seed(0)   # torch's initialisation from seed 0, its channel gates opened
    init = 'experiments/Registration_L2S_Square192_synthetic/net_g_seed0.pth'
    os.makedirs(os.path.dirname(init), exist_ok=True)
    torch.save({'params': open_channel_gates(AlignAutoencoder(
        **{k: v for k, v in net.items() if k != 'type'})).state_dict()}, init)
    total_iter = opt['train']['total_iter']
    wrappers = attention_wrappers()
    fresh_run(opt, wrappers)

    def fixed_loss(model, batch):
        """Stage 1 + stage 2 of the training network in eval mode on a batch."""
        reg_input, lq_up, gt = batch
        model.net_g.eval()
        with torch.no_grad(), model.autocast():
            out = model.net_g(reg_input)
        model.net_g.train()
        return float(model.stage1_loss(center_crop_to(out['stage1'].float(), *lq_up.shape[-2:]),
                                       lq_up)
                     + model.stage2_loss(center_crop_to(out['stage2'].float(), *gt.shape[-2:]),
                                         gt))

    def keep_batch(model, record):
        keep_fed_batch(model, record)
        record['fixed'] = tuple(record['batch'][k] for k in ('reg_input', 'lq_up', 'gt'))
        record['fixed_loss_before'] = fixed_loss(model, record['fixed'])

    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline(['--force_yml', f'datasets:val:{L2S_VAL_SPLIT}',
                                f'path:pretrain_network_g={init}'], record,
                               config=ALIGN_REG_TRAIN, model_cls=AlignSingleModel,
                               loss_key='stage2_loss', wrappers=wrappers,
                               before_first_step=keep_batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if model.device.type != 'cuda' or not model.use_amp:
        fail(f'the model trained on {model.device}, use_amp {model.use_amp}')
    print(f'pipeline wall time {wall:.3f} s for {len(record["steps"])} steps and one validation '
          f'of {L2S_VAL_IMAGES} images (GT {val_size}, {len(opt["val"]["metrics"])} metrics) on '
          'net_g_ema')
    check_steps(record['steps'], total_iter, 'stage2_loss', {})
    if model.skipped_steps:
        fail(f'{model.skipped_steps} steps were skipped as non-finite')
    after = fixed_loss(model, record['fixed'])
    print(f'stage1 + stage2 loss on the first batch, eval mode: {record["fixed_loss_before"]:.6f} '
          f'before step 1, {after:.6f} after step {total_iter}')
    if not after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')
    check_validation(model, opt, 'L2S_square_val', val_size)
    by_type = metric_host_time(model, opt)
    lpips = sum(1 for m in opt['val']['metrics'].values() if m['type'] == 'calculate_lpips_band')
    print(f'one validation item: the {lpips} LPIPS bands '
          f'{by_type["calculate_lpips_band"]:.3f} s (AlexNet on the card), all '
          f'{len(opt["val"]["metrics"])} metrics {sum(by_type.values()):.3f} s; by type: '
          + ', '.join(f'{k} {v:.3f} s' for k, v in by_type.most_common()))

    phase('28b. device time of a registration training step by kernel (torch.profiler)')
    profile_fed_steps(model, record, {}, 'registration_train_step_profile.json')
    del model


def swin_blocks(unet):
    from basicsr4rs_torch.archs.unet_arch import SwinBlockGN
    return sum(isinstance(m, SwinBlockGN) for m in unet.modules())


def random_joint_weights(net_opt, seed=0):
    """ResNetAE_SwinUNet from ``seed`` with the UNet's zero-initialised
    convolutions redrawn (a fresh UNet answers 0 to everything) and the
    align networks' channel gates opened (``open_channel_gates``)."""
    from basicsr4rs_torch.archs.alignae_unet_arch import ResNetAE_SwinUNet
    from basicsr4rs_torch.archs.arch_util import default_conv_init_
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    net = ResNetAE_SwinUNet(**{k: v for k, v in net_opt.items() if k != 'type'})
    with torch.no_grad():
        for m in net.unet.modules():
            if getattr(m, 'zero_init', False):
                default_conv_init_(m, gen)
    return open_channel_gates(net)


def train_joint_align():
    """Phase 29: the joint align-diffusion model through
    ``basicsr4rs_torch.train`` at the published widths, batch and use_amp
    (GT 66). Returns the model and the attention kernels' launches."""
    from basicsr4rs_torch.models.align_joint_diff_model import AlignJointDiffModel
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(ALIGN_JOINT_TRAIN)
    train_opt, unet = opt['datasets']['train'], opt['network_g']['unet_args']
    batch, gt_size = train_opt['batch_size_per_gpu'], train_opt['gt_size']
    steps = opt['diffusion']['steps']
    phase(f'29. train the joint align-diffusion model through basicsr4rs_torch.train on cuda:0 '
          f'(ResNetAE_SwinUNet: UNet {unet["model_channels"]} x {unet["channel_mult"]}, Swin '
          f'{unet["swin_embed_dim"]} in heads of {unet["num_head_channels"]}, window '
          f'{unet["window_size"]}, image_size {unet["image_size"]}; batch {batch}, GT {gt_size}, '
          'use_amp)')
    total_iter = opt['train']['total_iter']
    wrappers, dtypes, spies = attention_dtype_spies()
    fresh_run(opt, wrappers)
    record = {'steps': []}
    t0 = time.perf_counter()
    for sp in spies:
        sp.start()
    try:
        model = run_train_pipeline(['--force_yml', f'datasets:val:{L2S_VAL_SPLIT}'], record,
                                   config=ALIGN_JOINT_TRAIN, model_cls=AlignJointDiffModel,
                                   loss_key='loss', wrappers=wrappers,
                                   before_first_step=keep_fed_batch)
    finally:
        for sp in spies:
            sp.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: wr.launches for k, wr in wrappers.items()}
    if model.device.type != 'cuda' or not model.use_amp:
        fail(f'the model trained on {model.device}, use_amp {model.use_amp}')
    per_forward = swin_blocks(model.net_g.unet)
    print(f'pipeline wall time {wall:.3f} s for {len(record["steps"])} steps and one validation '
          f'of {L2S_VAL_IMAGES} images ({steps} reverse steps each); {per_forward} Swin blocks '
          'in the UNet (its middle block: 8x8, one window of 64 tokens, no shift)')
    check_steps(record['steps'], total_iter, 'loss', dict.fromkeys(wrappers, per_forward))
    if model.skipped_steps:
        fail(f'{model.skipped_steps} steps were skipped as non-finite')
    print('losses of the last step: ' + ', '.join(f'{k} {float(v):.6f}'
                                                 for k, v in model.log_dict.items()))
    want = {'window_attention_fwd': per_forward * (total_iter + steps * L2S_VAL_IMAGES),
            'window_attention_bwd': per_forward * total_iter}
    if launches != want:
        fail(f'launches in the run {launches}, expected {want}')
    print('launches in the run: ' + ' '.join(f'{k}={v}' for k, v in launches.items())
          + f'; made in {dict(dtypes)} (use_amp: the qkv Linear runs in bfloat16 under autocast)')
    if {dt for _, dt in dtypes} != {'torch.bfloat16'}:
        fail(f'under use_amp the attention kernels were handed {dict(dtypes)}')
    check_validation(model, opt, 'L2S_square_val', gt_size)

    phase('29b. device time of a joint align-diffusion training step by kernel (torch.profiler)')
    profile_fed_steps(model, record, wrappers, 'align_joint_train_step_profile.json')
    return model, launches


def check_joint_model(model):
    """Phase 29c: the joint model in float32 with the kernels and with their
    plain versions, on seed-0 weights and one training batch: the four
    losses' sum and every gradient of one step, and a sampled request
    (the same noises)."""
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import window_attention as A
    opt = model.opt
    batch, gt_size = opt['datasets']['train']['batch_size_per_gpu'], opt['datasets']['train'][
        'gt_size']
    phase(f'29c. the joint model in float32, kernels vs plain versions: one training batch of '
          f'{batch} (GT {gt_size}) forward and backward, and one request')
    weights = random_joint_weights(opt['network_g']).state_dict()
    model.net_g.load_state_dict(weights)
    model.net_g_ema.load_state_dict(weights)   # test() samples with the EMA network
    model.use_amp = False
    gen = torch.Generator().manual_seed(6)
    lq = torch.rand(batch, 6, gt_size // 3, gt_size // 3, generator=gen) * 2 - 1
    gt = torch.rand(batch, 6, gt_size, gt_size, generator=gen) * 2 - 1
    size = opt['network_g']['unet_args']['image_size']
    steps = model.base_diffusion.num_timesteps

    def groups(lq, gt):   # the L2S layout: the GT's NSS on half the grid
        return {'lq': {'rgb': lq[:, :3], 'nss': lq[:, 3:]},
                'gt': {'rgb': gt[:, :3], 'nss': gt[:, 3:, ::2, ::2]}}

    train_batch = dict(groups(lq, gt), tt=torch.randint(0, steps, (batch,), generator=gen),
                       noise=torch.randn(batch, 6, size, size, generator=gen))
    request = groups(lq[:1], gt[:1])

    def step_and_request():
        model.feed_data(train_batch)
        model.net_g.zero_grad(set_to_none=True)
        loss, _ = model.compute_losses()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.net_g.named_parameters()}
        model.feed_data(request)
        model.generator.manual_seed(7)   # the same noises in both runs
        model.test()
        return model.output.detach().clone(), loss.item(), grads

    wrappers = attention_wrappers()
    counts = {k: w.launches for k, w in wrappers.items()}
    out_k, loss_k, grads_k = step_and_request()
    made = {k: w.launches - counts[k] for k, w in wrappers.items()}
    per_forward = swin_blocks(model.net_g.unet)
    if made != {'window_attention_fwd': per_forward * (1 + steps),
                'window_attention_bwd': per_forward}:
        fail(f'the kernel run made {made} launches')
    counts = {k: w.launches for k, w in wrappers.items()}
    with mock.patch.object(swinir_arch, 'fused_window_attention', A.reference_window_attention):
        out_p, loss_p, grads_p = step_and_request()
    if counts != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    err = (out_k - out_p).abs().max().item()
    print(f'request output {tuple(out_k.shape)} ({steps} reverse steps, decoded): max abs '
          f'difference {err:.3e} (max|plain| {out_p.abs().max().item():.3e}; tolerance '
          f'{MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('the joint model: the sampled outputs disagree')
    compare_gradients('the joint model', loss_k, grads_k, loss_p, grads_p)
    model.use_amp = True


def serve_joint_align():
    """Phase 30: the joint model sampled through ``basicsr4rs_torch.test``
    on seed-0 weights: a request is the LR encoder, 15 reverse steps of the
    UNet, and the decoder. Returns K6's launches."""
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(ALIGN_JOINT_TEST)
    steps, gt_size = opt['diffusion']['steps'], opt['datasets']['test_1']['gt_size']
    phase(f'30. serve the joint align-diffusion model through basicsr4rs_torch.test on cuda:0 '
          f'(LQ {gt_size // 3}x{gt_size // 3} of 6 bands -> {gt_size}x{gt_size}, batch 1, '
          f'{steps} reverse steps on the 64x64 latent, use_amp)')
    weights = opt['path']['pretrain_network_g']
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    torch.save({'params': random_joint_weights(opt['network_g']).state_dict()}, weights)
    wrappers = attention_wrappers()
    for wr in wrappers.values():
        wr.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', ALIGN_JOINT_TEST, '--force_yml',
                f'datasets:test_1:{L2S_VAL_SPLIT}']
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_request = swin_blocks(model.net_g.unet) * steps
    launches = wrappers['window_attention_fwd'].launches
    print(f'pipeline wall time {wall:.3f} s ({L2S_VAL_IMAGES} requests, '
          f'{len(opt["val"]["metrics"])} metrics each, image writes); window_attention_fwd '
          f'launches {launches} = {launches / L2S_VAL_IMAGES:g} per request')
    if model.device.type != 'cuda' or launches != per_request * L2S_VAL_IMAGES \
            or wrappers['window_attention_bwd'].launches:
        fail(f'expected {per_request} forward launches per request on cuda and no backward '
             f'launch, counted {launches} on {model.device}')
    vis = model.opt['path']['visualization']
    names = check_metric_csv(os.path.join(vis, f'L2S_square_val_{model.opt["name"]}.csv'),
                             opt['val']['metrics'], L2S_VAL_IMAGES)
    check_band_outputs(vis, 'L2S_square_val', names, gt_size)
    dataset_opt = model.opt['datasets']['test_1']
    loader = list(build_dataloader(build_dataset(dataset_opt), dataset_opt))
    latencies = request_latencies(model, loader, lambda item: (1, 6, gt_size, gt_size),
                                  (wrappers['window_attention_fwd'], per_request))
    print(f'request latency: ' + ', '.join(f'{ms:.3f}' for ms in latencies) + ' ms (mean '
          f'{np.mean(latencies):.3f}, {np.mean(latencies) / steps:.3f} ms a reverse step, '
          f'encoders and decoder included); peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    launches = wrappers['window_attention_fwd'].launches

    phase('30b. device time of a joint align-diffusion request by kernel (torch.profiler)')

    def request():
        model.feed_data(loader[0])
        model.test()

    profile_device_time(request, 1, 'request', tuple(wrappers),
                        'align_joint_request_profile.json')
    del model
    return launches


def train_srcnn():
    """Phase 31: SRCNN x3 on 6 bands through ``basicsr4rs_torch.train``
    (``L2SSingleModel``) at the published batch, GT and use_amp."""
    from basicsr4rs_torch.models.srrs_l2s_model import L2SSingleModel
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(SRCNN_TRAIN)
    train_opt = opt['datasets']['train']
    phase(f'31. train SRCNN x3 on 6 bands through basicsr4rs_torch.train on cuda:0 (batch '
          f'{train_opt["batch_size_per_gpu"]}, GT {train_opt["gt_size"]}, use_amp; no TPU kernel '
          'on this path)')
    wrappers = attention_wrappers()
    fresh_run(opt, wrappers)
    record = {'steps': []}
    model = run_train_pipeline(['--force_yml', f'datasets:val:{L2S_VAL_SPLIT}'], record,
                               config=SRCNN_TRAIN, model_cls=L2SSingleModel, wrappers=wrappers)
    if model.device.type != 'cuda' or not model.use_amp:
        fail(f'the model trained on {model.device}, use_amp {model.use_amp}')
    check_steps(record['steps'], opt['train']['total_iter'], 'l_pix', {})
    after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step 1, '
          f'{after:.6f} after step {opt["train"]["total_iter"]}')
    if not after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')
    check_validation(model, opt, 'L2S_single_val', train_opt['gt_size'])
    del model


def align_paths(launches):
    """Phases 28 to 31: the registration autoencoder, the joint
    align-diffusion model (trained, checked against the plain versions,
    served) and SRCNN. K6's and K7's launches are added to ``launches``."""
    train_registration()
    model, trained = train_joint_align()
    check_joint_model(model)
    del model
    launches['window_attention_fwd'] += trained['window_attention_fwd'] + serve_joint_align()
    launches['window_attention_bwd'] += trained['window_attention_bwd']
    train_srcnn()


# ------------------------------------------------------------ the video path
def sampler_wrappers():
    from basicsr4rs_torch.ops import dcn as D
    return {'deform_sample_fwd': D.deform_sample_forward,
            'deform_sample_bwd': D.deform_sample_backward}


# groups of device time by kernel name: K9's launches by its template's
# one-tap flag (a warp, or a deformable convolution's nine taps)
SAMPLER_DEVICE_KERNELS = {
    'deform_sample_fwd': 'deform_sample_fwd',
    'deform_sample_bwd nine taps': 'deform_sample_bwd_kernel<float, false>',
    'deform_sample_bwd one tap': 'deform_sample_bwd_kernel<float, true>',
    'deform_sample_bwd, other': 'deform_sample_bwd'}


def plain_sampler():
    """Patches that put the sampler's plain versions in place of both kernels."""
    from basicsr4rs_torch.ops import dcn as D
    return [mock.patch.object(D, 'deform_sample_forward', D.reference_deform_sample),
            mock.patch.object(D, 'deform_sample_backward', D.reference_deform_sample_backward)]


def moving_clip(rng, frames, h, w):
    """``frames`` uint8 frames (h, w, 3): one smooth random image seen through
    a window that moves two pixels right and one down a frame."""
    big = smooth_image(rng, h + frames + 16, w + 2 * frames + 16)
    return [big[i:i + h, 2 * i:2 * i + w] for i in range(frames)]


def write_clips(root, name, clips, lq_size):
    """GT and LQ frames (LQ the bicubic x4 downscale) of ``clips`` {clip:
    frames} under ``<root>/<name>_GT`` / ``_LQ``, and ``meta_info_<name>.txt``."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(sum(map(ord, root + name)))
    h, w = lq_size
    for clip, frames in clips.items():
        for sub in ('GT', 'LQ'):
            os.makedirs(os.path.join(root, f'{name}_{sub}', clip), exist_ok=True)
        for i, gt in enumerate(moving_clip(rng, frames, SCALE * h, SCALE * w)):
            lq = cv2.resize(gt, (w, h), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, f'{name}_GT', clip, f'{i:08d}.png'), gt)
            cv2.imwrite(os.path.join(root, f'{name}_LQ', clip, f'{i:08d}.png'), lq)
    with open(os.path.join(root, f'meta_info_{name}.txt'), 'w') as f:
        f.writelines(f'{clip} {frames} ({SCALE * h},{SCALE * w},3)\n'
                     for clip, frames in clips.items())


def seed0_video_weights(opt, path):
    """Seed-0 random weights of the config's network. The last offset
    convolutions, which start at zero, get small random weights: otherwise
    every deformable sample would sit on a pixel."""
    from basicsr4rs_torch.archs import build_network
    torch.manual_seed(0)
    net = build_network(opt['network_g'])
    with torch.no_grad():
        for name, p in net.named_parameters():
            if 'conv_offset' in name and not p.any():
                p.normal_(0., 0.02 if p.dim() > 1 else 0.5)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'params': net.state_dict()}, path)


def edvr_launches(shape):
    """Sampler launches of one EDVR forward on a window (b, t, c, h, w): PCD
    levels 3, 2, 1 and the cascade, the frames folded into the batch."""
    return 4


def basicvsrpp_launches(shape):
    """Sampler launches of one BasicVSR++ forward on a clip of t frames: 4
    (t - 1) alignments with nine taps; with one tap SpyNet's 6 levels (both
    directions in one batch), a feature warp a step and branch, and a flow
    and a feature warp from a branch's third step on."""
    t = shape[1]
    return 4 * (t - 1) + 6 + 4 * (t - 1) + 8 * (t - 2)


def basicvsr_launches(shape):
    """Sampler launches of one BasicVSR forward on a clip of t frames, all
    with one tap: SpyNet's 6 levels (both directions in one batch) and a
    feature warp a step of each branch but its first."""
    return 6 + 2 * (shape[1] - 1)


def iconvsr_launches(net_opt):
    """IconVSR's forward on a clip (b, t, c, h, w): BasicVSR's warps and 4
    nine-tap launches (PCD's levels and cascade) an EDVR extractor call, one
    call a group of keyframes (the port's ``keyframe_groups``)."""
    def launches(shape):
        from basicsr4rs_torch.archs.basicvsr_arch import keyframe_groups
        b, t, _, h, w = shape
        groups = keyframe_groups(b, t, -(-h // 4) * 4, -(-w // 4) * 4, net_opt['keyframe_stride'],
                                 net_opt['temporal_padding'])
        return basicvsr_launches(shape) + 4 * len(groups)
    return launches


def tof_launches(shape):
    """TOFlow's eval forward: its SpyNet's 4 levels and the frames' warp, the
    six support frames folded into the batch."""
    return 5


def basicvsrpp_memory_stages(net):
    """BasicVSR++'s request stage by stage (``MemoryMarks``): where its
    memory goes."""
    stages = [('feat_extract', net.feat_extract, 'forward'),
              ('compute_flow (SpyNet)', net, 'compute_flow'),
              (lambda feats, flows, module: f'propagate {module}', net, 'propagate'),
              ('upsample', net, 'upsample')]
    return stages + [(f'  {name}', getattr(net, name), 'forward') for name in (
        'reconstruction', 'upconv1', 'upconv2', 'pixel_shuffle', 'conv_hr', 'lrelu', 'conv_last')]


VIDEO = {
    'EDVR-M': dict(
        test_config='options/test/EDVR/test_EDVR_M_x4_synthetic.yml',
        train_config='options/train/EDVR/train_EDVR_M_x4_synthetic.yml',
        data='datasets/EDVR_M_x4_synthetic',
        # 2 clips of 5 frames (reflection_circle needs as many as the window):
        # 10 requests, each a window of 5 frames
        clips={'test': ({'300': 5, '301': 5}, VIDEO_LQ),
               'train': ({'100': 8, '101': 8}, (80, 80)), 'val': ({'200': 5}, (64, 64))},
        forward_launches=edvr_launches, backward_skipped=0, train_frames=EDVR_FRAMES,
        boundary_key='tsa_iter', frozen=('conv_first.weight',), free='fusion.feat_fusion.weight',
        profiled=1),   # one request and one step by kernel: the run's time limit
    'BasicVSR++': dict(
        test_config='options/test/BasicVSRPP/test_BasicVSRPP_x4_synthetic.yml',
        train_config='options/train/BasicVSRPP/train_BasicVSRPP_x4_synthetic.yml',
        data='datasets/BasicVSRPP_x4_synthetic',
        # one clip of 30 frames: one request
        clips={'test': ({'300': 30}, VIDEO_LQ),
               'train': ({'100': 32, '101': 32}, (72, 72)), 'val': ({'200': 4}, (64, 64))},
        # SpyNet's first warp has a zero flow and an input image: no backward
        forward_launches=basicvsrpp_launches, backward_skipped=1, train_frames=30,
        boundary_key='fix_flow', frozen=('spynet.basic_module.5.basic_module.0.weight',),
        free='conv_last.weight', all_frames=True, memory_stages=basicvsrpp_memory_stages,
        # one request profiled and no step (31 to 38 s): the run's time limit
        profiled=1, profiled_steps=0),
}


def write_vimeo(root, seqs, lq_size):
    """Vimeo90K septuplets: GT ``<root>/GT/<seq>/im1..7.png`` (moving
    clips), LQ their bicubic x4 downscale under ``BIx4``; ``meta_info_train``
    lists all, ``meta_info_test`` the first two; and a validation clip of 7
    frames of 64x64 (``val_GT``, ``val_LQ``)."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(7)
    h, w = lq_size
    for seq in seqs:
        for sub in ('GT', 'BIx4'):
            os.makedirs(os.path.join(root, sub, seq), exist_ok=True)
        for i, gt in enumerate(moving_clip(rng, 7, SCALE * h, SCALE * w), start=1):
            cv2.imwrite(os.path.join(root, 'GT', seq, f'im{i}.png'), gt)
            cv2.imwrite(os.path.join(root, 'BIx4', seq, f'im{i}.png'),
                        cv2.resize(gt, (w, h), interpolation=cv2.INTER_CUBIC))
    for name, listed in (('train', seqs), ('test', seqs[:2])):
        with open(os.path.join(root, f'meta_info_{name}.txt'), 'w') as f:
            f.writelines(f'{seq} 7 ({SCALE * h},{SCALE * w},3)\n' for seq in listed)
    write_clips(root, 'val', {'calendar': 7}, (64, 64))


def write_vid_clip(root, lq_dir, gt_size, frames, upsampled):
    """One clip ``clip`` of GT frames of ``gt_size`` under ``<root>/GT`` and
    their bicubic x4 downscale under ``<root>/<lq_dir>``, upsampled back to
    the GT's size by bicubic (TOFlow's ``BIx4up_direct``) when ``upsampled``."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(sum(map(ord, root)))
    h, w = gt_size
    for sub in ('GT', lq_dir):
        os.makedirs(os.path.join(root, sub, 'clip'), exist_ok=True)
    for i, gt in enumerate(moving_clip(rng, frames, h, w)):
        lq = cv2.resize(gt, (w // SCALE, h // SCALE), interpolation=cv2.INTER_CUBIC)
        if upsampled:
            lq = cv2.resize(lq, (w, h), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(root, 'GT', 'clip', f'{i:08d}.png'), gt)
        cv2.imwrite(os.path.join(root, lq_dir, 'clip', f'{i:08d}.png'), lq)


VIMEO_DIR = 'datasets/Vimeo90K_synthetic'
VIMEO_SEQS = ['00001/0001', '00001/0002', '00002/0001', '00002/0002']
BASICVSR_REDS = dict(
    data='datasets/BasicVSR_REDS_synthetic',
    # one clip of 30 frames at the REDS4 size, one request; training clips
    # of 16 frames (LQ 72x72: GT 256 crops), a validation clip of 4
    clips={'test': ({'300': 30}, VIDEO_LQ),
           'train': ({'100': 16, '101': 16}, (72, 72)), 'val': ({'200': 4}, (64, 64))},
    backward_skipped=1, all_frames=True, resume=False, profiled=0, warm=False,
    gradients='network')
# the recurrent video slice's paths (phases 37 to 44), in VIDEO's terms;
# ``write``: the test data's writer where the REDS clips do not serve
RECURRENT = {
    'BasicVSR': dict(
        BASICVSR_REDS, test_config='options/test/BasicVSR/test_BasicVSR_REDS_synthetic.yml',
        train_config='options/train/BasicVSR/train_BasicVSR_REDS_synthetic.yml',
        forward_launches=basicvsr_launches, train_frames=15, boundary_key='fix_flow',
        frozen=('spynet.basic_module.5.basic_module.0.weight',), free='conv_last.weight'),
    'IconVSR': dict(
        BASICVSR_REDS, test_config='options/test/BasicVSR/test_IconVSR_REDS_synthetic.yml',
        forward_launches=iconvsr_launches(dict(keyframe_stride=5, temporal_padding=2)),
        profiled=0),
    'IconVSR Vimeo90K': dict(
        test_config='options/test/BasicVSR/test_IconVSR_Vimeo90K_BIx4_synthetic.yml',
        train_config='options/train/BasicVSR/train_IconVSR_Vimeo90K_BIx4_synthetic.yml',
        data=VIMEO_DIR, write=lambda: write_vimeo(VIMEO_DIR, VIMEO_SEQS, VIMEO_LQ),
        clips={'test': ({'vimeo90k': 2}, VIMEO_LQ)},
        forward_launches=iconvsr_launches(dict(keyframe_stride=5, temporal_padding=3)),
        backward_skipped=1, train_frames=14, boundary_key='fix_flow',
        frozen=('spynet.basic_module.5.basic_module.0.weight', 'edvr.conv_first.weight',
                'edvr.pcd_align.dcn_pack.l1.weight'), free='conv_last.weight', resume=False,
        profiled=0, warm=False, gradients='network',
        saved=1),   # the two septuplets' centre frames share a name
    'EDVR-L Vimeo90K': dict(
        test_config='options/test/EDVR/test_EDVR_L_x4_SR_Vimeo90K_synthetic.yml',
        data=VIMEO_DIR, write=lambda: write_vimeo(VIMEO_DIR, VIMEO_SEQS, VIMEO_LQ),
        clips={'test': ({'vimeo90k': 2}, VIMEO_LQ)}, forward_launches=edvr_launches,
        profiled=0, warm=False),
    'TOFlow': dict(
        test_config='options/test/TOF/test_TOF_synthetic.yml', data='datasets/TOF_synthetic',
        write=lambda: write_vid_clip('datasets/TOF_synthetic', 'BIx4up_direct', TOF_SIZE, 7,
                                     True),
        clips={'test': ({'clip': 7}, TOF_SIZE)}, forward_launches=tof_launches, scale=1,
        profiled=0, warm=False),
    'DUF': dict(
        test_config='options/test/DUF/test_DUF_synthetic.yml', data='datasets/DUF_synthetic',
        write=lambda: write_vid_clip('datasets/DUF_synthetic', 'BIx4', (576, 720), 7, False),
        clips={'test': ({'clip': 7}, (144, 180))}, forward_launches=lambda shape: 0,
        profiled=0, warm=False, timed=1),
}


def video_spec(name):
    return VIDEO[name] if name in VIDEO else RECURRENT[name]


def iconvsr_memory_stages(net):
    """IconVSR's request stage by stage: the keyframes' EDVR features, the
    flows, the head (the branches run between the last two marks)."""
    return [('keyframe_features (EDVR)', net, 'keyframe_features'),
            ('SpyNet', net.spynet, 'forward'), ('_head', net, '_head')]


RECURRENT['IconVSR']['memory_stages'] = iconvsr_memory_stages


def serve_video(name, number):
    """Serve one video model through ``basicsr4rs_torch.test``; then time
    requests, repeat one on the plain versions, and profile one or two."""
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.utils.options import yaml_load
    spec = video_spec(name)
    opt = yaml_load(spec['test_config'])
    clips, lq_size = spec['clips']['test']
    scale = spec.get('scale', SCALE)
    phase(f'{number}. serve {name} x4 through basicsr4rs_torch.test on cuda:0 '
          f'(LQ {lq_size[0]}x{lq_size[1]})')
    if 'write' in spec:
        spec['write']()
    else:
        write_clips(spec['data'], 'test', clips, lq_size)
    seed0_video_weights(opt, opt['path']['pretrain_network_g'])
    wrappers = sampler_wrappers()
    for w in wrappers.values():
        w.launches = 0
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', spec['test_config']]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrappers['deform_sample_fwd'].launches
    # the requests to time (the items of a set share a shape: the count is
    # the first one's for each)
    requests = len(model_loader(model).dataset)
    loader = list(itertools.islice(model_loader(model), spec.get('timed', 4)))
    flip = 2 if opt['val'].get('flip_seq') else 1   # the network sees the clip and its reverse
    b, t, c, h, w = loader[0]['lq'].shape
    expected = requests * spec['forward_launches']((b, flip * t, c, h, w))
    print(f'pipeline wall time {wall:.3f} s (model build, weight load, {requests} requests, '
          f'metrics, image writes); sampler launches {launches}, '
          f'{launches / requests:g} a request; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    if launches != expected or wrappers['deform_sample_bwd'].launches != 0:
        fail(f'expected {expected} forward launches of the sampler and no backward, counted '
             f'{launches} and {wrappers["deform_sample_bwd"].launches}')
    for folder, rows in model.metric_results_per_folder.items():
        print(f'clip {folder}: ' + ', '.join(
            f'{metric} {rows[:, i].mean():.4f}' for i, metric in
            enumerate(opt['val']['metrics'])) + f' over {len(rows)} rows (random weights)')
        if not np.isfinite(rows).all():
            fail(f'a metric of clip {folder} is not finite')
    frames = spec.get('saved', sum(clips.values()))
    saved = sum(len(files) for _, _, files in os.walk(
        os.path.join(model.opt['path']['visualization'],
                     next(iter(opt['datasets'].values()))['name'])))
    if saved != frames:
        fail(f'{saved} images saved, expected {frames}')

    # latency of the model's own test(), after a warm-up request
    def want(item):   # the recurrent models return every frame, the others the centre one
        frames = ((item['lq'].shape[1], 3) if spec.get('all_frames')
                  and not opt['val'].get('center_frame_only') else (3,))
        return (1,) + frames + (scale * lq_size[0], scale * lq_size[1])

    latencies = request_latencies(model, loader, want, warm=spec.get('warm', True))
    for item, ms in zip(loader, latencies):
        t, shape = item['lq'].shape[1], want(item)
        frames_out = t if len(shape) == 5 else 1
        print(f'request of {t} LQ frames {lq_size[0]}x{lq_size[1]} -> {frames_out} frames '
              f'{shape[-2]}x{shape[-1]}: {ms:.3f} ms, {ms / frames_out:.3f} ms an output frame')
    print(f'request latency: mean {sum(latencies) / len(latencies):.3f} ms of {len(latencies)}; '
          f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    if 'memory_stages' in spec:   # where the request's memory goes
        net = getattr(model.net_g, 'module', model.net_g)
        model.feed_data(loader[0])
        torch.cuda.empty_cache()
        with MemoryMarks(spec['memory_stages'](net)) as marks:
            model.test()
        marks.show(f'{name} request of {loader[0]["lq"].shape[1]} frames')

    if expected:   # one request through the kernels and through the plain versions
        before = wrappers['deform_sample_fwd'].launches
        model.feed_data(loader[-1])
        model.test()
        with_kernels = model.output.float().clamp(0, 1)
        per_request = wrappers['deform_sample_fwd'].launches - before
        patches = plain_sampler()
        for p in patches:
            p.start()
        try:
            model.test()
        finally:
            for p in patches:
                p.stop()
        if wrappers['deform_sample_fwd'].launches != before + per_request:
            fail('the plain request launched a kernel')
        err = (with_kernels - model.output.float().clamp(0, 1)).abs().max().item()
        print(f'kernels vs plain versions, one request: max abs difference on the [0, 1] '
              f'output {err:.3e} (tolerance {MODEL_TOLERANCE})')
        if err > MODEL_TOLERANCE:
            fail(f'{name}: the request differs between kernels and plain versions')

    profiled = spec.get('profiled', 2)
    if profiled:
        phase(f'{number}b. device time of {"a" if profiled == 1 else profiled} {name} '
              f'request{"s" * (profiled > 1)} by kernel (torch.profiler)')
        model.feed_data(loader[0])
        profile_device_time(model.test, profiled, 'request', SAMPLER_DEVICE_KERNELS,
                            f'{tag_of(name)}_request_profile.json')
    del model
    torch.cuda.empty_cache()
    return launches, sum(latencies) / len(latencies)


def tag_of(name):
    """A file name's part for a path's name: 'IconVSR Vimeo90K' ->
    'iconvsr_vimeo90k', 'BasicVSR++' -> 'basicvsrpp'."""
    return name.lower().replace('+', 'p').replace(' ', '_').replace('-', '_')


def train_video(name, number):
    """Train one video model through ``basicsr4rs_torch.train`` for the
    config's 8 iterations; then resume for two more (unless the spec says
    ``resume=False``) and profile one or two steps."""
    import glob
    import shutil

    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.registry import MODEL_REGISTRY
    spec = video_spec(name)
    opt = yaml_load(spec['train_config'])
    total_iter, boundary = opt['train']['total_iter'], opt['train'][spec['boundary_key']]
    train_opt = opt['datasets']['train']
    batch, lq = train_opt['batch_size_per_gpu'], train_opt['gt_size'] // SCALE
    phase(f'{number}. train {name} x4 through basicsr4rs_torch.train on cuda:0 (batch {batch} of '
          f'{spec["train_frames"]} LQ frames {lq}x{lq}; {spec["boundary_key"]}: {boundary})')
    if 'write' in spec:
        spec['write']()
    else:
        for part in ('train', 'val'):
            write_clips(spec['data'], part, *spec['clips'][part])
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):
        shutil.rmtree(old)
    model_cls = MODEL_REGISTRY.get(opt['model_type'])
    wrappers = sampler_wrappers()
    for w in wrappers.values():
        w.launches = 0
    forward = spec['forward_launches']((batch, spec['train_frames'], 3, lq, lq))
    backward = forward - spec['backward_skipped']
    frozen, free = spec['frozen'], spec['free']

    def watch(model, record):
        """Before step 1: keep the first batch and the parameters to follow."""
        params = dict(model.net_g.named_parameters())
        record['watched'] = {k: params[k] for k in frozen + (free,)}
        record['previous'] = {k: p.detach().clone() for k, p in record['watched'].items()}
        record['fixed'] = (model.lq.clone(), model.gt.clone())
        record['fixed_loss_before'] = fixed_batch_loss(model, record['fixed'])

    def moved(model, step):
        step['moved'] = {}
        for k, p in record['watched'].items():
            step['moved'][k] = not torch.equal(p, record['previous'][k])
            record['previous'][k] = p.detach().clone()

    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline([], record, config=spec['train_config'], model_cls=model_cls,
                               wrappers=wrappers, before_first_step=watch, after_step=moved)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    if model.device.type != 'cuda' or next(model.net_g.parameters()).device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    steps = record['steps']
    print(f'pipeline wall time {wall:.3f} s for {len(steps)} steps, validations, checkpoints')
    for st in steps:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()) + '; moved: '
              + ', '.join(f'{k} {v}' for k, v in st['moved'].items()))
    if [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'expected steps 1..{total_iter}, ran {[st["iter"] for st in steps]}')
    for st in steps:
        if not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'l_pix is not finite at step {st["iter"]}')
        if st['launches'] != {'deform_sample_fwd': forward, 'deform_sample_bwd': backward}:
            fail(f'step {st["iter"]}: launches {st["launches"]}, expected {forward} forward '
                 f'and {backward} backward')
        # the warm-up discards the frozen parameters' updates before its boundary
        if (any(st['moved'][k] != (st['iter'] >= boundary) for k in frozen)
                or not st['moved'][free]):
            fail(f'step {st["iter"]}: the warm-up boundary is at {boundary}, moved: '
                 f'{st["moved"]}')
    timed = [st['ms'] for st in steps[2:]]
    mean_ms = sum(timed) / len(timed)
    print(f'training step: {mean_ms:.3f} ms mean of steps 3..{total_iter} (min {min(timed):.3f}, '
          f'max {max(timed):.3f}; CUDA events around optimize_parameters, after 2 warm-up '
          f'steps); peak device memory {peak:.1f} MiB')
    print('launches in the run (steps, validations, the fixed batch): '
          + ' '.join(f'{k}={v}' for k, v in launches.items()))
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step '
          f'1, {loss_after:.6f} after step {total_iter} (Adam, lr '
          f'{opt["train"]["optim_g"]["lr"]}, the config\'s)')
    if not loss_after < record['fixed_loss_before']:
        fail('the loss on the fixed batch did not fall')

    # EMA, checkpoint, resume
    check_ema_and_checkpoint(model, build_network(opt['network_g']),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))
    if spec.get('resume', True):
        resumed = {'steps': []}
        run_train_pipeline(['--auto_resume', '--force_yml',
                            f'train:total_iter={total_iter + RESUME_ITERS}'], resumed,
                           config=spec['train_config'], model_cls=model_cls, wrappers=wrappers,
                           before_first_step=lambda model, record: None)
        iters = [st['iter'] for st in resumed['steps']]
        print(f'resumed from {total_iter}.state: ran steps {iters}, l_pix '
              + ' '.join(f'{st["l_pix"]:.6f}' for st in resumed['steps']))
        if iters != list(range(total_iter + 1, total_iter + RESUME_ITERS + 1)):
            fail(f'resume should continue at step {total_iter + 1}, ran {iters}')

    profiled = spec.get('profiled_steps', spec.get('profiled', 2))
    if profiled:
        phase(f'{number}b. device time of {"a" if profiled == 1 else profiled} {name} training '
              f'step{"s" * (profiled > 1)} by kernel (torch.profiler)')
        model.lq, model.gt = record['fixed']
        model.optimize_parameters(total_iter)
        profile_device_time(lambda: model.optimize_parameters(total_iter), profiled, 'step',
                            SAMPLER_DEVICE_KERNELS, f'{tag_of(name)}_step_profile.json')
    del model
    torch.cuda.empty_cache()
    return launches, mean_ms, peak


def check_video_gradients(name, number):
    """One training batch forward and backward through the sampler's kernels
    and through its plain versions: the loss and every parameter's gradient."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.utils.options import yaml_load
    spec = video_spec(name)
    opt = yaml_load(spec['train_config'])
    phase(f'{number}. {name}, forward and backward: kernels vs plain versions, one training batch')
    path = os.path.join('experiments', 'chip_smoke_gradients.pth')
    seed0_video_weights(opt, path)
    net = build_network(opt['network_g'])
    net.load_state_dict(torch.load(path, map_location='cpu', weights_only=True)['params'])
    net = net.cuda().train()
    train_opt = opt['datasets']['train']
    batch, lq = train_opt['batch_size_per_gpu'], train_opt['gt_size'] // SCALE
    rng = __import__('numpy').random.RandomState(5)
    clips = [moving_clip(rng, spec['train_frames'], lq, lq) for _ in range(batch)]
    x = torch.from_numpy(__import__('numpy').stack(
        [[f.transpose(2, 0, 1) for f in clip] for clip in clips])).float().div(255).cuda()
    with torch.no_grad():
        shape = net(x).shape
    gt = torch.rand(shape, generator=torch.Generator().manual_seed(6)).cuda()

    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        loss = torch.sqrt((net(x) - gt)**2 + 1e-12).mean()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

    wrappers = sampler_wrappers()
    counts = {k: w.launches for k, w in wrappers.items()}
    loss_k, grads_k = loss_and_grads()
    if any(w.launches == counts[k] for k, w in wrappers.items()):
        fail('the kernel run launched no kernel')
    counts = {k: w.launches for k, w in wrappers.items()}
    patches = plain_sampler()
    for p in patches:
        p.start()
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    if counts != {k: w.launches for k, w in wrappers.items()}:
        fail('the plain run launched a kernel')
    compare_gradients(name, loss_k, grads_k, loss_p, grads_p, spec.get('gradients', 'tensor'))


# ------------------------------------------- the serving modes of the image-SR path
PEAK_OPS_INT8 = 1979e12   # dense int8 on the tensor cores (the data sheet's rate)
CONV_SHAPES = [            # (B, Cin, Cout, H, W, residual, slope): how SwinIR-M x4 calls K10
    (1, 180, 180, 128, 128, True, None),    # RSTB tail and conv_after_body, LQ 128x128
    (16, 180, 180, 64, 64, True, None),     # the same at the batched serving shape
    (1, 180, 64, 128, 128, False, 0.01),    # conv_before_upsample
    (1, 64, 256, 128, 128, False, None),    # Upsample, LQ map
    (1, 64, 256, 256, 256, False, None),    # Upsample, 2x map
    (1, 64, 64, 512, 512, False, 0.2),      # nearest+conv: conv_hr on the 4x map
    (1, 180, 180, 125, 94, True, None),     # a map that is no multiple of 8
]
CNN_CONV_SHAPES = [        # as CONV_SHAPES: how EDSR-L x4 and RCAN x2 train through K10
    (16, 256, 1024, 48, 48, False, None),   # EDSR-L's first upsampler conv, GT 192
    (16, 256, 1024, 96, 96, False, None),   # its second
    (16, 64, 256, 48, 48, False, None),     # RCAN x2's one, GT 96
]
# K11 against its plain version. The integer sums are exact in both, but the
# values that are quantised come from float32 arithmetic in another order
# (LayerNorm, softmax, the dequantised products), so a value that sits on a
# half can round to the next integer in one and not in the other, and
# everything downstream in that window then differs by far more than
# F32_TOL. So the kernel also writes out the integers and scales it fed to
# its four products, and the plain version is run a second time downstream
# of them (each product takes the kernel's integers in place of its own).
# The rule, with nothing fitted to a reading:
# - every integer of the kernel equals the plain version's rounding of what
#   it finds at that place, or differs from it by one step where the
#   unrounded value lies within INT8_HALF_EPS steps of a half (float32
#   rounding noise there is about 1e-5 steps); every scale agrees to
#   INT8_SCALE_TOL. In bfloat16 the attention output, which proj reads,
#   agrees between kernel and plain version to BF16_TOL of its largest value
#   only (they round q, k, v, p and the output to bfloat16 at different
#   places), and the largest value is 127 steps: proj's scales may differ by
#   BF16_TOL and its integers by 127 BF16_TOL steps and one for the rounding.
# - the output is within F32_TOL (BF16_TOL) of that second plain run, in
#   every element;
# - against the plain version on its own (whose integers then differ from
#   the kernel's at those flips, at a few more that an ulp of a scale brings,
#   and downstream of both), only windows that hold a differing integer may
#   leave F32_TOL, and a window's error stays under INT8_FLIP_REACH times
#   the sum over its differing integers of s_x * max|w|, which is what one
#   step moves the product it enters by (127 steps of s_x * s_w); the factor
#   is for the softmax, the GELU and the later products on the way.
INT8_HALF_EPS = 1e-3
INT8_SCALE_TOL = 1e-5
INT8_FLIP_REACH = 4.
# int8 block against the float block: the JAX package's criterion
# (tests/test_ops/test_swin_block.py): SNR and the largest deviation over the range
INT8_BLOCK_SNR_DB, INT8_BLOCK_MAX_DEV = 30., 0.1
# bfloat16 K11's output against the float32 float block on the same inputs
# (full-scale weights, block_inputs): a bound set 3 dB under the lowest
# reading of this script on an NVIDIA H100 80GB HBM3 (38.14 to 38.25 dB at
# B=1 128x128 and B=16 64x64, shift 0 and 4; the values come from a seed)
INT8_BLOCK_SNR_BF16_DB = 35.1
# The models' int8 outputs against their float outputs. Under the
# configs' own initialisation (linears of std 0.02, MSRResNet's convolutions
# scaled by 0.1) the quantised layers' branches lie far under the residual
# stream and the skip, and an int8 route a hundred times too noisy would
# still read 80 dB at the output. So both phases redraw the weights of the
# layers that are quantised at std 1/sqrt(fan_in), as phase 3f does
# (MSRResNet's residual blocks keep their factor of 0.1, on the second
# convolution: at full scale the noise of 35 quantised convolutions in a row
# adds up to 22.7 dB, under the JAX package's bound), and hold an SNR to a
# bound set 3 dB under the lowest reading of this script on an NVIDIA H100
# 80GB HBM3 (the values come from a seed: the readings repeat). SwinIR-M:
# the output, read at 53.85 and 53.91 dB. MSRResNet: the branch, which is the
# output less its bilinear skip, read at 33.29 to 33.69 dB; the output itself
# (60.7 dB, most of it the skip) keeps the JAX package's bound
# (tests/test_ops/test_quant.py:148).
INT8_MODEL_SNR_DB = 50.8
INT8_CONV_BRANCH_SNR_DB = 30.2
INT8_CONV_SNR_DB = 28.
# tiling a window-attention model is approximate (each tile sees its halo, not
# the image): the bound of tests/test_torch_tile.py on the [0, 1] output
TILE_APPROX_TOLERANCE = 0.05
MS_CONFIG = 'options/test/SRResNet_SRGAN/test_MSRResNet_x4_synthetic.yml'
MS_TRAIN_CONFIG = 'options/train/SRResNet_SRGAN/train_MSRResNet_x4_synthetic.yml'
MS_DATA_DIR = 'datasets/MSRResNet_x4_synthetic'
MS_LQ_SIZES = [(128, 128), (96, 160)]
TILED_DIR = 'datasets/SwinIR_M_x4_tiled'
TILED_LQ, TILE, TILE_PAD = 512, 128, 32
JOINT_TRAIN_ITERS = 4


def snr_db(ref, got):
    ref, got = ref.double(), got.double()
    return (10 * torch.log10(ref.square().mean() / ((got - ref).square().mean() + 1e-30))).item()


def psnr_db(ref, got):
    """PSNR of two [0, 1] images."""
    mse = (ref.double().clamp(0, 1) - got.double().clamp(0, 1)).square().mean().item()
    return 10 * torch.log10(torch.tensor(1. / max(mse, 1e-30))).item()


# the layouts phase 3e hands K10 at the RSTB's shape, beside the NCHW ones of
# CONV_SHAPES: channels-last memory, and the RSTB's own view of its tokens
CONV_LAYOUTS = ('channels_last', 'token view')


def conv_operand(t, layout):
    """``t`` (B, C, H, W) in one of the layouts K10 takes."""
    if layout == 'nchw':
        return t
    if layout == 'channels_last':
        return t.contiguous(memory_format=torch.channels_last)
    b, c, h, w = t.shape   # tokens (B, HW, C), seen as the RSTB sees them
    return t.flatten(2).transpose(1, 2).contiguous().transpose(1, 2).reshape(b, c, h, w)


def check_conv_kernel(title, shapes, dtypes=(torch.float32, torch.bfloat16), layouts=()):
    """K10 against its plain version at ``shapes`` (each a row of
    ``CONV_SHAPES``' layout) in NCHW, the first of them also in each of
    ``layouts``, in each of ``dtypes``: four epilogues compared, the model's
    own timed beside ``F.conv2d`` with PyTorch's epilogue and beside the
    plain version, with its bound and its device and host time. Returns the
    largest float32 error and each case's times under its tag."""
    import torch.nn.functional as F

    from basicsr4rs_torch.ops import conv3x3 as K
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3, reference_conv3x3
    phase(title)
    lib = K._lib()
    print('K10 (mma.sync: 3xTF32 for float32, bfloat16): shared memory a block ' + ', '.join(
        f'{lib.conv3x3_fwd_smem_bytes(n)} bytes at {n} output channels' for n in K.BLOCK_N)
        + '; registers and spills in phase 2')
    gen = torch.Generator().manual_seed(5)
    summary = {'max_abs_err': 0.}
    cases = [(shape, 'nchw') for shape in shapes] + [(shapes[0], layout) for layout in layouts]
    for (b, cin, cout, h, w, model_res, model_slope), layout in cases:
        for dt in dtypes:
            x = conv_operand(torch.randn(b, cin, h, w, generator=gen).cuda().to(dt), layout)
            weight = (torch.randn(cout, cin, 3, 3, generator=gen) * (9 * cin)**-.5).cuda()
            bias = (torch.randn(cout, generator=gen) * .1).cuda()
            res = conv_operand(torch.randn(b, cout, h, w, generator=gen).cuda().to(dt), layout)
            worst = 0.
            for with_res, slope in ((False, None), (True, None), (False, 0.2), (True, 0.01)):
                r = res if with_res else None
                with torch.no_grad():
                    got = fused_conv3x3(x, weight, bias, r, slope)
                    want = reference_conv3x3(x, weight, bias, r, slope)
                torch.cuda.synchronize()
                ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
                worst = max(worst, max_abs)
                if not ok or not got.is_contiguous(memory_format=torch.channels_last):
                    fail(f'K10 and plain version disagree at {(b, cin, cout, h, w)} {layout} {dt} '
                         f'residual={with_res} slope={slope}: max_abs_err={max_abs:.3e} '
                         f'({tolerance}), or the output is not channels-last')
            r = res if model_res else None
            wd, bd = weight.to(dt), bias.to(dt)

            def library():    # one cuDNN convolution and PyTorch's own epilogue
                out = F.conv2d(x, wd, bd, padding=1)
                if r is not None:
                    out = out + r
                return out if model_slope is None else F.leaky_relu(out, model_slope)

            def kernel():
                return fused_conv3x3(x, weight, bias, r, model_slope)

            with torch.no_grad():
                kernel_ms, library_ms = time_pair(library, kernel)
                plain_ms = cuda_time_ms(lambda: reference_conv3x3(x, weight, bias, r, model_slope))
                device_ms = kernel_device_ms(kernel, iters=5)
                k10_ms = kernel_device_ms(kernel, iters=5, only='conv3x3_fwd_kernel')
                library_device_ms = kernel_device_ms(library, iters=5)
                call_us = host_us(kernel, iters=50)
            es = torch.finfo(dt).bits // 8
            flop = 2 * 9 * cin * cout * b * h * w
            nbytes = (b * h * w * (cin + cout * (2 if model_res else 1)) + 9 * cin * cout) * es \
                + 4 * cout
            (bound, by), core_bound = tensor_core_bound_ms(flop, nbytes, dt)
            print(f'B={b} {cin}->{cout} {h}x{w} {layout:13s} {str(dt)[6:]:8s} residual={model_res} '
                  f'slope={model_slope}: four epilogues max_abs_err={worst:.3e} | kernel '
                  f'{kernel_ms:.4f} ms, F.conv2d + epilogue {library_ms:.4f} ms (ratio '
                  f'{kernel_ms / library_ms:.2f}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms '
                  f'by {by} on the route ({100 * bound / kernel_ms:.0f}%), CUDA-core bound '
                  f'{core_bound:.4f} ms | device: the call {show_ms(device_ms)} of which K10 '
                  f'{show_ms(k10_ms)}, the library {show_ms(library_device_ms)}; host '
                  f'{call_us:.1f} us a call', flush=True)
            if dt == torch.float32:
                summary['max_abs_err'] = max(summary['max_abs_err'], worst)
            summary[conv_case_tag(b, cin, cout, h, w, layout, dt)] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by=by, device_ms=device_ms, kernel_device_ms=k10_ms,
                library_device_ms=library_device_ms)
            del x, res, got, want
    return summary


def conv_case_tag(b, cin, cout, h, w, layout, dt):
    return f'B={b} {cin}->{cout} {h}x{w} {layout} {str(dt)[6:]}'


def check_conv_gradients():
    """K10's gradients: the backward is PyTorch's library on the kernel's
    saved output, with x and the residual channels-last as the RSTB hands
    them over."""
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3, reference_conv3x3
    gen = torch.Generator().manual_seed(7)
    for layout in ('nchw', 'token view'):
        x = conv_operand(torch.randn(2, 64, 48, 48, generator=gen).cuda(), layout).requires_grad_()
        weight = (torch.randn(64, 64, 3, 3, generator=gen) / 24).cuda().requires_grad_()
        bias = torch.randn(64, generator=gen).cuda().requires_grad_()
        res = conv_operand(torch.randn(2, 64, 48, 48, generator=gen).cuda(), layout)
        res.requires_grad_()
        leaves = (x, weight, bias, res)
        got = torch.autograd.grad(fused_conv3x3(*leaves, 0.2).square().sum(), leaves)
        want = torch.autograd.grad(reference_conv3x3(*leaves, 0.2).square().sum(), leaves)
        for name, g, wnt in zip(('dx', 'd_weight', 'd_bias', 'd_residual'), got, want):
            ok, max_abs, max_rel, tolerance = compare(g, wnt, torch.float32, 'sum')
            print(f'gradient {name} ({layout}): max_abs_err={max_abs:.3e} '
                  f'max_rel_err={max_rel:.3e} ({tolerance})')
            if not ok:
                fail(f'K10 gradient {name} disagrees ({layout})')


def check_conv_kernels():
    """Phases 3e and 3g: K10 at the shapes SwinIR-M x4 gives it, its
    gradients, and at the upsampler convolutions of EDSR-L x4 and RCAN x2.
    The summary's times are the RSTB tail's at LQ 128x128 in float32 as the
    main path calls it (the token view); each case's stand beside them."""
    summary = check_conv_kernel(
        '3e. 3x3 convolution kernel (K10) vs plain version, at the shapes SwinIR-M x4 gives it',
        CONV_SHAPES, layouts=CONV_LAYOUTS)
    check_conv_gradients()
    worst = summary['max_abs_err']
    summary.update(summary[conv_case_tag(*CONV_SHAPES[0][:5], 'token view', torch.float32)])
    summary.update(check_conv_kernel_cnn())
    summary['max_abs_err'] = max(summary['max_abs_err'], worst)
    return {'conv3x3_fwd': summary}


def check_conv_kernel_cnn():
    return check_conv_kernel(
        '3g. K10 at EDSR-L x4\'s and RCAN x2\'s upsampler convolutions (B=16, float32) vs '
        'plain version and F.conv2d + bias', CNN_CONV_SHAPES, dtypes=(torch.float32,))


def int8_block_work(b, h, w, dtype, shifted, widths=M_WIDTHS):
    """(int8 operations, model-dtype operations, bytes) of one W8A8 block:
    the four weight products in int8, q.k and p.v in the model dtype; x in, out back,
    int8 weights, scales and the small float operands once."""
    c, heads, ws, hid = widths
    t, n, es = b * h * w, ws * ws, torch.finfo(dtype).bits // 8
    small = 4 * (8 * c + hid) + 4 * heads * n * n + 4 * (5 * c + hid)
    mask = 4 * (h // ws) * (w // ws) * n * n if shifted else 0
    return (t * (8 * c * c + 4 * c * hid), t * 4 * n * c,
            2 * t * c * es + 4 * c * c + 2 * c * hid + small + mask)


def check_int8_flips(got, rec, plain_rec, forced, want, want_rec, dt, weights, tag):
    """Holds one K11 output to the rule above. ``rec``: the kernel's (q, s)
    of the four products; ``plain_rec``: the plain version's (q, s, r)
    downstream of them; ``forced``: its output there; ``want``, ``want_rec``:
    its output and its (q, s, r) on its own; ``weights``: the largest |w| of
    each product's float weight. Returns the line to print and the largest
    error against ``want``."""
    f32 = dt == torch.float32
    b, hw, ww = rec[0][1].shape
    reach = torch.zeros(b, hw, ww, device='cuda')   # sum over differing integers of s_x max|w|
    counts = []
    for name, (q, s), (qp, sp, r), (qw, _, _), wmax in zip(
            ('qkv', 'proj', 'fc1', 'fc2'), rec, plain_rec, want_rec, weights):
        exact = f32 or name != 'proj'
        scale_err = ((s - sp).abs() / sp).max().item()
        if not scale_err <= (INT8_SCALE_TOL if exact else BF16_TOL):
            fail(f'K11 {tag}: the scales of {name} differ by {scale_err:.2e} of the plain ones')
        d = q.int() - qp.int()
        flip = d != 0
        from_half = ((r - r.floor()) - .5).abs()
        most = 1 if exact else int(127 * BF16_TOL) + 1
        if int(d.abs().max()) > most or (
                exact and bool((flip & (from_half > INT8_HALF_EPS)).any())):
            far = from_half[flip].max().item() if flip.any() else 0.
            fail(f'K11 {tag}: an integer of {name} differs from the plain rounding by '
                 f'{int(d.abs().max())} steps, or by one where the value lies {far:.2e} steps '
                 f'from a half (allowed {INT8_HALF_EPS})')
        steps = (q.int() - qw.int()).abs().reshape(b, hw, WS, ww, WS, -1).sum(dim=(2, 4, 5))
        reach += steps * s * wmax
        counts.append(f'{name} {int(flip.sum())}' + ('' if exact else f' (by <= {most} steps)')
                      + (f' (<= {from_half[flip].max().item():.1e} from a half)'
                         if exact and flip.any() else ''))
    ok, max_abs, max_rel, tolerance = compare(got, forced, dt, 'elementwise')
    line = (f'{tag}: integers that differ from the plain rounding: {", ".join(counts)}; '
            f'downstream of the kernel\'s integers max_abs_err={max_abs:.3e} '
            f'max_rel_err={max_rel:.3e} ({tolerance})')
    if not ok:
        print(line)
        fail(f'K11 {tag}: the output disagrees with the plain version on the same integers')
    if f32:
        err = (got - want).abs()
        off = err > F32_TOL[0] + F32_TOL[1] * want.abs()
        windows = off.reshape(b, hw, WS, ww, WS, -1).any(5).any(4).any(2)
        worst = err.reshape(b, hw, WS, ww, WS, -1).amax(dim=(2, 4, 5))
        ratio = (worst[windows] / reach[windows]).max().item() if windows.any() else 0.
        line += (f'; against the plain version on its own: {int(windows.sum())} of '
                 f'{windows.numel()} windows beyond F32_TOL, {int((reach > 0).sum())} hold a '
                 f'differing integer, max_abs_err={err.max().item():.3e}, at most {ratio:.2f} of '
                 f'a window\'s differing steps x s_x max|w| (allowed {INT8_FLIP_REACH:g})')
        if bool((windows & (reach == 0)).any()) or ratio > INT8_FLIP_REACH:
            print(line)
            fail(f'K11 {tag}: a window without a differing integer leaves F32_TOL, or one '
                 'errs by more than its differing integers explain')
    return line, (got - want).abs().max().item()


def check_int8_block_kernel():
    from basicsr4rs_torch.ops import swin_block as S
    phase('3f. W8A8 joint block kernel (K11) vs plain version and vs the float block')
    print(f'rule: the kernel\'s integers equal the plain rounding, or differ by one step within '
          f'{INT8_HALF_EPS} steps of a half; scales within {INT8_SCALE_TOL}; the output within '
          f'F32_TOL {F32_TOL} (bfloat16: {BF16_TOL} of max|plain|) of the plain version run on '
          f'those integers; against the plain version on its own only windows with a differing '
          f'integer differ, by at most {INT8_FLIP_REACH:g} x their steps\' s_x max|w|; against '
          f'the float block SNR > {INT8_BLOCK_SNR_DB} dB and max deviation < '
          f'{INT8_BLOCK_MAX_DEV} of the range')
    gen = torch.Generator().manual_seed(6)
    summary = {'max_abs_err': 0.}
    both = (torch.float32, torch.bfloat16)
    cases = [(b, h, w, dt, shift, M_WIDTHS) for b, h, w in ((1, 128, 128), (16, 64, 64))
             for dt in both for shift in (0, 4)]
    # past the float joint kernel's widths: the wide variant (phase 22's widths)
    cases += [(2, 64, 64, dt, shift, widths) for widths in WIDE_WIDTHS for dt in both
              for shift in (0, 4)]
    for b, h, w, dt, shift, widths in cases:
        args = block_inputs(b, h, w, dt, shift, gen, *widths)
        weights = [args[i].abs().max().item() for i in (3, 5, 11, 13)]
        rec, plain_rec, want_rec = [], [], []
        with torch.no_grad():
            got = S.swin_block_full_int8(*args, quantised=rec)
            forced = S.reference_swin_block_full_int8(*args, given=rec,
                                                      quantised=plain_rec)
            want = S.reference_swin_block_full_int8(*args, quantised=want_rec)
            flo = S.reference_swin_block_full(*args)
            plainly = S.swin_block_full_int8(*args)
        torch.cuda.synchronize()
        tag = f'B={b} {h}x{w} {str(dt)[6:]:8s} shift={shift}' + (
            '' if widths == M_WIDTHS else f' C={widths[0]} heads={widths[1]}')
        if not torch.isfinite(got).all():
            fail(f'K11 output is not finite at {tag}')
        if not torch.equal(got, plainly):
            fail(f'K11 {tag}: writing out the integers changed the output')
        line, max_abs = check_int8_flips(got.float(), rec, plain_rec, forced.float(),
                                         want.float(), want_rec, dt, weights, tag)
        del rec, plain_rec, want_rec, forced
        if dt == torch.float32:
            summary['max_abs_err'] = max(summary['max_abs_err'], max_abs)
        else:
            ok, max_abs, max_rel, tolerance = compare(got, want, dt, 'elementwise')
            line += (f'; against the plain version on its own max_rel_err={max_rel:.3e} '
                     f'({tolerance})')
            if not ok:
                print(line)
                fail(f'K11 and plain version disagree at {tag}')
        snr = snr_db(flo.float(), got.float())
        dev = (got.float() - flo.float()).abs().max().item() / flo.float().abs().max().item()
        line += f' | vs float block: SNR {snr:.2f} dB, max deviation {dev:.4f} of the range'
        if snr <= INT8_BLOCK_SNR_DB or dev >= INT8_BLOCK_MAX_DEV:
            print(line)
            fail(f'K11 is too far from the float block at {tag}')
        if dt == torch.bfloat16:
            with torch.no_grad():
                flo32 = S.reference_swin_block_full(
                    *[a.float() if torch.is_tensor(a) else a for a in args])
            snr32 = snr_db(flo32, got.float())
            line += (f', vs the float32 float block SNR {snr32:.2f} dB (bound '
                     f'{INT8_BLOCK_SNR_BF16_DB})')
            del flo32
            if snr32 <= INT8_BLOCK_SNR_BF16_DB:
                print(line)
                fail(f'bfloat16 K11 is too far from the float32 block at {tag}')
        with torch.no_grad():
            kernel_ms, plain_ms = time_pair(
                lambda: S.reference_swin_block_full_int8(*args),
                lambda: S.swin_block_full_int8(*args))
            # K1 beside it where it takes the width
            k1_ms = (cuda_time_ms(lambda: S.swin_block_full_forward(*args))
                     if widths == M_WIDTHS else None)
        ops8, ops_attn, nbytes = int8_block_work(b, h, w, dt, shift, widths)
        (attn_ms, _), attn_core_ms = tensor_core_bound_ms(ops_attn, 0, dt)
        by_bytes = nbytes / PEAK_BYTES * 1e3
        by_ops = ops8 / PEAK_OPS_INT8 * 1e3 + attn_ms
        bound, by = max((by_ops, 'operations'), (by_bytes, 'bytes'))
        # on the CUDA cores: __dp4a (four int8 products an instruction) and float32
        core_bound = max((ops8 / (4 * PEAK_FLOPS_F32)) * 1e3 + attn_core_ms, by_bytes)
        line += (f' | kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, '
                 + ('' if k1_ms is None else f'float kernel (K1) {k1_ms:.4f} ms, ')
                 + f'bound {bound:.4f} ms by {by} (int8 products at '
                 f'{PEAK_OPS_INT8 / 1e12:.0f} TOP/s, q.k and p.v {ROUTE[dt]}; on the CUDA '
                 f'cores {core_bound:.4f} ms)')
        print(line, flush=True)
        if (b, dt, shift) == (1, torch.float32, 4):
            summary.update(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           k1_ms=k1_ms, cuda_core_bound_ms=core_bound)
    check_int8_half_rounding(gen)
    return {'swin_block_joint_int8_fwd': summary}


def check_int8_half_rounding(gen):
    """K11 rounds an activation that lands exactly on k + 0.5 to even, as
    ``torch.round`` and ``jnp.round`` do (``rintf``; ``roundf`` would round it
    away from zero). LayerNorms with weight 0 hand every token their bias:
    half-integers whose absmax is 127, so the window scale is exactly 1 and
    the inputs of qkv and fc1 are those halves. Every integer of the kernel
    at an exact half must equal the plain rounding there."""
    from basicsr4rs_torch.ops import swin_block as S
    for dt in (torch.float32, torch.bfloat16):
        args = block_inputs(1, 128, 128, dt, 0, gen)
        for i in (1, 9):   # ln1_weight, ln2_weight; ln1_bias, ln2_bias
            halves = torch.randint(-127, 127, (C,), generator=gen).float() + .5
            halves[int(torch.randint(C, (1,), generator=gen))] = 127.
            args[i], args[i + 1] = torch.zeros_like(args[i]), halves.cuda()
        rec, plain_rec = [], []
        with torch.no_grad():
            S.swin_block_full_int8(*args, quantised=rec)
            S.reference_swin_block_full_int8(*args, given=rec, quantised=plain_rec)
        torch.cuda.synchronize()
        counts = []
        for name, (q, _), (qp, _, r) in zip(('qkv', 'fc1'), rec[::2], plain_rec[::2]):
            on_half = (r - r.floor()) == .5
            wrong = int((on_half & (q.int() != qp.int())).sum())
            odd = int((on_half & (qp.int() % 2 != 0)).sum())
            counts.append(f'{name} {int(on_half.sum())} exact halves, {wrong} rounded otherwise')
            if not on_half.any() or wrong or odd:
                fail(f'K11 {str(dt)[6:]}: {counts[-1]} (the plain rounding gave {odd} odd '
                     'integers there): halves must round to even')
        print(f'K11 at exact halves, B=1 128x128 {str(dt)[6:]}: ' + '; '.join(counts)
              + ' (to even, as torch.round and jnp.round)', flush=True)



def once_ms(fn):
    """Milliseconds of one call after one warm-up call, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed_test(model, item, repeats=3):
    """Mean milliseconds of ``model.test()`` on one loader item, CUDA events."""
    model.feed_data(item)
    model.test()
    return cuda_time_ms(model.test, repeats)


def serve_fused_conv():
    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    phase('17. serve SwinIR-M x4 through basicsr4rs_torch.test with SWIN_FUSED_CONV=1')
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', CONFIG]
    fused_conv3x3.launches = fused_swin_block_full.launches = 0
    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
        os.environ.pop('SWIN_FUSED_CONV')
    torch.cuda.synchronize()
    launches, k1 = fused_conv3x3.launches, fused_swin_block_full.launches
    per_forward = 6 + 1 + 1 + 2   # RSTB tails, conv_after_body, conv_before_upsample, Upsample
    print(f'K10 launches {launches} = {launches / len(LQ_SIZES):g} per request; K1 launches {k1}')
    if launches != per_forward * len(LQ_SIZES):
        fail(f'expected {per_forward} K10 launches per forward, counted {launches} over '
             f'{len(LQ_SIZES)} requests')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
    loader = list(model_loader(model))
    for item, (h, w) in zip(loader, LQ_SIZES):
        model.feed_data(item)
        model.test()
        cudnn = model.output.float().clamp(0, 1)
        times = []
        for fused in (False, True, True, False):
            if fused:
                os.environ['SWIN_FUSED_CONV'] = '1'
            try:
                times.append(timed_test(model, item))
            finally:
                os.environ.pop('SWIN_FUSED_CONV', None)
            if fused:
                out = model.output.float().clamp(0, 1)
        err = (out - cudnn).abs().max().item()
        fused_ms, cudnn_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        print(f'request LQ {h}x{w}: fused-conv route {fused_ms:.3f} ms, cuDNN route '
              f'{cudnn_ms:.3f} ms; max abs difference on [0, 1] {err:.3e} '
              f'(tolerance {MODEL_TOLERANCE})')
        if out.shape != (1, 3, SCALE * h, SCALE * w) or not err <= MODEL_TOLERANCE:
            fail(f'request {h}x{w}: the fused-conv route disagrees with the cuDNN route')
    return model, loader, launches, k1


def serve_int8(model, loader):
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.ops.quant import quantized_inference
    phase('18. SwinIR-M x4 under quantized_inference(net, min_channels=10**9, swin_kernels=True)')
    net = model.net_g
    blocks = sum(model.opt['network_g']['depths'])
    S.swin_block_full_int8.launches = 0
    forwards = 0
    gen = torch.Generator().manual_seed(7)
    batch = torch.rand(16, 3, 64, 64, generator=gen).cuda()
    linears = [p for name, p in net.named_parameters() if p.dim() == 2 and name.endswith(
        ('qkv.weight', 'proj.weight', 'fc1.weight', 'fc2.weight'))]
    if len(linears) != 4 * blocks:
        fail(f'found {len(linears)} linear weights in the blocks, expected {4 * blocks}')
    with torch.no_grad():   # at full scale, so that their error shows: see INT8_MODEL_SNR_DB
        for p in linears:
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1]**-.5)

    def scope():
        return quantized_inference(net, min_channels=10**9, swin_kernels=True)

    def forward(x):
        with torch.inference_mode():
            return net(x)

    for tag, x in (('B=16 LQ 64x64', batch), ('B=1 LQ 128x128', loader[0]['lq'].cuda())):
        flo = forward(x)
        with scope():
            got = forward(x)
            forwards += 1
            with mock.patch.object(swinir_arch, 'swin_block_full_int8',
                                   S.reference_swin_block_full_int8):
                plain = forward(x)
        torch.cuda.synchronize()
        if got.shape != flo.shape or not torch.isfinite(got).all():
            fail(f'{tag}: int8 output {tuple(got.shape)}')
        snr, routes = snr_db(flo, got), snr_db(plain, got)
        times = []
        for quantised in (False, True, True, False):
            if quantised:
                with scope():
                    forward(x)
                    times.append(cuda_time_ms(lambda: forward(x), 3))
                forwards += 1 + 3 + 3
            else:
                times.append(cuda_time_ms(lambda: forward(x), 3))
        int8_ms, float_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
        mp = x.shape[0] * SCALE * x.shape[2] * SCALE * x.shape[3] / 1e3
        print(f'{tag}: int8 route {int8_ms:.3f} ms = {mp / int8_ms:.3f} output MP/s, float route '
              f'{float_ms:.3f} ms = {mp / float_ms:.3f} output MP/s; SNR of int8 against float '
              f'{snr:.2f} dB (bound {INT8_MODEL_SNR_DB}), PSNR on [0, 1] '
              f'{psnr_db(flo, got):.2f} dB; kernel route against plain route {routes:.2f} dB SNR')
        if snr < INT8_MODEL_SNR_DB:
            fail(f'{tag}: the int8 output is {snr:.2f} dB from the float output')
        # flips of single steps through 36 blocks: no more noise than the scheme's own
        if routes < snr:
            fail(f'{tag}: K11 route and plain route agree to {routes:.2f} dB only: further '
                 'apart than int8 is from float')
    launches = S.swin_block_full_int8.launches
    print(f'K11 launches {launches} over {forwards} forwards = {launches / forwards:g} per forward')
    if launches != blocks * forwards:
        fail(f'expected {blocks} K11 launches per forward')
    if swinir_arch.swin_kernels_int8():
        fail('the scope left swin_kernels_int8() on')
    return launches


def write_msrresnet_inputs():
    """Two synthetic pairs to serve, 16 GT 160x160 pairs to train on, one to
    validate, and the seed-0 weights the test config names."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(3)
    train_dir = MS_DATA_DIR + '_train'
    sets = [(MS_DATA_DIR, 'GT', 'LQ', [(SCALE * h, SCALE * w) for h, w in MS_LQ_SIZES]),
            (train_dir, 'GT', 'LQ', [(160, 160)] * 16), (train_dir, 'val_GT', 'val_LQ', [(256, 256)])]
    for root, gt_dir, lq_dir, sizes in sets:
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i, (h, w) in enumerate(sizes):
            gt = smooth_image(rng, h, w)
            lq = cv2.resize(gt, (w // SCALE, h // SCALE), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(root, lq_dir, f'{i:04d}.png'), lq)
    opt = yaml_load(MS_CONFIG)
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    torch.manual_seed(0)
    net = MSRResNet(**net_opt)
    with torch.no_grad():    # biases off their zero init, so that every parameter shows;
        for name, p in net.named_parameters():   # weights at full scale, see INT8_MODEL_SNR_DB
            if name.endswith('bias'):
                p.normal_(0, 0.02)
            else:   # a residual block's branch keeps its init's factor of 0.1
                p.normal_(0, p[0].numel()**-.5 * (.1 if name.endswith('conv2.weight') else 1.))
    os.makedirs(os.path.dirname(opt['path']['pretrain_network_g']), exist_ok=True)
    torch.save({'params': net.state_dict()}, opt['path']['pretrain_network_g'])
    return net_opt


def serve_and_train_msrresnet():
    import glob
    import shutil

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.archs.arch_util import resize_bilinear
    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.models.sr_model import SRModel
    from basicsr4rs_torch.utils.options import yaml_load
    phase('19. MSRResNet x4 through basicsr4rs_torch.test in float, quant_int8: true and '
          'static; then 8 training steps through basicsr4rs_torch.train')
    net_opt = write_msrresnet_inputs()
    outputs, latency = {}, {}
    for mode, force in (('float', []), ('true', ['--force_yml', 'val:quant_int8=true']),
                        ('static', ['--force_yml', 'val:quant_int8=static'])):
        argv = sys.argv
        sys.argv = ['basicsr4rs_torch.test', '-opt', MS_CONFIG] + force
        try:
            model = entry.test_pipeline(ROOT)
        finally:
            sys.argv = argv
        if model.device.type != 'cuda':
            fail(f'MSRResNet ran on {model.device}')
        wanted = {'float': False, 'true': True, 'static': 'static'}[mode]
        if model.opt['val'].get('quant_int8', False) != wanted:
            fail(f'val.quant_int8 is {model.opt["val"].get("quant_int8")!r} in the {mode} run')
        if mode == 'static' and not model._quant_scales:
            fail('the static run calibrated no scale')
        loader = list(model_loader(model))
        outputs[mode] = []
        for item, (h, w) in zip(loader, MS_LQ_SIZES):
            model.feed_data(item)
            model.test()
            out = model.output.float()
            if out.shape != (1, 3, SCALE * h, SCALE * w) or not torch.isfinite(out).all():
                fail(f'MSRResNet {mode} request {h}x{w}: output {tuple(out.shape)}')
            outputs[mode].append(out)
        latency[mode] = timed_test(model, loader[0])
        print(f'{mode}: PSNR {model.metric_results["psnr"]:.4f} dB against the synthetic GT '
              f'(random weights); request LQ 128x128 {latency[mode]:.3f} ms')
        if any('forward' in m.__dict__ for m in model.net_g.modules()):
            fail('a convolution kept its int8 forward after the scope')
    # the output is the bilinear skip plus the network's branch
    skips = [resize_bilinear(item['lq'].cuda(), SCALE * h, SCALE * w)
             for item, (h, w) in zip(loader, MS_LQ_SIZES)]
    for mode in ('true', 'static'):
        for out, ref, skip, (h, w) in zip(outputs[mode], outputs['float'], skips, MS_LQ_SIZES):
            snr, branch = snr_db(ref, out), snr_db(ref - skip, out - skip)
            print(f'quant_int8 {mode}, LQ {h}x{w}: SNR against float {snr:.2f} dB '
                  f'(bound {INT8_CONV_SNR_DB}); of the branch alone (output minus the bilinear '
                  f'skip) {branch:.2f} dB (bound {INT8_CONV_BRANCH_SNR_DB})')
            if (snr <= INT8_CONV_SNR_DB or branch < INT8_CONV_BRANCH_SNR_DB
                    or torch.equal(out, ref)):
                fail(f'MSRResNet quant_int8 {mode}: SNR {snr:.2f} dB, of the branch '
                     f'{branch:.2f} dB, or the float output itself')

    opt = yaml_load(MS_TRAIN_CONFIG)
    total_iter = opt['train']['total_iter']
    exp_dir = os.path.join('experiments', opt['name'])
    for old in glob.glob(exp_dir + '*'):
        shutil.rmtree(old)
    torch.cuda.reset_peak_memory_stats()
    record = {'steps': []}
    model = run_train_pipeline([], record, config=MS_TRAIN_CONFIG, model_cls=SRModel)
    steps = record['steps']
    if model.device.type != 'cuda' or [st['iter'] for st in steps] != list(range(1, total_iter + 1)):
        fail(f'MSRResNet training ran steps {[st["iter"] for st in steps]} on {model.device}')
    for st in steps:
        if not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'l_pix is not finite at step {st["iter"]}')
    timed = [st['ms'] for st in steps[2:]]
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'training step: {sum(timed) / len(timed):.3f} ms mean of steps 3..{total_iter} (min '
          f'{min(timed):.3f}, max {max(timed):.3f}); peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; l_pix '
          + ' '.join(f'{st["l_pix"]:.5f}' for st in steps))
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step 1, '
          f'{loss_after:.6f} after step {total_iter}')
    if not loss_after < record['fixed_loss_before']:
        fail('MSRResNet: the loss on the fixed batch did not fall')
    check_ema_and_checkpoint(model, MSRResNet(**net_opt),
                             os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth'))


class MemoryMarks:
    """Device memory of one run, stage by stage: each wrapped callable
    (``(label, owner, attribute)``: a module's forward, a method, a module's
    function; ``label`` may be a function of the call's arguments) marks its
    start and its return with the memory allocated then and the most
    allocated since the previous mark. Marks of nested stages split the
    outer stage's intervals."""

    def __init__(self, stages):
        self.stages, self.rows = stages, []

    def mark(self, what):
        self.rows.append((what, torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    def __enter__(self):
        self.kept = []
        for label, owner, attr in self.stages:
            own = attr in vars(owner)
            inner = getattr(owner, attr)

            def wrapped(*args, _inner=inner, _label=label, **kwargs):
                what = _label(*args) if callable(_label) else _label
                self.mark(f'{what} starts')
                out = _inner(*args, **kwargs)
                self.mark(f'{what} returns')
                return out

            self.kept.append((owner, attr, inner if own else None))
            setattr(owner, attr, wrapped)
        self.mark('the run starts')
        return self

    def __exit__(self, *exc):
        self.mark('the run ends')
        for owner, attr, inner in reversed(self.kept):
            if inner is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, inner)

    def show(self, title):
        """Prints the marks; returns the largest peak."""
        print(f'{title}: device memory at each mark (allocated then; most allocated since the '
              'previous mark), MiB')
        for what, live, peak in self.rows:
            print(f'  {live / 2**20:10.1f} {peak / 2**20:10.1f}  {what}')
        return max(peak for _, _, peak in self.rows)


def swinir_memory_stages(net):
    """The stages of a SwinIR forward for ``MemoryMarks``."""
    from basicsr4rs_torch.archs import swinir_arch
    stages = [('SwinIR forward', net, 'forward'), ('conv_first', net.conv_first, 'forward')]
    stages += [(f'RSTB {i}', layer, 'forward') for i, layer in enumerate(net.layers)]
    names = {id(m): n for n, m in net.named_modules()}
    stages += [(lambda conv, *_: f'3x3 conv {names.get(id(conv), "?")}', swinir_arch, 'conv3x3'),
               ('norm', net.norm, 'forward'), ('upsample', net.upsample, 'forward'),
               ('conv_last', net.conv_last, 'forward')]
    return stages


def serve_tiled():
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.inference import inference_swinir
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    from basicsr4rs_torch.ops.tile import tiled_apply
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'20. tiled serving: inference_swinir --tile {TILE} --tile_pad {TILE_PAD} on one LQ '
          f'{TILED_LQ}x{TILED_LQ} image; MSRResNet tiled with its receptive field as the pad')
    os.makedirs(os.path.join(TILED_DIR, 'LQ'), exist_ok=True)
    img = smooth_image(np.random.RandomState(4), TILED_LQ, TILED_LQ)
    cv2.imwrite(os.path.join(TILED_DIR, 'LQ', '0000.png'), img)
    out_dir = os.path.join('results', 'chip_smoke', 'tiled')
    fused_swin_block_full.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inference_swinir.main(['--model_path', WEIGHTS, '--task', 'classical_sr', '--input',
                           os.path.join(TILED_DIR, 'LQ'), '--output', out_dir, '--tile', str(TILE),
                           '--tile_pad', str(TILE_PAD)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_swin_block_full.launches
    tiles = (TILED_LQ // TILE)**2
    full = TILE + 2 * TILE_PAD
    print(f'inference_swinir: {wall:.3f} s wall (weights, read, {tiles} tiles of {full}x{full} as '
          f'one batch, write); K1 launches {launches}; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    saved = cv2.imread(os.path.join(out_dir, '0000_SwinIR.png'))
    if saved is None or saved.shape != (SCALE * TILED_LQ, SCALE * TILED_LQ, 3):
        fail(f'tiled output: {None if saved is None else saved.shape}')
    if launches != 36:
        fail(f'expected 36 K1 launches (one batched forward), counted {launches}')
    # against the untiled forward
    net = SwinIR(**inference_swinir.TASKS['classical_sr'])
    net.load_state_dict(inference_swinir.load_state_dict(WEIGHTS), strict=True)
    net.cuda().eval()
    x = torch.from_numpy(np.ascontiguousarray(
        img[..., ::-1].astype(np.float32).transpose(2, 0, 1) / 255.))[None].cuda()
    apply = inference_swinir.build_apply(net, SCALE, 8, TILE, TILE_PAD)
    tiled_ms = once_ms(lambda: apply(x))
    tiled = apply(x).clamp(0, 1)
    with torch.inference_mode():
        whole = net(x).clamp(0, 1)
        whole_ms = once_ms(lambda: net(x))
    written = torch.from_numpy(np.ascontiguousarray(saved[..., ::-1].transpose(2, 0, 1))).cuda()
    if ((tiled[0] * 255).round() - written.float()).abs().max().item() > 1:
        fail('the written image is not the tiled forward')
    err = (tiled - whole).abs()
    print(f'SwinIR-M x4 LQ {TILED_LQ}x{TILED_LQ}: tiled {tiled_ms:.1f} ms, untiled {whole_ms:.1f} '
          f'ms; tiled against untiled on [0, 1]: max {err.max().item():.3e}, mean '
          f'{err.mean().item():.3e} (a tile sees {TILE_PAD} pixels of halo, not the image: '
          f'tolerance {TILE_APPROX_TOLERANCE})')
    if not err.max().item() < TILE_APPROX_TOLERANCE:
        fail('tiled SwinIR is too far from the untiled forward')
    del tiled, whole
    # F4: where the memory of the tiled request goes, beside the untiled forward's
    peaks = {}
    for what, run, fused in (('tiled', lambda: apply(x), '0'),
                             ('untiled', lambda: inference_swinir.build_apply(net, SCALE, 8)(x),
                              '0'),
                             ('tiled, SWIN_FUSED_CONV=1', lambda: apply(x), '1')):
        torch.cuda.empty_cache()
        with mock.patch.dict(os.environ, {'SWIN_FUSED_CONV': fused}), \
                MemoryMarks(swinir_memory_stages(net)) as marks:
            run()
        peaks[what] = marks.show(f'SwinIR-M x4 LQ {TILED_LQ}x{TILED_LQ} {what}')
    print('peak device memory: ' + ', '.join(f'{what} {peak / 2**20:.1f} MiB'
                                             for what, peak in peaks.items()))
    del net
    # MSRResNet: 34 convolutions at LQ size, one at 2x, two at 4x: a receptive
    # field of 36 LQ pixels each way, covered by a pad of 40
    net_opt = dict(yaml_load(MS_CONFIG)['network_g'])
    net_opt.pop('type')
    net = MSRResNet(**net_opt)
    net.load_state_dict(torch.load(yaml_load(MS_CONFIG)['path']['pretrain_network_g'],
                                   weights_only=True)['params'])
    net.cuda().eval()

    def forward(v):
        with torch.inference_mode():
            return net(v)

    whole = forward(x)
    tiled = tiled_apply(forward, x, SCALE, TILE, 40)
    ok, max_abs, max_rel, tolerance = compare(tiled, whole, torch.float32, 'elementwise')
    print(f'MSRResNet x4 LQ {TILED_LQ}x{TILED_LQ}, tile {TILE}, pad 40: tiled against untiled '
          f'max_abs_err={max_abs:.3e} ({tolerance}); tiled '
          f'{once_ms(lambda: tiled_apply(forward, x, SCALE, TILE, 40)):.1f} ms, untiled '
          f'{once_ms(lambda: forward(x)):.1f} ms')
    if not ok:
        fail('tiled MSRResNet differs from the untiled forward')
    return launches


def train_joint(split_step_ms):
    import glob
    import shutil

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'21. train SwinIR-M x4 for {JOINT_TRAIN_ITERS} steps with SWIN_JOINT_TRAIN=1 (the '
          'joint kernel and its recomputing backward)')
    opt = yaml_load(TRAIN_CONFIG)
    blocks = sum(opt['network_g']['depths'])
    name = opt['name'] + '_joint'
    for old in glob.glob(os.path.join('experiments', name) + '*'):
        shutil.rmtree(old)
    wrappers = training_kernels()
    for w in wrappers.values():
        w.launches = 0
    record = {'steps': []}
    os.environ['SWIN_JOINT_TRAIN'] = '1'
    try:
        run_train_pipeline(['--force_yml', f'name={name}', f'train:total_iter={JOINT_TRAIN_ITERS}'],
                           record)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        # one training batch: the joint route's gradients against the split route's
        net_opt = dict(opt['network_g'])
        net_opt.pop('type')
        net = SwinIR(**net_opt, generator=torch.Generator().manual_seed(0)).cuda().train()
        gen = torch.Generator().manual_seed(2)
        lq = torch.rand(4, 3, 48, 48, generator=gen).cuda()
        gt = torch.rand(4, 3, 192, 192, generator=gen).cuda()

        def loss_and_grads():
            net.seed_drop_path(123, 'cuda')   # the same DropPath masks in both runs
            net.zero_grad(set_to_none=True)
            loss = (net(lq) - gt).abs().mean()
            loss.backward()
            return loss.item(), {k: p.grad.clone() for k, p in net.named_parameters()}

        loss_j, grads_j = loss_and_grads()
        os.environ['SWIN_JOINT_TRAIN'] = '0'
        loss_s, grads_s = loss_and_grads()
    finally:
        os.environ.pop('SWIN_JOINT_TRAIN')
    expected = {'swin_block_joint_fwd': blocks, 'swin_attn_block_fwd': blocks,
                'swin_attn_block_bwd': blocks, 'mlp_block_fwd': 0, 'mlp_block_bwd': blocks}
    for st in record['steps']:
        print(f'step {st["iter"]}: {st["ms"]:.3f} ms, l_pix {st["l_pix"]:.6f}, launches '
              + ' '.join(f'{k}={v}' for k, v in st['launches'].items()))
        if st['launches'] != expected or not torch.isfinite(torch.tensor(st['l_pix'])):
            fail(f'step {st["iter"]}: launches {st["launches"]}, expected {expected}')
    if [st['iter'] for st in record['steps']] != list(range(1, JOINT_TRAIN_ITERS + 1)):
        fail(f'ran steps {[st["iter"] for st in record["steps"]]}')
    timed = [st['ms'] for st in record['steps'][2:]]
    print(f'training step on the joint route: {sum(timed) / len(timed):.3f} ms mean of steps '
          f'3..{JOINT_TRAIN_ITERS}'
          + ('' if split_step_ms is None else
             f'; on the split route (phase 6) {split_step_ms:.3f} ms'))
    compare_gradients('SwinIR joint route vs split route', loss_j, grads_j, loss_s, grads_s)
    return launches


WIDE_SWINIR = [(180, 3), (240, 8)]   # (embed, heads): heads of 60; SwinIR-L's 240 in 8 heads


def serve_wide_swinir():
    """Phase 22: SwinIR in eval at widths past the joint kernel's (C > 192 or
    heads wider than 32), depths [2, 2], LQ 64x64, seed-0 weights: each block
    through K2 + K4, no K1, against the plain forward; then, with the
    blocks' linears redrawn at full scale as in phase 18, under
    ``quantized_inference(net, min_channels=10**9, swin_kernels=True)``:
    each block through K11 (its wide variant) and nothing else, against the
    float forward by SNR (phase 18's bound) and against the plain int8
    route. Every width must run: a refusal (a block needing more shared
    memory than the card has, or past a gate) fails the phase. Returns the
    launches of K2, K4 and K11."""
    from basicsr4rs_torch.archs import swinir_arch
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import _launch
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.ops.quant import quantized_inference
    phase('22. SwinIR past the joint kernel\'s widths (' + ', '.join(
        f'C={c} in {h} heads of {c // h}' for c, h in WIDE_SWINIR) + '), eval: K2 + K4 a block; '
        'under swin_kernels=True: K11 a block')
    gen = torch.Generator().manual_seed(0)
    lq = torch.rand(1, 3, 64, 64, generator=gen).cuda()
    counters = (S.fused_swin_block_full, S.swin_attn_block_forward, M.mlp_block_forward,
                S.swin_block_full_int8)
    launches = {'swin_attn_block_fwd': 0, 'mlp_block_fwd': 0, 'swin_block_joint_int8_fwd': 0}
    limit = _launch.shared_memory_limit(lq.device)
    for embed, heads in WIDE_SWINIR:
        depths = [2, 2]
        net = SwinIR(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1.,
                     depths=depths, embed_dim=embed, num_heads=[heads] * len(depths),
                     mlp_ratio=2., upsampler='pixelshuffle', resi_connection='1conv',
                     generator=gen).cuda().eval()
        k2a, k2b = S.attn_forward_shared_memory(torch.float32, embed, heads)
        need = {'K2 (window, head) units': k2a, 'K2 proj tiles': k2b,
                'K4': M._lib('mlp_block_fwd').mlp_block_fwd_smem_bytes(0, embed),
                'K11': S._lib('swin_block_joint_int8_fwd').swin_block_joint_int8_fwd_smem_bytes(
                    0, embed, heads, 2 * embed)}
        tag = f'C={embed}, {heads} heads of {embed // heads}'
        if max(need.values()) > limit:
            fail(f'{tag}: a block needs {need} bytes of shared memory, the card has {limit}')
        for f in counters:
            f.launches = 0
        with torch.no_grad():
            out_k = net(lq)
        torch.cuda.synchronize()
        counts = [f.launches for f in counters]
        blocks = sum(depths)
        if counts != [0, blocks, blocks, 0]:
            fail(f'{tag}: launches K1, K2, K4, K11 {counts}, expected [0, {blocks}, {blocks}, 0]')
        launches['swin_attn_block_fwd'] += blocks
        launches['mlp_block_fwd'] += blocks
        plain = [mock.patch.object(S, 'swin_attn_block_forward', S.reference_swin_attn_block),
                 mock.patch.object(M, 'mlp_block_forward', M.reference_mlp_block)]
        for q in plain:
            q.start()
        try:
            with torch.no_grad():
                out_p = net(lq)
        finally:
            for q in plain:
                q.stop()
        if [f.launches for f in counters] != counts:
            fail(f'{tag}: the plain forward launched a kernel')
        err = (out_k - out_p).abs().max().item()
        print(f'{tag}: K1 0, K2 {blocks}, K4 {blocks} launches; shared memory a block {need} '
              f'bytes (the card {limit}); output max abs difference from the plain forward '
              f'{err:.3e} (max|plain| {out_p.abs().max().item():.3e}, tolerance {MODEL_TOLERANCE})')
        if not err <= MODEL_TOLERANCE:
            fail(f'{tag}: the output disagrees with the plain forward')
        linears = [p for name, p in net.named_parameters() if p.dim() == 2 and name.endswith(
            ('qkv.weight', 'proj.weight', 'fc1.weight', 'fc2.weight'))]
        with torch.no_grad():   # at full scale, so that their error shows: see INT8_MODEL_SNR_DB
            for p in linears:
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1]**-.5)
            flo = net(lq)
        for f in counters:
            f.launches = 0
        with quantized_inference(net, min_channels=10**9, swin_kernels=True), torch.no_grad():
            got = net(lq)
            counts = [f.launches for f in counters]
            with mock.patch.object(swinir_arch, 'swin_block_full_int8',
                                   S.reference_swin_block_full_int8):
                plain_route = net(lq)
        torch.cuda.synchronize()
        if counts != [0, 0, 0, blocks]:
            fail(f'{tag}, int8: launches K1, K2, K4, K11 {counts}, expected [0, 0, 0, {blocks}]')
        launches['swin_block_joint_int8_fwd'] += blocks
        if got.shape != flo.shape or not torch.isfinite(got).all():
            fail(f'{tag}, int8: output {tuple(got.shape)}')
        snr, routes = snr_db(flo, got), snr_db(plain_route, got)
        print(f'{tag}, under swin_kernels=True: K11 {blocks} launches, no other block kernel; '
              f'SNR of int8 against float {snr:.2f} dB (bound {INT8_MODEL_SNR_DB}), kernel route '
              f'against plain route {routes:.2f} dB SNR', flush=True)
        if snr < INT8_MODEL_SNR_DB:
            fail(f'{tag}: the int8 output is {snr:.2f} dB from the float output')
        if routes < snr:
            fail(f'{tag}: K11 route and plain route agree to {routes:.2f} dB only: further '
                 'apart than int8 is from float')
    return launches


# --------------------------------------------- ahead-of-time serving (torch.export)
SERVE_BUCKET = (128, 128)   # SwinIR-M's artifact; requests at the bucket and off it
SERVE_OFF_BUCKET = (120, 124)
INT8_BUCKET, INT8_BATCH, INT8_REQUEST = (64, 64), 4, (3, 60, 60)


def served_request(sm, lq, counters):
    """``sm.run(lq)`` once with the counts of ``counters`` set to 0 just
    before it and read just after: (output, [launches of each])."""
    for f in counters:
        f.launches = 0
    out = sm.run(lq)
    torch.cuda.synchronize()
    return out, [f.launches for f in counters]


def live_like_served(net, lq, bucket, batch=1):
    """The live network on ``lq`` padded as ``ServingModel`` pads it to
    ``bucket`` (reflect on H and W, zeros up to ``batch``), cropped back: the
    same work as the served request."""
    import torch.nn.functional as F
    b, _, h, w = lq.shape
    xp = F.pad(lq, (0, bucket[1] - w, 0, bucket[0] - h), mode='reflect') if (h, w) != bucket \
        else lq
    if batch > b:
        xp = torch.cat([xp, xp.new_zeros((batch - b, *xp.shape[1:]))])
    with torch.no_grad():
        return net(xp)[:b, :, :SCALE * h, :SCALE * w]


def check_served(tag, got, want, against='the live network'):
    """Holds a served output against the live one: bit for bit, or within
    ``F32_TOL`` element by element (an artifact and the live network may get
    other cuDNN algorithms for the convolutions outside the kernels)."""
    err = (got - want).abs()
    bound = F32_TOL[0] + F32_TOL[1] * want.abs()
    print(f'{tag}: output {tuple(got.shape)}, max abs difference from {against} '
          f'{err.max().item():.3e} ({"bit for bit" if torch.equal(got, want) else "not bitwise"};'
          f' tolerance {F32_TOL[0]} + {F32_TOL[1]} |live|)')
    if got.shape != want.shape or not torch.isfinite(got).all() or (err > bound).any():
        fail(f'{tag}: the served output disagrees with the live network')


def serve_exported_swinir(tmp):
    """Phase 59: SwinIR-M x4 exported with ``export_serving`` at full width
    (seed-0 weights, ``SWIN_FUSED_CONV=1``) to one 128x128 bucket, loaded with
    ``ServingModel`` and served a bucket-exact and an off-bucket request with
    the switch off: K1 36 and K10 10 launches a request, read from the served
    run alone, outputs against the live network. Returns the launches and
    phase 62's job on the directory (``second_process_job``)."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.inference.inference_swinir import load_weights
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3
    from basicsr4rs_torch.ops.swin_block import fused_swin_block_full
    from basicsr4rs_torch.scripts import export_serving
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.serving import ServingModel
    phase('59. SwinIR-M x4 ahead of time: export_serving --device cuda with SWIN_FUSED_CONV=1, '
          'one 128x128 bucket, served by ServingModel')
    if not os.path.exists(WEIGHTS):
        write_inputs()
    out_dir = os.path.join(tmp, 'swinir_m_x4')
    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        t0 = time.perf_counter()
        manifest = export_serving.main(['-opt', CONFIG, '--model_path', WEIGHTS, '--buckets',
                                        'x'.join(map(str, SERVE_BUCKET)), '--out', out_dir])
        export_s = time.perf_counter() - t0
    finally:
        os.environ.pop('SWIN_FUSED_CONV')
    t0 = time.perf_counter()
    sm = ServingModel(out_dir)
    load_s = time.perf_counter() - t0
    print(f'export {export_s:.1f} s (one bucket, weights included: '
          f'{os.path.getsize(os.path.join(out_dir, manifest["buckets"][0]["file"])) / 2**20:.1f}'
          f' MiB), load {load_s:.1f} s; manifest {json.dumps({k: manifest[k] for k in ("scale", "dtype", "pad_multiple", "device", "buckets")})}')
    net_opt = dict(yaml_load(CONFIG)['network_g'])
    net_opt.pop('type')
    net = SwinIR(**net_opt)
    load_weights(net, WEIGHTS)
    net = net.cuda().eval()
    # K1 a block; K10 for the RSTB tails, conv_after_body, conv_before_upsample
    # and the two of the x4 Upsample, as in phase 17
    blocks, per_forward = sum(net_opt['depths']), len(net_opt['depths']) + 4
    gen = torch.Generator().manual_seed(0)
    launches = {'swin_block_joint_fwd': 0, 'conv3x3_fwd': 0}
    for h, w in (SERVE_BUCKET, SERVE_OFF_BUCKET):
        lq = torch.rand(1, 3, h, w, generator=gen).cuda()
        got, (k1, k10) = served_request(sm, lq, (fused_swin_block_full, fused_conv3x3))
        if [k1, k10] != [blocks, per_forward]:
            fail(f'served {h}x{w}: K1 {k1}, K10 {k10} launches, expected {blocks} and '
                 f'{per_forward}')
        launches['swin_block_joint_fwd'] += k1
        launches['conv3x3_fwd'] += k10
        os.environ['SWIN_FUSED_CONV'] = '1'
        try:
            want = live_like_served(net, lq, SERVE_BUCKET)
            live_ms = cuda_time_ms(lambda: live_like_served(net, lq, SERVE_BUCKET))
        finally:
            os.environ.pop('SWIN_FUSED_CONV')
        check_served(f'served LQ {h}x{w} (bucket {SERVE_BUCKET[0]}x{SERVE_BUCKET[1]})', got, want)
        served_ms = cuda_time_ms(lambda: sm.run(lq))
        print(f'LQ {h}x{w}: K1 {k1}, K10 {k10} launches in the served request; request '
              f'{served_ms:.3f} ms served, {live_ms:.3f} ms live (CUDA events, 10 after 3)',
              flush=True)
    return launches, second_process_job(tmp, out_dir, sm, [blocks, per_forward])


def serve_exported_wide():
    """Phase 60: phase 22's C=240 eval network (8 heads of 30, depths [2, 2],
    seed-0 weights) exported to one 64x64 bucket: the served request
    launches K2 and K4 a block and no K1."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.utils.serving import ServingModel, save_serving_dir
    phase('60. SwinIR at C=240 in 8 heads of 30 ahead of time: K2 + K4 in the artifact, '
          'one 64x64 bucket')
    gen = torch.Generator().manual_seed(0)
    embed, heads = WIDE_SWINIR[-1]
    depths = [2, 2]
    net = SwinIR(upscale=4, in_chans=3, img_size=64, window_size=8, img_range=1., depths=depths,
                 embed_dim=embed, num_heads=[heads] * len(depths), mlp_ratio=2.,
                 upsampler='pixelshuffle', resi_connection='1conv',
                 generator=gen).cuda().eval()
    out_dir = tempfile.mkdtemp(prefix='swinir_c240_')
    try:
        t0 = time.perf_counter()
        save_serving_dir(out_dir, net, [(64, 64)], scale=4, pad_multiple=8)
        export_s = time.perf_counter() - t0
        sm = ServingModel(out_dir)
    finally:
        shutil.rmtree(out_dir)
    lq = torch.rand(1, 3, 64, 64, generator=gen).cuda()
    counters = (S.fused_swin_block_full, S.swin_attn_block_forward, M.mlp_block_forward)
    got, counts = served_request(sm, lq, counters)
    blocks = sum(depths)
    if counts != [0, blocks, blocks]:
        fail(f'C={embed}, served: launches K1, K2, K4 {counts}, expected [0, {blocks}, {blocks}]')
    check_served(f'C={embed}, served LQ 64x64', got, live_like_served(net, lq, (64, 64)))
    print(f'export {export_s:.1f} s; launches K1, K2, K4 {counts} in the served request; '
          f'request {cuda_time_ms(lambda: sm.run(lq)):.3f} ms served, '
          f'{cuda_time_ms(lambda: live_like_served(net, lq, (64, 64))):.3f} ms live', flush=True)
    return {'swin_attn_block_fwd': blocks, 'mlp_block_fwd': blocks}


def serve_exported_int8():
    """Phase 61: MSRResNet x4 (phase 19's network and seed-0 weights) with
    static int8 scales calibrated on one batch, exported to one 64x64 bucket
    at batch 4 (``quantized_inference(net, act_scales=...)``,
    ``swin_kernels=False``); a request of batch 3 at 60x60 against the live
    quantised run on the same padded batch, and away from the float one;
    the device time of each by kernel group (``torch.profiler``)."""
    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.inference.inference_swinir import load_weights
    from basicsr4rs_torch.ops.quant import calibrate_act_scales, quantized_inference
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.serving import ServingModel, save_serving_dir
    phase('61. MSRResNet x4 --int8 ahead of time: static scales from one batch, one 64x64 bucket '
          'at batch 4, a request of 3 at 60x60')
    opt = yaml_load(MS_CONFIG)
    if not os.path.exists(opt['path']['pretrain_network_g']):
        write_msrresnet_inputs()
    net_opt = dict(opt['network_g'])
    net_opt.pop('type')
    net = MSRResNet(**net_opt)
    load_weights(net, opt['path']['pretrain_network_g'])
    net = net.cuda().eval()
    gen = torch.Generator().manual_seed(0)
    calib = torch.rand(INT8_BATCH, 3, *INT8_BUCKET, generator=gen).cuda()
    with torch.no_grad():
        scales = calibrate_act_scales(net, net, [calib])
    out_dir = tempfile.mkdtemp(prefix='msrresnet_int8_')
    try:
        t0 = time.perf_counter()
        manifest = save_serving_dir(out_dir, net, [INT8_BUCKET], scale=SCALE,
                                    batch=INT8_BATCH, quant_act_scales=scales)
        export_s = time.perf_counter() - t0
        sm = ServingModel(out_dir)
    finally:
        shutil.rmtree(out_dir)
    lq = torch.rand(INT8_REQUEST[0], 3, *INT8_REQUEST[1:], generator=gen).cuda()
    got = sm.run(lq)
    torch.cuda.synchronize()
    with quantized_inference(net, act_scales=scales):
        want = live_like_served(net, lq, INT8_BUCKET, INT8_BATCH)
        live_ms = cuda_time_ms(lambda: live_like_served(net, lq, INT8_BUCKET, INT8_BATCH))
    flo = live_like_served(net, lq, INT8_BUCKET)
    check_served(f'int8 ({manifest["quant"]}, {len(scales)} sites), served batch '
                 f'{INT8_REQUEST[0]} of {INT8_REQUEST[1]}x{INT8_REQUEST[2]}', got, want)
    snr = snr_db(flo, got)
    print(f'export {export_s:.1f} s; SNR of the served int8 output against float {snr:.2f} dB '
          f'(bound {INT8_CONV_SNR_DB}); request {cuda_time_ms(lambda: sm.run(lq)):.3f} ms served, '
          f'{live_ms:.3f} ms live', flush=True)
    print('device time of a served request:')
    profile_device_time(lambda: sm.run(lq), 1, 'request', (), 'msrresnet_int8_served.json')
    print('and of the live one:')
    with quantized_inference(net, act_scales=scales):
        profile_device_time(lambda: live_like_served(net, lq, INT8_BUCKET, INT8_BATCH), 1,
                            'request', (), 'msrresnet_int8_live.json')
    if manifest['quant'] != 'int8-static' or snr <= INT8_CONV_SNR_DB or torch.equal(got, flo):
        fail('the int8 artifact is not the W8A8 mode')


def second_process_job(tmp, out_dir, sm, per_request):
    """Phase 62's inputs, made beside phase 59: a request saved in the
    artifact's directory (``tmp`` holds it), this process's served output for
    it (``sm``, its ServingModel) and K1's and K10's launches a request."""
    import numpy as np
    lq = torch.rand(1, 3, *SERVE_BUCKET, generator=torch.Generator().manual_seed(1))
    np.save(os.path.join(out_dir, 'lq.npy'), lq.numpy())
    return {'tmp': tmp, 'out_dir': out_dir, 'per_request': per_request,
            'want': sm.run(lq.cuda()).cpu()}


def start_second_process(job):
    """Phase 62 starts: a new interpreter serves phase 59's directory, beside
    work that keeps the card idle; ``finish_second_process`` collects it."""
    out_dir = job['out_dir']
    code = ('import json, sys, time\n'
            'import numpy as np, torch\n'
            'torch.backends.cuda.matmul.allow_tf32 = False\n'   # as main() sets them here
            'torch.backends.cudnn.allow_tf32 = False\n'
            'from basicsr4rs_torch.utils.serving import ServingModel\n'
            't0 = time.perf_counter()\n'
            f'sm = ServingModel({out_dir!r})\n'
            'load_s = time.perf_counter() - t0\n'
            'from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3\n'
            'from basicsr4rs_torch.ops.swin_block import fused_swin_block_full\n'
            f'out = sm.run(torch.from_numpy(np.load({os.path.join(out_dir, "lq.npy")!r})))\n'
            'torch.cuda.synchronize()\n'
            f'np.save({os.path.join(out_dir, "out.npy")!r}, out.cpu().numpy())\n'
            'print(json.dumps({"k1": fused_swin_block_full.launches, '
            '"k10": fused_conv3x3.launches, "load_s": load_s, '
            '"imported": [m for m in sys.modules if m.startswith(("basicsr4rs_torch.archs", '
            '"basicsr4rs_torch.models", "basicsr4rs_torch.utils.registry"))]}))\n')
    job['proc'] = subprocess.Popen([sys.executable, '-c', code], cwd=ROOT,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    job['started'] = time.perf_counter()


def finish_second_process(job):
    """Phase 62: the second process's K1 and K10 launches are phase 59's a
    request, it imported none of the port's networks, models and
    registries, and its output is this process's served one. Removes the
    artifact's directory; returns the launches."""
    import numpy as np
    phase('62. a second process serves the SwinIR-M x4 artifact')
    try:
        out, err = job['proc'].communicate(timeout=300)
        wall = time.perf_counter() - job['started']
        if job['proc'].returncode != 0:
            fail(f'the second process failed: {err[-2000:]}')
        seen = json.loads(out.strip().splitlines()[-1])
        print(f'second process: collected {wall:.1f} s after its start, artifact load '
              f'{seen["load_s"]:.1f} s; K1 {seen["k1"]}, K10 {seen["k10"]} launches; of the '
              f'port\'s networks, models and registries it imported {seen["imported"]}')
        if seen['imported'] or [seen['k1'], seen['k10']] != job['per_request']:
            fail(f'the second process imported the networks or launched K1 {seen["k1"]}, '
                 f'K10 {seen["k10"]} times')
        check_served(f'second process, served LQ {SERVE_BUCKET[0]}x{SERVE_BUCKET[1]}',
                     torch.from_numpy(np.load(os.path.join(job['out_dir'], 'out.npy'))),
                     job['want'], 'this process\'s served run')
    finally:
        stop_second_process(job)
    return {'swin_block_joint_fwd': seen['k1'], 'conv3x3_fwd': seen['k10']}


def stop_second_process(job):
    """Ends phase 62's process if it still runs and removes its directory."""
    if job.get('proc') is not None and job['proc'].poll() is None:
        job['proc'].kill()
        job['proc'].wait()
    shutil.rmtree(job['tmp'], ignore_errors=True)


def serve_ahead_of_time():
    """Phases 59 to 61: the port's networks exported with torch.export and
    served by ``ServingModel``; their launches and phase 62's job, which
    keeps phase 59's directory until ``finish_second_process``."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='aot_serving_')
    launches = collections.Counter()
    try:
        swinir, second = serve_exported_swinir(tmp)
        launches.update(swinir)
        launches.update(serve_exported_wide())
        serve_exported_int8()
    except BaseException:
        shutil.rmtree(tmp)
        raise
    print(f'phases 59 to 61: {time.perf_counter() - t0:.1f} s')
    return launches, second


# --------------------------------------------------- the classic CNN and GAN paths
CNN_DIR = 'datasets/CNN_x4_synthetic'
CNN_X2_DIR = 'datasets/CNN_x2_synthetic'   # the same GT images, LQ at x2 (RCAN x2)
CNN_TRAIN_IMAGES, CNN_TRAIN_GT = 16, 256
CNN_VAL_LQ = [(128, 128), (96, 160)]
ESRGAN_TRAIN = 'options/train/ESRGAN/train_ESRGAN_x4_synthetic.yml'
ESRGAN_TEST = 'options/test/ESRGAN/test_ESRGAN_x4_synthetic.yml'
EDSR_TRAIN = 'options/train/EDSR/train_EDSR_Lx4_synthetic.yml'
EDSR_TEST = 'options/test/EDSR/test_EDSR_Lx4_synthetic.yml'
MSRGAN_TRAIN = 'options/train/SRResNet_SRGAN/train_MSRGAN_x4_synthetic.yml'
ECBSR_TRAIN = 'options/train/ECBSR/train_ECBSR_x4_m4c16_prelu_synthetic.yml'
RCAN_TRAIN = 'options/train/RCAN/train_RCAN_x2_synthetic.yml'
VGG_WEIGHTS = 'results/chip_smoke/vgg19.pth'
CNN_ITERS = 6


def write_cnn_inputs():
    """16 GT 256x256 pairs to train on and two to validate and serve (LQ
    128x128 and 96x160), LQ the bicubic x4 downscale, and the same GT
    images with their x2 LQ (``CNN_X2_DIR``); and a random VGG19
    in torchvision's layout (He-scaled, seed 0), which the GAN runs give
    their perceptual losses as ``pretrain_path``."""
    import cv2
    import numpy as np
    for scale, root in ((SCALE, CNN_DIR), (2, CNN_X2_DIR)):
        rng = np.random.RandomState(4)
        sets = [('GT', 'LQ', [(CNN_TRAIN_GT, CNN_TRAIN_GT)] * CNN_TRAIN_IMAGES),
                ('val_GT', 'val_LQ', [(scale * h, scale * w) for h, w in CNN_VAL_LQ])]
        for gt_dir, lq_dir, sizes in sets:
            for sub in (gt_dir, lq_dir):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
            for i, (h, w) in enumerate(sizes):
                gt = smooth_image(rng, h, w)
                lq = cv2.resize(gt, (w // scale, h // scale), interpolation=cv2.INTER_CUBIC)
                cv2.imwrite(os.path.join(root, gt_dir, f'{i:04d}.png'), gt)
                cv2.imwrite(os.path.join(root, lq_dir, f'{i:04d}.png'), lq)
    write_vgg19()


def write_vgg19():
    """A random VGG19 in torchvision's layout (He-scaled, seed 0) at
    ``VGG_WEIGHTS``, which the GAN runs give their perceptual losses as
    ``pretrain_path``."""
    from basicsr4rs_torch.archs.vgg_arch import _CFG, vgg_layer_names
    gen = torch.Generator().manual_seed(0)
    state, cin = {}, 3
    channels = iter(c for c in _CFG['vgg19'] if c != 'M')
    for i, name in enumerate(vgg_layer_names('vgg19')):
        if name.startswith('conv'):
            cout = next(channels)
            state[f'features.{i}.weight'] = torch.randn(cout, cin, 3, 3, generator=gen) * (
                2 / (9 * cin))**.5
            state[f'features.{i}.bias'] = torch.zeros(cout)
            cin = cout
    os.makedirs(os.path.dirname(VGG_WEIGHTS), exist_ok=True)
    torch.save(state, VGG_WEIGHTS)


def short_run(iters=CNN_ITERS, *more):
    """One ``--force_yml`` that cuts a published run to ``iters`` steps (the
    validation and the checkpoint then come once, at the end: ``latest``),
    logs every other step and leaves TensorBoard off; ``more`` overrides
    besides."""
    return ['--force_yml', f'train:total_iter={iters}', f'val:val_freq={10**6}',
            f'logger:save_checkpoint_freq={10**6}', 'logger:print_freq=2',
            'logger:use_tb_logger=false', *more]


def run_test_pipeline(config, extra_args):
    import basicsr4rs_torch.test as entry
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', config] + extra_args
    try:
        return entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv


def keep_logs(model, step):
    step['logs'] = {k: float(v) for k, v in model.log_dict.items()}


def check_logs_finite(steps):
    for st in steps:
        bad = [k for k, v in st['logs'].items() if not math.isfinite(v)]
        if bad:
            fail(f'step {st["iter"]}: {bad} not finite')
    print('last step: ' + ', '.join(f'{k} {v:.5f}' for k, v in steps[-1]['logs'].items()))


def net_options(opt, key='network_g'):
    return {k: v for k, v in opt[key].items() if k != 'type'}


def train_gan(config, model_cls, number, title, extra=(), wrappers=None, per_step=None,
              before_first_step=None, iters=CNN_ITERS):
    """A GAN model trained ``iters`` steps through the training entry
    point on the synthetic tree: every logged loss finite at every step,
    ``per_step`` launches of each of the kernels ``wrappers`` names (none
    by default), the step time and the peak memory. Returns (model, record,
    options)."""
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(config)
    forced = dict(e.split('=', 1) for e in extra)
    train_opt = opt['datasets']['train']
    gt_size = forced.get('datasets:train:gt_size', train_opt['gt_size'])
    phase(f'{number}. {title} through basicsr4rs_torch.train on cuda:0 (batch '
          f'{train_opt["batch_size_per_gpu"]}, GT {gt_size}; no TPU kernel on this path)')
    name = forced.get('name', opt['name'])
    wrappers = wrappers or {}
    fresh_run(dict(opt, name=name), wrappers)
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline(short_run(iters, 'train:perceptual_opt:pretrain_path='
                                         + VGG_WEIGHTS, *extra), record, config=config,
                               model_cls=model_cls, loss_key='l_g_total', wrappers=wrappers,
                               before_first_step=before_first_step or keep_fed_batch,
                               after_step=keep_logs)
    torch.cuda.synchronize()
    if model.device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    print(f'pipeline wall time {time.perf_counter() - t0:.3f} s for {iters} steps, one '
          'validation and a checkpoint at the end')
    check_steps(record['steps'], iters, 'l_g_total', per_step or {})
    check_logs_finite(record['steps'])
    return model, record, dict(opt, name=name)


def train_esrgan():
    """Phase 32: ESRGAN x4 as published (RRDBNet 64 x 23, VGGStyleDiscriminator
    64, perceptual on conv5_4, vanilla GAN 0.005, L1 0.01, EMA 0.999, Adam
    1e-4 at batch 16, GT 128) from random weights: the G phase's
    discriminator passes keep its BatchNorm statistics, the EMA moved, the
    checkpoint reloads and gives the EMA network's output; and one step
    by kernel group."""
    from basicsr4rs_torch.archs.discriminator_arch import VGGStyleDiscriminator
    from basicsr4rs_torch.archs.rrdbnet_arch import RRDBNet
    from basicsr4rs_torch.models.esrgan_model import ESRGANModel
    write_cnn_inputs()
    model, record, opt = train_gan(ESRGAN_TRAIN, ESRGANModel, '32', 'train ESRGAN x4 '
                                   '(RRDBNet 64 features, 23 blocks; VGGStyleDiscriminator 64)')
    batch = record['batch']
    model.lq, model.gt = batch['lq'], batch['gt']
    before = {k: v.clone() for k, v in model.net_d.named_buffers()}
    with torch.no_grad():
        model._g_losses(model.net_g(model.lq))
        kept = all(torch.equal(v, before[k]) for k, v in model.net_d.named_buffers())
        model.net_d(model.gt)   # a pass outside the G phase does move them
        moved = not all(torch.equal(v, before[k]) for k, v in model.net_d.named_buffers())
        for k, v in model.net_d.named_buffers():
            v.copy_(before[k])
    print(f'G-phase discriminator passes kept its {len(before)} BatchNorm buffers: {kept}; a '
          f'train-mode pass outside it moved them: {moved}')
    if not (kept and moved):
        fail('the G phase changed the discriminator\'s running statistics, or a D pass did not')
    ema_diff = max((p - e).abs().max().item() for p, e in
                   zip(model.net_g.parameters(), model.net_g_ema.parameters()))
    models_dir = os.path.join('experiments', opt['name'], 'models')
    net = RRDBNet(**net_options(opt)).cuda().eval()
    model.load_network(net, os.path.join(models_dir, 'net_g_latest.pth'), True, 'params_ema')
    d_net = VGGStyleDiscriminator(**net_options(opt, 'network_d'))
    model.load_network(d_net, os.path.join(models_dir, 'net_d_latest.pth'), True)
    with torch.no_grad():
        err = (net(batch['lq'][:2]) - model.net_g_ema(batch['lq'][:2])).abs().max().item()
    print(f'max |net_g - net_g_ema| {ema_diff:.3e}; net_g_latest.pth (params_ema) reloaded: '
          f'output max abs difference from net_g_ema {err:.3e}; net_d_latest.pth loads')
    if not ema_diff > 0 or err > 1e-5:
        fail('the EMA did not move, or the checkpoint does not give the EMA network\'s output')
    phase('32b. device time of an ESRGAN training step by kernel group (torch.profiler)')
    model.optimize_parameters(CNN_ITERS + 1)
    profile_device_time(lambda: model.optimize_parameters(CNN_ITERS + 1), 1, 'step', {},
                        'esrgan_train_step_profile.json')
    del model, net


def serve_rrdbnet():
    """Phase 33: RRDBNet x4 (ESRGAN's generator) served through the test
    entry point and through ``inference_esrgan`` from one random
    ``params_ema`` checkpoint: the same images; latency and device time."""
    import cv2

    from basicsr4rs_torch.archs.rrdbnet_arch import RRDBNet
    from basicsr4rs_torch.inference import inference_esrgan
    from basicsr4rs_torch.utils.options import yaml_load
    phase('33. serve RRDBNet x4 through basicsr4rs_torch.test (test_ESRGAN_x4_synthetic.yml) '
          'and basicsr4rs_torch.inference.inference_esrgan from one random params_ema checkpoint')
    opt = yaml_load(ESRGAN_TEST)
    torch.manual_seed(0)
    ckpt = 'experiments/ESRGAN_x4_synthetic/net_g_seed0.pth'
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({'params_ema': RRDBNet(**net_options(opt)).state_dict()}, ckpt)
    model = run_test_pipeline(ESRGAN_TEST, ['--force_yml', f'path:pretrain_network_g={ckpt}',
                                            'path:param_key_g=params_ema'])
    if model.device.type != 'cuda':
        fail(f'RRDBNet ran on {model.device}')
    out_dir = 'results/chip_smoke/esrgan'
    inference_esrgan.main(['--model_path', ckpt, '--input', os.path.join(CNN_DIR, 'val_LQ'),
                           '--output', out_dir])
    vis = os.path.join(model.opt['path']['visualization'], opt['datasets']['test_1']['name'])
    for i, (h, w) in enumerate(CNN_VAL_LQ):
        a = cv2.imread(os.path.join(vis, f'{i:04d}_{model.opt["name"]}.png'))
        b = cv2.imread(os.path.join(out_dir, f'{i:04d}_ESRGAN.png'))
        if a is None or b is None or a.shape != (SCALE * h, SCALE * w, 3) or a.shape != b.shape:
            fail(f'image {i}: {None if a is None else a.shape}, {None if b is None else b.shape}')
        diff = abs(a.astype(int) - b.astype(int))
        print(f'image {i} ({SCALE * h}x{SCALE * w}): test.py and inference_esrgan differ in '
              f'{int((diff > 0).sum())} values, by at most {int(diff.max())} levels')
        if diff.max() > 1:
            fail('test.py and inference_esrgan give different images')
    items = list(model_loader(model))
    lat = request_latencies(model, items, lambda it: (1, 3, SCALE * it['lq'].shape[2],
                                                      SCALE * it['lq'].shape[3]))
    print('request latency: ' + ', '.join(f'LQ {h}x{w} {ms:.3f} ms' for (h, w), ms in
                                          zip(CNN_VAL_LQ, lat))
          + f'; peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    phase('33b. device time of an RRDBNet x4 request (LQ 128x128) by kernel group '
          '(torch.profiler)')
    model.feed_data(items[0])
    profile_device_time(model.test, 1, 'request', {}, 'rrdbnet_request_profile.json')
    del model


def edsr_paths():
    """Phase 34: EDSR-L x4 served and trained through the entry points with
    ``SWIN_FUSED_CONV=1`` (K10 for its two upsampler convs, 256 -> 1024)
    and without: K10's launches, the two routes' outputs, latency and step
    time; then RCAN x2 as published trained through the entry point with
    K10 (64 -> 256), and one training batch through K10 and without,
    output and gradients; and an EDSR-M x4 forward with and without.
    Returns K10's launches on the entry points' runs."""
    from basicsr4rs_torch.archs.edsr_arch import EDSR
    from basicsr4rs_torch.archs.rcan_arch import RCAN
    from basicsr4rs_torch.models.sr_model import SRModel
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(EDSR_TEST)
    net_opt = net_options(opt)
    phase(f'34. EDSR-L x4 ({net_opt["num_feat"]} features, {net_opt["num_block"]} blocks) '
          'through basicsr4rs_torch.test and .train with SWIN_FUSED_CONV=1 (K10: the two '
          'upsampler convs) and without; RCAN x2 through .train with K10, and a batch with '
          'and without')
    torch.manual_seed(0)
    ckpt = 'experiments/EDSR_Lx4_synthetic/net_g_seed0.pth'
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    torch.save({'params': EDSR(**net_opt).state_dict()}, ckpt)
    launches, outputs, latency, step_ms = 0, {}, {}, {}
    try:
        for knob in ('1', '0'):
            os.environ['SWIN_FUSED_CONV'] = knob
            per_forward = 2 if knob == '1' else 0
            fused_conv3x3.launches = 0
            model = run_test_pipeline(EDSR_TEST, ['--force_yml',
                                                  f'path:pretrain_network_g={ckpt}'])
            torch.cuda.synchronize()
            if fused_conv3x3.launches != per_forward * len(CNN_VAL_LQ):
                fail(f'SWIN_FUSED_CONV={knob}: {fused_conv3x3.launches} K10 launches for '
                     f'{len(CNN_VAL_LQ)} requests, expected {per_forward} each')
            launches += fused_conv3x3.launches
            items = list(model_loader(model))
            latency[knob] = request_latencies(
                model, items, lambda it: (1, 3, SCALE * it['lq'].shape[2],
                                          SCALE * it['lq'].shape[3]),
                (fused_conv3x3, per_forward))
            model.feed_data(items[0])
            model.test()
            outputs[knob] = model.output.float().clamp(0, 1)
            del model

            topt = yaml_load(EDSR_TRAIN)
            fresh_run(topt, {'conv3x3_fwd': fused_conv3x3})
            record = {'steps': []}
            model = run_train_pipeline(short_run(), record, config=EDSR_TRAIN, model_cls=SRModel,
                                       wrappers={'conv3x3_fwd': fused_conv3x3})
            torch.cuda.synchronize()
            print(f'SWIN_FUSED_CONV={knob}, training:')
            step_ms[knob] = check_steps(record['steps'], CNN_ITERS, 'l_pix',
                                        {'conv3x3_fwd': per_forward})
            launches += fused_conv3x3.launches
            print(f'K10 launches in the run (steps, the validation, the fixed batch): '
                  f'{fused_conv3x3.launches}; l_pix on the first batch, eval mode '
                  f'{record["fixed_loss_before"]:.6f} before step 1, '
                  f'{fixed_batch_loss(model, record["fixed"]):.6f} after')
            del model
    finally:
        os.environ.pop('SWIN_FUSED_CONV', None)
    err = (outputs['1'] - outputs['0']).abs().max().item()
    print(f'EDSR-L x4 request LQ {CNN_VAL_LQ[0][0]}x{CNN_VAL_LQ[0][1]}: SWIN_FUSED_CONV=1 against '
          f'the cuDNN route max abs difference {err:.3e} on the [0, 1] output (tolerance '
          f'{MODEL_TOLERANCE}); latency ' + '; '.join(
              f'SWIN_FUSED_CONV={k}: ' + ', '.join(f'{ms:.3f}' for ms in v) + ' ms'
              for k, v in latency.items())
          + '; step ' + ', '.join(f'SWIN_FUSED_CONV={k} {v:.3f} ms' for k, v in step_ms.items()))
    if not err <= MODEL_TOLERANCE:
        fail('EDSR-L: the K10 route disagrees with the cuDNN route')

    ropt = yaml_load(RCAN_TRAIN)
    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        fresh_run(ropt, {'conv3x3_fwd': fused_conv3x3})
        record = {'steps': []}
        model = run_train_pipeline(short_run(), record, config=RCAN_TRAIN, model_cls=SRModel,
                                   wrappers={'conv3x3_fwd': fused_conv3x3})
        torch.cuda.synchronize()
    finally:
        os.environ.pop('SWIN_FUSED_CONV')
    if model.device.type != 'cuda':
        fail(f'RCAN x2 trained on {model.device}')
    print('RCAN x2 through basicsr4rs_torch.train (train_RCAN_x2_synthetic.yml), '
          'SWIN_FUSED_CONV=1:')
    check_steps(record['steps'], CNN_ITERS, 'l_pix', {'conv3x3_fwd': 1})
    launches += fused_conv3x3.launches
    print(f'K10 launches in the run (steps, the validation, the fixed batch): '
          f'{fused_conv3x3.launches}; validation (EMA network): ' + ', '.join(
              f'{k} {v:.4f}' for k, v in model.metric_results.items()))
    if not all(math.isfinite(v) for v in model.metric_results.values()):
        fail('RCAN x2 validation metrics not finite')
    del model
    b, gt = ropt['datasets']['train']['batch_size_per_gpu'], ropt['datasets']['train']['gt_size']
    torch.manual_seed(0)
    net = RCAN(**net_options(ropt)).cuda().train()
    gen = torch.Generator().manual_seed(3)
    scale = ropt['network_g']['upscale']
    lq = torch.rand(b, 3, gt // scale, gt // scale, generator=gen).cuda()
    target = torch.rand(b, 3, gt, gt, generator=gen).cuda()

    # a smooth loss: an L1 loss's gradient flips sign where the two routes'
    # outputs straddle the target, which float32 rounding decides
    def loss_and_grads():
        net.zero_grad(set_to_none=True)
        x = lq.clone().requires_grad_()
        out = net(x)
        loss = (out - target).square().mean()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        return out.detach(), loss.item(), dict(grads, lq=x.grad)

    def forward_backward(knob):
        os.environ['SWIN_FUSED_CONV'] = knob
        try:
            (net(lq) - target).square().mean().backward()
        finally:
            os.environ.pop('SWIN_FUSED_CONV')

    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        fused_conv3x3.launches = 0
        out_k, loss_k, grads_k = loss_and_grads()
        rcan_launches = fused_conv3x3.launches
    finally:
        os.environ.pop('SWIN_FUSED_CONV')
    out_p, loss_p, grads_p = loss_and_grads()
    # without, with, with, without: the host's load drifts over a few seconds
    times = [cuda_time_ms(lambda: forward_backward(knob), iters=3) for knob in '0110']
    step_k, step_p = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    err = (out_k - out_p).abs().max().item()
    print(f'RCAN x2 ({ropt["network_g"]["num_group"]} groups x {ropt["network_g"]["num_block"]} '
          f'RCABs, {ropt["network_g"]["num_feat"]} features), batch {b} of LQ {gt // scale}x'
          f'{gt // scale}: K10 launches a forward {rcan_launches} (64 -> 256); output max abs '
          f'difference {err:.3e}; forward and backward {step_k:.3f} ms with K10, {step_p:.3f} '
          'ms without')
    if rcan_launches != 1 or err > MODEL_TOLERANCE:
        fail('RCAN x2: K10 launches or output')
    compare_gradients('RCAN x2', loss_k, grads_k, loss_p, grads_p)
    del net, grads_k, grads_p

    mopt = yaml_load('options/test/EDSR/test_EDSR_Mx4.yml')   # its network as published
    torch.manual_seed(0)
    net = EDSR(**net_options(mopt)).cuda().eval()
    lq = torch.rand(1, 3, *CNN_VAL_LQ[0], generator=gen).cuda()
    os.environ['SWIN_FUSED_CONV'] = '1'
    try:
        fused_conv3x3.launches = 0
        with torch.no_grad():
            out_k = net(lq)
            m_launches = fused_conv3x3.launches
            ms_k = cuda_time_ms(lambda: net(lq), 5)
    finally:
        os.environ.pop('SWIN_FUSED_CONV')
    with torch.no_grad():
        out_p = net(lq)
        ms_p = cuda_time_ms(lambda: net(lq), 5)
    err = (out_k - out_p).abs().max().item()
    print(f'EDSR-M x4 ({mopt["network_g"]["num_feat"]} features, {mopt["network_g"]["num_block"]} '
          f'blocks), LQ {CNN_VAL_LQ[0][0]}x{CNN_VAL_LQ[0][1]}: K10 launches a forward {m_launches} '
          f'(64 -> 256 twice); output max abs difference {err:.3e}; a forward {ms_k:.3f} ms with '
          f'K10, {ms_p:.3f} ms without')
    if m_launches != 2 or err > MODEL_TOLERANCE:
        fail('EDSR-M x4: K10 launches or output')
    return launches


def train_msrgan():
    """Phase 35: MSRGAN x4 as published (SRGANModel: MSRResNet 64 x 16,
    VGGStyleDiscriminator 64), then SRGANModel with UNetDiscriminatorSN at
    Real-ESRGAN's 64 features on GT 256 (the exact spectral norm on the
    card)."""
    from basicsr4rs_torch.models.srgan_model import SRGANModel
    model, _, opt = train_gan(MSRGAN_TRAIN, SRGANModel, '35', 'train MSRGAN x4 (SRGANModel: '
                              'MSRResNet 64 features, 16 blocks; VGGStyleDiscriminator 64)')
    del model
    model, _, _ = train_gan(MSRGAN_TRAIN, SRGANModel, '35b', 'train SRGANModel with '
                            'UNetDiscriminatorSN (64 features; spectral norm by eigvalsh) at GT '
                            '256', ('network_d:type=UNetDiscriminatorSN',
                                    'datasets:train:gt_size=256', f'name={opt["name"]}_unet_d'))
    if type(model.net_d).__name__ != 'UNetDiscriminatorSN':
        fail(f'the discriminator is {type(model.net_d).__name__}')
    del model


def train_ecbsr_and_forwards():
    """Phase 36: ECBSR x4 m4c16 PReLU on the Y channel as published, trained
    through the entry point; its validation runs each ECB as one conv
    (re-parameterised), held against the branched forward; then
    SRVGGNetCompact and RIDNet forwards at their default widths."""
    from basicsr4rs_torch.archs import build_network
    from basicsr4rs_torch.data import build_dataset
    from basicsr4rs_torch.models.sr_model import SRModel
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(ECBSR_TRAIN)
    train_opt = opt['datasets']['train']
    phase(f'36. train ECBSR x4 m4c16 PReLU on the Y channel through basicsr4rs_torch.train on '
          f'cuda:0 (batch {train_opt["batch_size_per_gpu"]}, GT {train_opt["gt_size"]}), its '
          're-parameterised inference; SRVGGNetCompact and RIDNet forwards (no TPU kernel on '
          'these paths)')
    fresh_run(opt, {})
    record = {'steps': []}
    model = run_train_pipeline(short_run(), record, config=ECBSR_TRAIN, model_cls=SRModel,
                               wrappers={})
    check_steps(record['steps'], CNN_ITERS, 'l_pix', {})
    print('validation (re-parameterised ECBs): ' + ', '.join(
        f'{k} {v:.4f}' for k, v in model.metric_results.items()))
    if not all(math.isfinite(v) for v in model.metric_results.values()):
        fail('ECBSR validation metrics not finite')
    item = build_dataset(model.opt['datasets']['val'])[0]
    lq = item['lq'][None].cuda()
    net = model.net_g
    with torch.no_grad():
        rep = net.eval()(lq)
        branched = net.train()(lq)
        rep_ms = cuda_time_ms(lambda: net.eval()(lq), 5)
        branched_ms = cuda_time_ms(lambda: net.train()(lq), 5)
    err = (rep - branched).abs().max().item() / branched.abs().max().item()
    print(f'ECBSR on LQ {tuple(lq.shape)}: re-parameterised against branched, max abs difference '
          f'/ max {err:.3e} (tolerance {F32_SUM_TOL}); a forward {rep_ms:.3f} ms '
          f're-parameterised, {branched_ms:.3f} ms branched')
    if rep.shape != (1, 1, SCALE * lq.shape[2], SCALE * lq.shape[3]) or err > F32_SUM_TOL:
        fail('ECBSR: the re-parameterised forward differs from the branched one')
    del model
    x = torch.rand(1, 3, 128, 128, generator=torch.Generator().manual_seed(5)).cuda()
    for opt_ in (dict(type='SRVGGNetCompact'), dict(type='RIDNet')):
        torch.manual_seed(0)
        net = build_network(opt_).cuda().eval()
        with torch.no_grad():
            out = net(x)
            ms = cuda_time_ms(lambda: net(x), 5)
        want = (1, 3, 512, 512) if opt_['type'] == 'SRVGGNetCompact' else (1, 3, 128, 128)
        print(f'{opt_["type"]} (default widths) on LQ 128x128: output {tuple(out.shape)}, '
              f'{ms:.3f} ms')
        if tuple(out.shape) != want or not torch.isfinite(out).all():
            fail(f'{opt_["type"]}: output {tuple(out.shape)}')


def cnn_gan_paths(launches):
    """Phases 32 to 36: ESRGAN, RRDBNet, EDSR-L (K10's launches added to
    ``launches``) and RCAN, MSRGAN, ECBSR, SRVGGNetCompact, RIDNet."""
    t0 = time.perf_counter()
    train_esrgan()
    serve_rrdbnet()
    launches['conv3x3_fwd'] += edsr_paths()
    train_msrgan()
    train_ecbsr_and_forwards()
    print(f'phases 32 to 36: {time.perf_counter() - t0:.1f} s')


# ------------------------------------------------ the recurrent video slice
GAN_VIDEO_TRAIN = 'options/train/VideoRecurrentGAN/train_VideoRecurrentGANModel_REDS_synthetic.yml'


def generator_loss(model, batch):
    """The pixel and perceptual losses of the training network in eval mode
    on a fixed batch."""
    net = model.net_g
    net.eval()
    with torch.no_grad():
        loss = float(model.pixel_and_perceptual_losses(net(batch['lq']), batch['gt'], {}))
    net.train()
    return loss


def train_video_gan(number):
    """The video GAN as published (BasicVSR 64 x 30, VGGStyleDiscriminator
    32 at 256, perceptual conv5_4 + GAN 0.005 + L1 0.01, batch 4 of 15 frames,
    GT 256) trained ``CNN_ITERS`` steps through the training entry point
    from random weights: the sampler's launches a step, SpyNet in the
    generator's one param group, the G phase's losses on the first batch
    falling. Returns the sampler's launches."""
    from basicsr4rs_torch.models.video_recurrent_model import VideoRecurrentGANModel
    from basicsr4rs_torch.utils.options import yaml_load
    spec = RECURRENT['BasicVSR']
    for part in ('train', 'val'):
        write_clips(spec['data'], part, *spec['clips'][part])
    write_vgg19()
    train_opt = yaml_load(GAN_VIDEO_TRAIN)['datasets']['train']
    lq = train_opt['gt_size'] // SCALE
    forward = basicvsr_launches((train_opt['batch_size_per_gpu'], train_opt['num_frame'], 3, lq,
                                 lq))
    wrappers = sampler_wrappers()

    def first_batch(model, record):
        keep_fed_batch(model, record)
        record['loss_before'] = generator_loss(model, record['batch'])

    model, record, _ = train_gan(
        GAN_VIDEO_TRAIN, VideoRecurrentGANModel, number,
        f'train the video GAN (BasicVSR 64 x 30, VGGStyleDiscriminator 32 at 256; '
        f'{train_opt["num_frame"]} frames)', wrappers=wrappers,
        per_step={'deform_sample_fwd': forward, 'deform_sample_bwd': forward - 1},
        before_first_step=first_batch)
    launches = {k: w.launches for k, w in wrappers.items()}
    after = generator_loss(model, record['batch'])
    print(f'SpyNet trains in the generator\'s {len(model.optimizer_g.param_groups)} param group '
          f'(the GAN step reads no flow_lr_mul, fix_flow or lr_flow); pixel + perceptual loss '
          f'on the first batch, eval mode: {record["loss_before"]:.6f} before step 1, '
          f'{after:.6f} after step {CNN_ITERS}; launches in the run ' + ' '.join(
              f'{k}={v}' for k, v in launches.items()))
    if len(model.optimizer_g.param_groups) != 1 or not after < record['loss_before']:
        fail('SpyNet has a param group of its own, or the loss on the first batch did not fall')
    del model
    torch.cuda.empty_cache()
    return launches


def inference_matches_test(number):
    """``inference_basicvsr`` and ``inference_basicvsrpp`` on the REDS clip
    with its 30 frames in one forward, as ``basicsr4rs_torch.test`` runs it,
    from the seed-0 weights that phases 37 and 14 served: the same PNGs
    (BasicVSR++'s test run is made here when phase 14 did not run)."""
    import glob

    import cv2

    from basicsr4rs_torch.inference import inference_basicvsr, inference_basicvsrpp
    from basicsr4rs_torch.utils.options import yaml_load
    phase(f'{number}. inference_basicvsr and inference_basicvsrpp on the REDS clip against '
          'basicsr4rs_torch.test\'s images')
    runs = (('BasicVSR', inference_basicvsr, ['--num_feat', '64', '--num_block', '30']),
            ('BasicVSR++', inference_basicvsrpp, ['--mid_channels', '64', '--num_blocks', '7']))
    for name, script, args in runs:
        spec = video_spec(name)
        opt = yaml_load(spec['test_config'])
        clip = os.path.join(opt['datasets']['test_1']['dataroot_lq'], '300')
        vis = os.path.join('results', opt['name'], 'visualization',
                           opt['datasets']['test_1']['name'], '300')
        if len(glob.glob(os.path.join(vis, '*.png'))) != 30:
            write_clips(spec['data'], 'test', *spec['clips']['test'])
            seed0_video_weights(opt, opt['path']['pretrain_network_g'])
            run_test_pipeline(spec['test_config'], [])
        out_dir = os.path.join(PROFILE_DIR, f'inference_{tag_of(name)}')
        t0 = time.perf_counter()
        script.main(['--model_path', opt['path']['pretrain_network_g'], '--input', clip,
                     '--output', out_dir, '--interval', '30', *args])
        wall = time.perf_counter() - t0
        worst, differing = 0, 0
        suffix = 'BasicVSRPP' if name == 'BasicVSR++' else name
        for i in range(30):
            a = cv2.imread(os.path.join(vis, f'{i:08d}_{opt["name"]}.png'))
            b = cv2.imread(os.path.join(out_dir, f'{i:08d}_{suffix}.png'))
            if a is None or b is None or a.shape != b.shape or a.shape != (720, 1280, 3):
                fail(f'{name}, frame {i}: {None if a is None else a.shape}, '
                     f'{None if b is None else b.shape}')
            diff = abs(a.astype(int) - b.astype(int))
            worst, differing = max(worst, int(diff.max())), differing + int((diff > 0).sum())
        print(f'{name}: inference script {wall:.3f} s (model build, 30 frames read, one '
              f'forward, 30 written); its 30 images and test.py\'s differ in {differing} values, '
              f'by at most {worst} levels')
        if worst > 1:
            fail(f'test.py and the inference script give different {name} images')


def recurrent_video_paths(launches):
    """Phases 37 to 46: BasicVSR and IconVSR served on REDS, IconVSR and
    EDVR-L on Vimeo90K, BasicVSR and IconVSR trained (their gradients through
    the kernels against the plain versions), the video GAN, TOFlow and DUF
    served, the two inference scripts; the sampler's launches added to
    ``launches``."""
    t0 = time.perf_counter()
    for name, number in (('BasicVSR', '37'), ('IconVSR', '38'), ('IconVSR Vimeo90K', '39'),
                         ('EDVR-L Vimeo90K', '40')):
        launches['deform_sample_fwd'] += serve_video(name, number)[0]
    for name, number in (('BasicVSR', '41'), ('IconVSR Vimeo90K', '42')):
        trained = train_video(name, number)[0]
        check_video_gradients(name, f'{number}c')
        for kernel in DEFORM_KERNELS:
            launches[kernel] += trained[kernel]
    for kernel, count in train_video_gan('43').items():
        launches[kernel] += count
    for name, number in (('TOFlow', '44'), ('DUF', '45')):
        launches['deform_sample_fwd'] += serve_video(name, number)[0]
    inference_matches_test('46')
    print(f'phases 37 to 46: {time.perf_counter() - t0:.1f} s')


REALESRNET_TRAIN = 'options/train/RealESRGAN/train_realesrnet_x4plus_synthetic.yml'
REALESRGAN_TRAIN = 'options/train/RealESRGAN/train_realesrgan_x4plus_synthetic.yml'
REALESRGAN_DIR = 'datasets/RealESRGAN_synthetic'
REALESRGAN_GT = [(480, 512), (512, 448), (448, 600), (600, 480)] * 6   # each side past 400
REALESRGAN_ITERS = 16   # the pool of 180 fills at batch 12 in 15 steps and swaps at the 16th
# the degrader on the card against its plain run of the same draws on the CPU,
# on the LQ's 8-bit levels. PyTorch's CUDA division by a Python number
# multiplies by its reciprocal, one float32 ulp off the CPU's division in
# a good share of values; that is nothing until a rounding step: JPEG's
# round(dct / q) then flips a coefficient now and then, and a flipped
# coefficient moves its 8x8 luma (16x16 chroma) block by up to q / 4
# levels. So the bound is a share: at most 1e-3 of the LQ values more than
# one level apart (the bound the CPU tests hold the port to against the
# JAX package; the card read at most 2.08e-4 in the six cases), and a mean
# difference under 0.05 levels. A control run of each case with TF32 on
# inside ``apply`` is printed beside the check
DEGRADER_SHARE, DEGRADER_MEAN_LEVELS = 1e-3, 0.05
# the arithmetic is sample by sample, so the plain run takes the first 4
# samples of the card's batch of 12 (a third of the CPU's time)
CPU_SAMPLES = 4
POISSON_LAMBDAS = (0.5, 5., 11.9, 12., 40.)
POISSON_SAMPLES = 2 * 10**6


def write_realesrgan_inputs():
    """``datasets/RealESRGAN_synthetic/``: 24 smooth random GT images past
    400 on both sides listed in ``meta_info.txt`` (the synthetic configs'
    meta-info mode), two validation pairs (LQ 64x64, GT its x4 source), and
    the random VGG19 the GAN config names."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(7)
    for sub in ('GT', 'val_GT', 'val_LQ'):
        os.makedirs(os.path.join(REALESRGAN_DIR, sub), exist_ok=True)
    names = []
    for i, (h, w) in enumerate(REALESRGAN_GT):
        names.append(f'{i:04d}.png')
        cv2.imwrite(os.path.join(REALESRGAN_DIR, 'GT', names[-1]), smooth_image(rng, h, w))
    with open(os.path.join(REALESRGAN_DIR, 'meta_info.txt'), 'w') as f:
        f.writelines(f'{name} ({h}, {w}, 3)\n' for name, (h, w) in zip(names, REALESRGAN_GT))
    for i in range(2):
        gt = smooth_image(rng, 256, 256)
        cv2.imwrite(os.path.join(REALESRGAN_DIR, 'val_GT', f'{i:04d}.png'), gt)
        cv2.imwrite(os.path.join(REALESRGAN_DIR, 'val_LQ', f'{i:04d}.png'),
                    cv2.resize(gt, (64, 64), interpolation=cv2.INTER_CUBIC))
    write_vgg19()


def realesrgan_batch(config):
    """The first training batch of the synthetic config's dataset (B=12 GT
    crops of 400 and their kernels), on the card."""
    from basicsr4rs_torch.data import build_dataset
    from basicsr4rs_torch.data.loader import default_collate
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(config)
    ds_opt = dict(opt['datasets']['train'], phase='train', manual_seed=opt['manual_seed'])
    dataset = build_dataset(ds_opt)
    batch = default_collate([dataset[i] for i in range(ds_opt['batch_size_per_gpu'])])
    return opt, {k: v.cuda() for k, v in batch.items() if torch.is_tensor(v)}


def forced_draws(deg, shape, case, gen):
    """Draws of the degrader with the batch-level branches of ``case`` (0 to
    5; between them every branch): drawn as the model draws them, then each
    batch-level choice set and each stage's noise drawn anew of its kind."""
    import dataclasses

    import numpy as np

    from basicsr4rs_torch.ops.degradation_pipeline import RESIZE_MODES
    d = deg.draw(shape, np.random.default_rng(case), gen, 'cuda')
    canvas1, canvas2 = deg.canvases(shape[-1])
    scales = {'up': np.float32(1.37), 'down': np.float32(0.41), 'keep': np.float32(1.)}
    first, second = RESIZE_MODES[case % 3], RESIZE_MODES[(case + 1) % 3]
    n, c = shape[:2]
    return dataclasses.replace(
        d, resize1=first, scale1=scales[first], method1=case % 3,
        noise1=deg.draw_noise('', case % 2 == 0, (n, c, canvas1, canvas1), gen, 'cuda'),
        blur2=case % 2 == 0, resize2=second, scale2=scales[second], method2=(case + 1) % 3,
        noise2=deg.draw_noise('2', case % 2 == 1, (n, c, canvas2, canvas2), gen, 'cuda'),
        method3=(case + 2) % 3, resize_first=case < 3)


def to_cpu(draws, n):
    """The draws of the first ``n`` samples, every tensor copied to the CPU
    (each per-sample tensor has the batch first)."""
    import dataclasses

    def move(v):
        if torch.is_tensor(v):
            return v[:n].cpu()
        if isinstance(v, tuple):
            return tuple(move(x) for x in v)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: move(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v
    return move(draws)


def check_degrader():
    """Phase 47: the degrader at the published shape on the card against its
    plain run of the same draws on the CPU, in every batch-level branch;
    the Poisson sampler's moments on the card; the time of one synthesis
    call (draws and arithmetic) by CUDA events and by torch.profiler."""
    import numpy as np

    from basicsr4rs_torch.data.degradations import poisson_fields, poisson_sample
    from basicsr4rs_torch.ops.degradation_pipeline import RealESRGANDegrader
    opt, batch = realesrgan_batch(REALESRNET_TRAIN)
    gt, k1, k2, sinc = (batch[k] for k in ('gt', 'kernel1', 'kernel2', 'sinc_kernel'))
    deg = RealESRGANDegrader(opt).to('cuda')
    canvas1, canvas2 = deg.canvases(gt.shape[-1])
    phase(f'47. the degrader on cuda:0: B={gt.shape[0]}, crop {gt.shape[-1]}, canvases '
          f'{canvas1} and {canvas2}, LQ {gt.shape[-1] // opt["scale"]} (no TPU kernel on this path)')
    deg_cpu = RealESRGANDegrader(opt)
    cpu_in = [t[:CPU_SAMPLES].cpu() for t in (gt, k1, k2, sinc)]
    gen = torch.Generator(device='cuda').manual_seed(0)

    def against_cpu(lq, gt_usm, lq_cpu, usm_cpu):
        """(share of LQ levels past one, mean difference in levels, max
        difference, share equal, gt_usm's max abs error)."""
        diff = ((lq[:CPU_SAMPLES].cpu() * 255).round() - (lq_cpu * 255).round()).abs()
        return ((diff > 1).float().mean().item(), diff.mean().item(), diff.max().item(),
                (diff == 0).float().mean().item(),
                (gt_usm[:CPU_SAMPLES].cpu() - usm_cpu).abs().max().item())

    taken, cases = {}, []
    for case in range(6):
        draws = forced_draws(deg, gt.shape, case, gen)
        lq, _, gt_usm = deg.apply(gt, k1, k2, sinc, draws)
        lq_cpu, _, usm_cpu = deg_cpu.apply(*cpu_in, to_cpu(draws, CPU_SAMPLES))
        cases.append((draws, lq_cpu, usm_cpu))
        share, mean_levels, most, equal, usm_err = against_cpu(lq, gt_usm, lq_cpu, usm_cpu)
        for name, value in draws.branches().items():
            taken.setdefault(name, set()).add(value)
        print(f'case {case}: {draws.branches()}: LQ levels of samples 0 to {CPU_SAMPLES - 1} '
              f'past one from the CPU run '
              f'{share:.2e} (bound {DEGRADER_SHARE:.0e}), mean difference {mean_levels:.2e} '
              f'levels (bound {DEGRADER_MEAN_LEVELS}), max {most:.0f}, equal {equal:.6f}; '
              f'gt_usm max abs err {usm_err:.2e}; LQ mean {lq.mean().item():.4f}')
        if lq.shape != (gt.shape[0], 3, 100, 100) or not torch.isfinite(lq).all():
            fail(f'degrader case {case}: LQ {tuple(lq.shape)} or not finite')
        if share > DEGRADER_SHARE or mean_levels > DEGRADER_MEAN_LEVELS or usm_err > 1e-5:
            fail(f'degrader case {case} disagrees with its CPU run')
    # the control: the same draws with TF32 left on for cuDNN and cuBLAS
    # inside ``apply``, against the same CPU runs; printed, not required
    from basicsr4rs_torch.ops import degradation_pipeline

    @contextlib.contextmanager
    def tf32_on():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    with mock.patch.object(degradation_pipeline, 'full_float32', tf32_on):
        for case, (draws, lq_cpu, usm_cpu) in enumerate(cases):
            lq, _, gt_usm = deg.apply(gt, k1, k2, sinc, draws)
            share, mean_levels, most, equal, usm_err = against_cpu(lq, gt_usm, lq_cpu, usm_cpu)
            caught = share > DEGRADER_SHARE or mean_levels > DEGRADER_MEAN_LEVELS
            print(f'control, case {case} with TF32 on inside apply: LQ levels past one '
                  f'{share:.2e}, mean difference {mean_levels:.2e} levels, max {most:.0f}, '
                  f'equal {equal:.6f} ({"outside" if caught else "inside"} the LQ bounds); '
                  f'gt_usm max abs err {usm_err:.2e}')
    missing = {k: v for k, v in {'resize1': 3, 'method1': 3, 'noise1': 2, 'blur2': 2,
                                 'resize2': 3, 'method2': 3, 'noise2': 2, 'method3': 3,
                                 'order': 2}.items() if len(taken[k]) != v}
    if missing:
        fail(f'degrader cases missed branches of {list(missing)}')
    print('every batch-level branch taken: ' + '; '.join(f'{k} {sorted(map(str, v))}'
                                                         for k, v in taken.items()))

    for lam in POISSON_LAMBDAS:
        shape = (POISSON_SAMPLES,)
        s = poisson_sample(torch.full(shape, lam, device='cuda'),
                           *poisson_fields(shape, gen, 'cuda')).double()
        mean, var = s.mean().item(), s.var().item()
        print(f'Poisson on the card at lambda {lam}: mean {mean:.4f} (want within '
              f'{5 * math.sqrt(lam / POISSON_SAMPLES):.4f}), variance / lambda {var / lam:.4f}')
        if abs(mean - lam) > 5 * math.sqrt(lam / POISSON_SAMPLES) or abs(var / lam - 1) > 0.02:
            fail(f'the Poisson sampler\'s moments at lambda {lam}')

    rng = np.random.default_rng(1)

    def synthesis():
        return deg(gt, k1, k2, sinc, rng, gen)

    ms = cuda_time_ms(synthesis, iters=20)
    draws = [deg.draw(gt.shape, rng, gen, 'cuda') for _ in range(20)]
    it = iter(draws * 2)
    apply_ms = cuda_time_ms(lambda: deg.apply(gt, k1, k2, sinc, next(it)), iters=20)
    print(f'one synthesis call (draws and arithmetic, random branches): {ms:.3f} ms by CUDA events '
          f'(mean of 20), the arithmetic alone {apply_ms:.3f} ms; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    phase('47b. device time of one synthesis call (torch.profiler, device activity)')
    busy, by_name, _ = trace_device_ms(synthesis, 'degrader_trace.json')
    print(f'{busy:.3f} ms of device time, {sum(n for _, n in by_name.values())} launches; the '
          f'longest: {longest_kernels(by_name)}')


def timed_feeds(model_cls, record):
    """``feed_data`` of ``model_cls`` that times each synthesising call by
    CUDA events into ``record['feed_ms']`` and keeps the first raw batch."""
    feed = model_cls.feed_data

    def timed(model, data):
        if not model._synthesizes(data):
            return feed(model, data)
        record.setdefault('raw', data)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        feed(model, data)
        end.record()
        torch.cuda.synchronize()
        record.setdefault('feed_ms', []).append(start.elapsed_time(end))
        record.setdefault('swaps', []).append(model.pool.swaps)
    return timed


def counted_validations(model_cls, record):
    validate = model_cls.validation

    def counted(model, *args, **kwargs):
        record.setdefault('validations', []).append(model._test_net() is model.net_g_ema)
        return validate(model, *args, **kwargs)
    return counted


def trace_device_ms(run, json_name, ranges=()):
    """Device time of one call of ``run`` by a ``torch.profiler`` trace,
    summed from the trace as exported to ``results/chip_smoke/``
    (``key_averages`` builds a Python object an event: a D phase's 10^5
    launches took it most of a minute): (busy ms, {kernel: (ms, launches)},
    {range: ms}). With ``ranges``, the names of ``record_function`` ranges,
    the host's activity is traced too and each device event goes to the
    innermost of those ranges around the host call that launched it (by the
    trace's correlation ids); without, the device's activity alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * bool(ranges) + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    os.makedirs(PROFILE_DIR, exist_ok=True)
    path = os.path.join(PROFILE_DIR, json_name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in events
                   if e.get('cat') == 'user_annotation' and e['name'] in ranges)
    launched_at = {e['args']['correlation']: e['ts'] for e in events
                   if e.get('cat') in ('cuda_runtime', 'cuda_driver') and 'correlation' in
                   e.get('args', {})}
    by_name, by_range = {}, dict.fromkeys(ranges, 0.)
    for e in events:
        if e.get('cat') not in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            continue
        ms, n = by_name.get(e['name'], (0., 0))
        by_name[e['name']] = (ms + e['dur'] / 1e3, n + 1)
        ts = launched_at.get(e.get('args', {}).get('correlation'))
        inner = [name for start, end, name in spans if ts is not None and start <= ts <= end]
        if inner:   # the spans are sorted by start: the last one holding ts is the innermost
            by_range[inner[-1]] += e['dur'] / 1e3
    return sum(ms for ms, _ in by_name.values()), by_name, by_range


def longest_kernels(by_name, n=3):
    """The ``n`` kernels of ``trace_device_ms`` with the most device time, as text."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return '; '.join(f'{ms:.1f} ms in {k} x {name[:60]}' for name, (ms, k) in top)


STEP_RANGES = ('synthesis', 'optimize_parameters', 'G phase', 'D phase')


def profile_step(model, raw, current_iter):
    """Device time of one more training step as ``train.py`` runs it
    (``feed_data`` on a raw batch, then ``optimize_parameters``), split by
    the profiler ranges of the model code: the synthesis, and a GAN's G and
    D phases (a model without them: its whole ``optimize_parameters`` is
    G), and the rest: {name: ms}."""
    from torch.profiler import record_function

    def step():
        model.feed_data(raw)
        with record_function('optimize_parameters'):
            model.optimize_parameters(current_iter)

    t0 = time.perf_counter()
    busy, by_name, by_range = trace_device_ms(
        step, f'{model.opt["model_type"]}_step_trace.json', STEP_RANGES)
    split = {'synthesis': by_range['synthesis']}
    if hasattr(model, 'net_d'):
        split.update(G=by_range['G phase'], D=by_range['D phase'])
    else:
        split['G'] = by_range['optimize_parameters']
    split['rest'] = busy - sum(split.values())
    print(f'one step traced (host and device, {time.perf_counter() - t0:.1f} s with the trace\'s '
          f'export and reading): {busy:.3f} ms of device time, '
          f'{sum(n for _, n in by_name.values())} launches; the longest: '
          f'{longest_kernels(by_name)}')
    return split


def train_realesrgan(config, model_cls, number, title, loss_key):
    """A Real-ESRGAN model trained ``REALESRGAN_ITERS`` steps through the
    training entry point on the synthetic config as it stands: every step's
    synthesis timed and its losses finite, the pool's swap at the step where
    it fills, one validation on ``net_g_ema``, the checkpoint reloading to
    the EMA network's output; then the device time of synthesis, G and D."""
    from basicsr4rs_torch.archs.rrdbnet_arch import RRDBNet
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(config)
    train_opt = opt['datasets']['train']
    phase(f'{number}. {title} through basicsr4rs_torch.train on cuda:0 (batch '
          f'{train_opt["batch_size_per_gpu"]}, GT {opt["gt_size"]}, crops of '
          f'{train_opt.get("crop_pad_size", 400)} degraded on the card, pool {opt["queue_size"]}; '
          'no TPU kernel on this path)')
    fresh_run(opt, {})
    record = {'steps': []}
    t0 = time.perf_counter()
    with mock.patch.object(model_cls, 'feed_data', timed_feeds(model_cls, record)), \
            mock.patch.object(model_cls, 'validation', counted_validations(model_cls, record)):
        model = run_train_pipeline(['--force_yml', 'logger:print_freq=4',
                                    'logger:use_tb_logger=false'], record, config=config,
                                   model_cls=model_cls, loss_key=loss_key, wrappers={},
                                   before_first_step=lambda m, r: None, after_step=keep_logs)
    torch.cuda.synchronize()
    if model.device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    print(f'pipeline wall time {time.perf_counter() - t0:.3f} s for {REALESRGAN_ITERS} steps, one '
          'validation and a checkpoint at the end')
    step_ms = check_steps(record['steps'], REALESRGAN_ITERS, loss_key, {})
    check_logs_finite(record['steps'])
    feeds, swaps = record['feed_ms'], record['swaps']
    full_at = opt['queue_size'] // train_opt['batch_size_per_gpu']
    if len(feeds) != REALESRGAN_ITERS or swaps != [0] * full_at + [1] * (REALESRGAN_ITERS -
                                                                          full_at):
        fail(f'pool swaps by step {swaps}: expected the first at step {full_at + 1}')
    feed_ms = sum(feeds[2:]) / len(feeds[2:])
    print(f'synthesis (feed_data: degrade, crop, pool, USM): {feed_ms:.3f} ms mean of steps '
          f'3..{REALESRGAN_ITERS} by CUDA events, {100 * feed_ms / (feed_ms + step_ms):.1f}% of '
          f'synthesis + optimize_parameters ({feed_ms + step_ms:.3f} ms); the pool swapped first '
          f'at step {full_at + 1} ({swaps[-1]} swaps in {REALESRGAN_ITERS} steps)')
    if record.get('validations') != [True] or not all(
            math.isfinite(v) for v in model.metric_results.values()):
        fail(f'validations {record.get("validations")} (want one, on net_g_ema), metrics '
             f'{model.metric_results}')
    print(f'one validation on net_g_ema: {model.metric_results}')
    net = RRDBNet(**net_options(opt)).cuda().eval()
    model.load_network(net, os.path.join('experiments', opt['name'], 'models',
                                         'net_g_latest.pth'), True, 'params_ema')
    lq = model.lq[:2]
    with torch.no_grad():
        err = (net(lq) - model.net_g_ema(lq)).abs().max().item()
    print(f'net_g_latest.pth (params_ema) reloaded: output max abs difference from net_g_ema '
          f'{err:.3e}')
    if err > 1e-5:
        fail('the checkpoint does not give the EMA network\'s output')
    phase(f'{number}b. device time of a step by phase (torch.profiler ranges of the model code)')
    split = profile_step(model, record['raw'], REALESRGAN_ITERS + 1)
    total = sum(split.values())
    if total > 0:
        print('device time a step: ' + ', '.join(f'{k} {v:.3f} ms ({100 * v / total:.1f}%)'
                                                 for k, v in split.items())
              + f'; total {total:.3f} ms')
    else:
        print('the profiler recorded no device time')
    del model, net
    torch.cuda.empty_cache()
    return step_ms, feed_ms, split


def realesrgan_paths():
    """Phases 47 to 49: the degrader, RealESRNet x4plus and RealESRGAN
    x4plus; no kernel on this path."""
    from basicsr4rs_torch.models.realesrgan_model import RealESRGANModel
    from basicsr4rs_torch.models.realesrnet_model import RealESRNetModel
    t0 = time.perf_counter()
    write_realesrgan_inputs()
    check_degrader()
    t1 = time.perf_counter()
    train_realesrgan(REALESRNET_TRAIN, RealESRNetModel, '48', 'train RealESRNet x4plus '
                     '(RRDBNet 64 x 23, growth 32; L1 against the sharpened GT)', 'l_pix')
    t2 = time.perf_counter()
    train_realesrgan(REALESRGAN_TRAIN, RealESRGANModel, '49', 'train RealESRGAN x4plus '
                     '(RRDBNet 64 x 23; UNetDiscriminatorSN 64; L1, VGG19 perceptual, GAN)',
                     'l_g_total')
    print(f'phases 47 to 49: {time.perf_counter() - t0:.1f} s (47 {t1 - t0:.1f}, 48 '
          f'{t2 - t1:.1f}, 49 {time.perf_counter() - t2:.1f})')


FFHQ_DIR = 'datasets/FFHQ_256_synthetic'
HIFACEGAN_DIR = 'datasets/HiFaceGAN_synthetic'
STYLEGAN2_TRAIN = 'options/train/StyleGAN/train_StyleGAN2_256_Cmul2_FFHQ_synthetic.yml'
HIFACEGAN_TRAIN = 'options/train/HiFaceGAN/train_hifacegan_synthetic.yml'
HIFACEGAN_TESTS = ('options/test/HiFaceGAN/test_hifacegan_synthetic.yml',
                   'options/test/HiFaceGAN/test_hifacegan_woGT_synthetic.yml')
STYLEGAN2_ITERS = 16   # the path-length term at steps 4, 8, 12 and 16, R1 at 16
HIFACEGAN_ITERS = 4
# the same regularised StyleGAN2 step (R1 and path length) on the card and
# the CPU in float32, TF32 off, each against the card in float64: the card's
# logged values within the larger of 1e-4 relative and 10 times the CPU
# float32 run's distance, each parameter gradient (of its tensor's largest
# entry) within the larger of GRAD_TOLERANCE and 10 times the CPU's. The
# path-length term is a second-order gradient, and a scalar parameter's
# gradient (a noise weight) sums a whole map of terms of both signs: float32
# moves both by 1e-4 to 1e-3 on either device
STEP_LOG_TOLERANCE = 1e-4
# DFDNet's face on the card against the CPU's run of the same net and
# dictionary, on its [-1, 1] output: MODEL_TOLERANCE of the [0, 1] range
DFDNET_TOLERANCE = 2 * MODEL_TOLERANCE
DFDNET_DICT_SIZES = {256: (128, 9), 128: (256, 7), 64: (512, 5), 32: (512, 3)}
DFDNET_BOXES = [[120., 150., 200., 230.], [300., 150., 380., 230.], [220., 240., 290., 320.],
                [200., 340., 310., 420.]]   # left eye, right eye, nose, mouth at 512


def write_face_inputs():
    """``datasets/FFHQ_256_synthetic/``: 12 smooth 256x256 faces' stand-ins;
    ``datasets/HiFaceGAN_synthetic/``: two training and two validation pairs
    of 512x512 (LQ the GT's x4 bicubic down- and upscale); the random
    VGG19 the HiFaceGAN file names."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(11)
    os.makedirs(FFHQ_DIR, exist_ok=True)
    for i in range(12):
        cv2.imwrite(os.path.join(FFHQ_DIR, f'{i:05d}.png'), smooth_image(rng, 256, 256))
    for gt_dir, lq_dir in (('GT', 'LQ'), ('val_GT', 'val_LQ')):
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(HIFACEGAN_DIR, sub), exist_ok=True)
        for i in range(2):
            gt = smooth_image(rng, 512, 512)
            lq = cv2.resize(cv2.resize(gt, (128, 128), interpolation=cv2.INTER_CUBIC),
                            (512, 512), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(HIFACEGAN_DIR, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(HIFACEGAN_DIR, lq_dir, f'{i:04d}.png'), lq)
    write_vgg19()


def keep_real_batch(model, record):
    record.setdefault('raw', {'gt': model.real_img.clone()})


def on_cuda(what, *tensors):
    for t in tensors:
        if t.device.type != 'cuda':
            fail(f'{what} is on {t.device}')


def train_stylegan2():
    """Phase 50: StyleGAN2 256 Cmul2 trained ``STYLEGAN2_ITERS`` steps
    through the training entry point: R1 and the path-length term non-zero
    on their steps only, every log finite, step times by kind, peak memory;
    then one more step with both terms timed, and traced for its device
    time by phase."""
    import numpy as np

    from basicsr4rs_torch.models.stylegan2_model import StyleGAN2Model
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(STYLEGAN2_TRAIN)
    g, train = opt['network_g'], opt['train']
    phase(f'50. train StyleGAN2 {g["out_size"]} Cmul{g["channel_multiplier"]} '
          f'({g["num_style_feat"]} style features, {g["num_mlp"]} MLP layers) through '
          'basicsr4rs_torch.train on cuda:0 (batch '
          f'{opt["datasets"]["train"]["batch_size_per_gpu"]}, '
          f'{STYLEGAN2_ITERS} steps; R1 every {train["net_d_reg_every"]}, path length every '
          f'{train["net_g_reg_every"]}; no TPU kernel on this path)')
    fresh_run(opt, {})
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline(['--force_yml', 'logger:print_freq=4', 'logger:use_tb_logger=false'],
                               record, config=STYLEGAN2_TRAIN, model_cls=StyleGAN2Model,
                               loss_key='l_g', wrappers={}, before_first_step=keep_real_batch,
                               after_step=keep_logs)
    torch.cuda.synchronize()
    on_cuda('StyleGAN2', model.real_img, *model.net_g.parameters(), *model.net_d.parameters(),
            *model.net_g_ema.parameters())
    print(f'pipeline wall time {time.perf_counter() - t0:.3f} s for {STYLEGAN2_ITERS} steps and a '
          'checkpoint at the end')
    steps = record['steps']
    check_steps(steps, STYLEGAN2_ITERS, 'l_g', {})
    check_logs_finite(steps)
    for st in steps:
        r1, path = st['iter'] % train['net_d_reg_every'] == 0, st['iter'] % train[
            'net_g_reg_every'] == 0
        if (st['logs']['l_d_r1'] != 0) != r1 or (st['logs']['l_g_path'] != 0) != path:
            fail(f'step {st["iter"]}: l_d_r1 {st["logs"]["l_d_r1"]}, l_g_path '
                 f'{st["logs"]["l_g_path"]} (R1 due: {r1}, path length due: {path})')
    kinds = {'plain': [st['ms'] for st in steps[2:] if st['iter'] % train['net_g_reg_every']],
             'path length': [st['ms'] for st in steps[2:] if st['iter'] % train[
                 'net_g_reg_every'] == 0 and st['iter'] % train['net_d_reg_every']],
             'path length and R1': [st['ms'] for st in steps if st['iter'] % train[
                 'net_d_reg_every'] == 0]}
    print('step time by kind (steps 3..16, CUDA events): ' + '; '.join(
        f'{k} {np.mean(v):.3f} ms (n={len(v)})' for k, v in kinds.items()))
    print('l_g_path by step: ' + ', '.join(f'{st["iter"]}: {st["logs"]["l_g_path"]:.4f}'
                                          for st in steps if st['logs']['l_g_path']))
    print(f'path length at the last path step: {steps[-1]["logs"]["path_length"]:.5f}, mean '
          f'path length {float(model.mean_path_length):.5f}')

    def regularised_step():
        model.step = 31   # the count gates the terms only: the next is the 32nd, both run
        model.feed_data(record['raw'])
        model.optimize_parameters(0)

    torch.cuda.synchronize()   # step 16 ran both terms: the routes are warm
    t1 = time.perf_counter()
    regularised_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    phase('50a. device time of one step with R1 and the path-length term (torch.profiler '
          'ranges of the model code)')
    busy, by_name, by_range = trace_device_ms(regularised_step, 'stylegan2_step_trace.json',
                                              ('D phase', 'G phase'))
    print(f'{busy:.3f} ms of device time, {sum(n for _, n in by_name.values())} launches, '
          f'against {wall_ms:.3f} ms of wall time for the same step untraced: device busy '
          f'{100 * busy / wall_ms:.1f}%; D phase {by_range["D phase"]:.3f} ms, G phase '
          f'{by_range["G phase"]:.3f} ms; the longest: {longest_kernels(by_name, 4)}')
    return model, opt


def stylegan2_card_vs_cpu(opt):
    """Phase 50b: one step with R1 and the path-length term at out_size 64,
    narrow 0.25, on the card and the CPU in float32 and on the card in
    float64, from the same weights, batch, codes and noise: the logged
    values and every parameter gradient of the two float32 runs against
    the float64 one (exact to float32 on either device)."""
    import copy

    from basicsr4rs_torch.models import build_model
    phase('50b. one StyleGAN2 step with R1 and the path-length term on the card and on the CPU '
          '(out_size 64, narrow 0.25; the same weights, batch, codes and noise; TF32 off), both '
          'against the card in float64')
    small = copy.deepcopy(opt)
    for key in ('network_g', 'network_d'):
        small[key].update(out_size=64, narrow=0.25)
    small.update(is_train=True, dist=False, rank=0, world_size=1)
    small['path'].update(pretrain_network_g=None, pretrain_network_d=None)
    models = {}
    for run, num_gpu in (('card', 1), ('cpu', 0), ('float64', 1)):
        torch.manual_seed(0)
        models[run] = build_model(dict(copy.deepcopy(small), num_gpu=num_gpu))
    for name in ('net_g', 'net_g_ema', 'net_d'):
        for run in ('cpu', 'float64'):
            getattr(models[run], name).load_state_dict(getattr(models['card'], name).state_dict())
        getattr(models['float64'], name).double()
    real = torch.rand((3, 3, 64, 64), generator=torch.Generator().manual_seed(1)) * 2 - 1
    draws = models['cpu'].draw_step(3, True)
    logs, grads = {}, {}
    for run, model in models.items():
        model.step = small['train']['net_d_reg_every'] - 1   # the next step runs both terms
        dtype = torch.float64 if run == 'float64' else torch.float32
        model.feed_data({'gt': real.to(dtype)})
        moved = {k: [t.to(model.device, dtype) for t in v] if isinstance(v, list)
                 else v.to(model.device, dtype) for k, v in draws.items()}
        with mock.patch.object(model, 'draw_step', lambda batch, regularize_g: moved):
            model.optimize_parameters(0)
        logs[run] = model.get_current_log()
        grads[run] = {f'{net}.{name}': p.grad.detach().double().cpu() for net in ('net_g', 'net_d')
                      for name, p in getattr(model, net).named_parameters()}
    on_cuda('the card\'s step', models['card'].real_img, *models['card'].net_g.parameters())
    exact_logs, exact = logs.pop('float64'), grads.pop('float64')
    if not exact_logs['l_d_r1'] or not exact_logs['l_g_path']:
        fail('the compared step did not run both terms')
    worst = {}
    for run in ('card', 'cpu'):
        if not all(torch.isfinite(g).all() for g in grads[run].values()):
            fail(f'non-finite gradients on the {run}')
        log_err = max(abs(logs[run][k] - v) / max(abs(v), 1e-6) for k, v in exact_logs.items())
        grad_err, at = max((((grads[run][k] - g).abs().max() / g.abs().max().clamp(min=1e-12)
                             ).item(), k) for k, g in exact.items())
        worst[run] = (log_err, grad_err)
        print(f'{run} (float32) against float64: logs {log_err:.3e} relative; '
              f'{len(exact)} parameter gradients, largest max|difference| / max|float64| of '
              f'the tensor {grad_err:.3e} at {at}')
    print('logs (card / CPU float32 / float64): ' + ', '.join(
        f'{k} {logs["card"][k]:.6f} / {logs["cpu"][k]:.6f} / {v:.6f}' for k, v in
        exact_logs.items()))
    bounds = (max(STEP_LOG_TOLERANCE, 10 * worst['cpu'][0]),
              max(GRAD_TOLERANCE, 10 * worst['cpu'][1]))
    print(f'bounds on the card: logs {bounds[0]:.3e}, gradients {bounds[1]:.3e} (the larger of '
          f'{STEP_LOG_TOLERANCE} / {GRAD_TOLERANCE} and 10 times the CPU float32 run\'s)')
    if worst['card'][0] > bounds[0] or worst['card'][1] > bounds[1]:
        fail('the card\'s StyleGAN2 step is further from float64 than float32 allows')


def sample_stylegan2(opt):
    """Phase 50c: ``inference_stylegan2`` with truncation 0.7 on the trained
    EMA generator; phase 50d: one forward of the bilinear generator at 256."""
    import cv2

    from basicsr4rs_torch.archs.stylegan2_arch import StyleGAN2Generator
    from basicsr4rs_torch.archs.stylegan2_bilinear_arch import StyleGAN2GeneratorBilinear
    from basicsr4rs_torch.inference import inference_stylegan2
    g = opt['network_g']
    phase('50c. sample the trained generator through basicsr4rs_torch.inference.'
          'inference_stylegan2 (params_ema, truncation 0.7 about the mean W of 4096 codes)')
    out_dir = os.path.join(PROFILE_DIR, 'stylegan2_samples')
    ckpt = os.path.join('experiments', opt['name'], 'models', 'net_g_latest.pth')
    devices = set()
    synthesis = StyleGAN2Generator.synthesis

    def spy(net, latent, *args, **kwargs):
        devices.add(latent.device.type)
        return synthesis(net, latent, *args, **kwargs)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(StyleGAN2Generator, 'synthesis', spy):
        inference_stylegan2.main(['--model_path', ckpt, '--out_size', str(g['out_size']),
                                  '--channel_multiplier', str(g['channel_multiplier']),
                                  '--truncation', '0.7', '--sample', '4', '--pics', '2',
                                  '--output', out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if devices != {'cuda'}:
        fail(f'the sampler ran on {devices}')
    imgs = [cv2.imread(os.path.join(out_dir, f'{i:06d}.png')) for i in range(8)]
    if any(im is None or im.shape != (g['out_size'], g['out_size'], 3) for im in imgs) or \
            all(im.std() == 0 for im in imgs):
        fail('the sampler did not write 8 images of the output size')
    print(f'8 samples of {g["out_size"]}x{g["out_size"]} in {wall:.3f} s (load, the mean W, 2 '
          f'batches of 4, PNGs); pixel std of the first {imgs[0].std():.2f} levels')
    phase('50d. one forward of StyleGAN2GeneratorBilinear at 256 Cmul2 (batch 3, random weights)')
    torch.manual_seed(0)
    net = StyleGAN2GeneratorBilinear(out_size=g['out_size'], num_style_feat=g['num_style_feat'],
                                     num_mlp=g['num_mlp'],
                                     channel_multiplier=g['channel_multiplier'],
                                     lr_mlp=g['lr_mlp']).cuda().eval()
    z = torch.randn((3, g['num_style_feat']), device='cuda',
                    generator=torch.Generator('cuda').manual_seed(0))
    gen = torch.Generator('cuda')

    def forward():
        gen.manual_seed(0)
        with torch.inference_mode():
            return net([z], generator=gen)[0]

    out = forward()
    if out.shape != (3, 3, g['out_size'], g['out_size']) or not torch.isfinite(out).all() or \
            out.device.type != 'cuda':
        fail(f'bilinear generator: {tuple(out.shape)} on {out.device}')
    print(f'output {tuple(out.shape)}, std {out.std().item():.4f}; '
          f'{cuda_time_ms(forward, iters=5):.3f} ms a forward (CUDA events, mean of 5)')
    del net


def train_and_serve_hifacegan():
    """Phases 51 and 52: HiFaceGAN trained ``HIFACEGAN_ITERS`` steps at the
    published widths, its device time split between G and D; then served
    through both test files from the checkpoint it wrote."""
    import glob

    from basicsr4rs_torch.models.hifacegan_model import HiFaceGANModel
    model, record, opt = train_gan(HIFACEGAN_TRAIN, HiFaceGANModel, '51', 'train HiFaceGAN '
                                   '(48 features, crop 512, spectral SPADE with batch statistics; '
                                   'HiFaceGANDiscriminator 64, two scales; lsgan, feature '
                                   'matching, VGG19 perceptual)', iters=HIFACEGAN_ITERS)
    on_cuda('HiFaceGAN', model.lq, model.output, *model.net_g.parameters(),
            *model.net_d.parameters())
    if not all(math.isfinite(v) for v in model.metric_results.values()):
        fail(f'validation metrics {model.metric_results}')
    print(f'one validation (net_g): {model.metric_results}')
    phase('51b. device time of a HiFaceGAN step by phase (torch.profiler ranges of the model code)')
    split = profile_step(model, record['batch'], HIFACEGAN_ITERS + 1)
    total = sum(split.values())
    print('device time a step: ' + ', '.join(f'{k} {v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)'
                                             for k, v in split.items()) + f'; total {total:.3f} ms')
    del model
    torch.cuda.empty_cache()
    for i, config in enumerate(HIFACEGAN_TESTS):
        phase(f'52{"ab"[i]}. serve HiFaceGAN through basicsr4rs_torch.test '
              f'({os.path.basename(config)}: the checkpoint of phase 51)')
        served = run_test_pipeline(config, [])
        on_cuda('HiFaceGAN served', served.lq, served.output, *served.net_g.parameters())
        pngs = glob.glob(os.path.join(served.opt['path']['visualization'], '*', '*.png'))
        if len(pngs) != 2:
            fail(f'{config} wrote {len(pngs)} images, expected 2')
        items = list(model_loader(served))
        lat = request_latencies(served, items, lambda it: (1, 3, 512, 512))
        metrics = getattr(served, 'metric_results', None)
        print(f'2 images written; metrics {metrics}; request latency ' + ', '.join(
            f'{ms:.3f} ms' for ms in lat) + f'; peak device memory '
            f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
        if i == 0:
            served.feed_data(items[0])
            busy, by_name, _ = trace_device_ms(served.test, 'hifacegan_request_trace.json')
            eig = sum(ms for name, (ms, _) in by_name.items() if 'syev' in name)
            print(f'one request traced: {busy:.3f} ms of device time, '
                  f'{sum(n for _, n in by_name.values())} launches; the exact spectral norms\' '
                  f'eigensolvers (syev*) {eig:.3f} ms; the longest: {longest_kernels(by_name, 4)}')
        del served


def serve_dfdnet():
    """Phase 53: DFDNet (64 features) on one 512x512 face through
    ``inference_dfdnet`` with a random dictionary of the published shapes
    and fixed boxes; the same request on the card and on the CPU: the
    faces, and the entries each part selected."""
    import copy

    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.dfdnet_arch import DFDNet, load_dfdnet_dict
    from basicsr4rs_torch.archs.vgg_arch import load_vgg_params
    from basicsr4rs_torch.inference import inference_dfdnet
    phase('53. DFDNet (64 features, VGG19 features, a random dictionary of 3 entries a part) on '
          'a 512x512 face through basicsr4rs_torch.inference.inference_dfdnet; the card against '
          'the CPU')
    root = os.path.join(PROFILE_DIR, 'dfdnet')
    os.makedirs(os.path.join(root, 'in'), exist_ok=True)
    torch.manual_seed(0)
    net = DFDNet(num_feat=64)
    load_vgg_params(net.vgg_extractor, VGG_WEIGHTS)   # He-scaled: deep features keep their size
    torch.save({'params': net.state_dict()}, os.path.join(root, 'net.pth'))
    gen = torch.Generator().manual_seed(0)
    parts = DFDNet.parts
    torch.save({f'{size}': {p: torch.randn(3, ch, k, k, generator=gen) for p in parts}
                for size, (ch, k) in DFDNET_DICT_SIZES.items()}, os.path.join(root, 'dict.pth'))
    face = smooth_image(np.random.RandomState(13), 512, 512)
    cv2.imwrite(os.path.join(root, 'in', 'face.png'), face)
    with open(os.path.join(root, 'boxes.txt'), 'w') as f:
        f.write('face.png ' + ' '.join(f'{v:g}' for v in np.ravel(DFDNET_BOXES)) + '\n')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inference_dfdnet.main(['--model_path', os.path.join(root, 'net.pth'), '--dict_path',
                           os.path.join(root, 'dict.pth'), '--input', os.path.join(root, 'in'),
                           '--locations', os.path.join(root, 'boxes.txt'), '--output',
                           os.path.join(root, 'out')])
    torch.cuda.synchronize()
    print(f'inference_dfdnet: {time.perf_counter() - t0:.3f} s (load, one face, its PNG)')
    written = cv2.imread(os.path.join(root, 'out', 'face.png'))
    x = torch.from_numpy(face[..., ::-1].astype(np.float32) / 255. * 2 - 1).permute(2, 0, 1)[None]
    boxes = [np.asarray(DFDNET_BOXES[i:i + 1]) for i in range(4)]
    dictionary = load_dfdnet_dict(os.path.join(root, 'dict.pth'))
    card = net.cuda().eval()
    on_device = {s: {p: torch.from_numpy(v).cuda() for p, v in d.items()}
                 for s, d in dictionary.items()}
    xc = x.cuda()

    def request():
        with torch.inference_mode():
            return card(xc, boxes, on_device)

    out_card = request()
    on_cuda('DFDNet', out_card, *card.parameters())
    selected_card = [int(i) for i in card.selected]
    ms = cuda_time_ms(request, iters=5)
    cpu_net = copy.deepcopy(card).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_cpu = cpu_net(x, boxes, dictionary)
    cpu_s = time.perf_counter() - t0
    selected_cpu = [int(i) for i in cpu_net.selected]
    err = (out_card.cpu() - out_cpu).abs().max().item()
    png = ((out_card[0].clamp(-1, 1) + 1) / 2).permute(1, 2, 0).cpu().numpy()[..., ::-1] * 255
    png_err = np.abs(written.astype(np.float32) - png.round()).max() if written is not None else -1
    print(f'a request: {ms:.3f} ms on the card (CUDA events, mean of 5), {cpu_s:.3f} s on the '
          f'CPU; face max|card - CPU| {err:.3e} (tolerance {DFDNET_TOLERANCE}); entries selected '
          f'(4 levels x 4 parts) card {selected_card}, CPU {selected_cpu}; the script\'s PNG '
          f'within {png_err:.0f} levels of the request; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    if written is None or png_err > 1:
        fail('inference_dfdnet did not write the request\'s face')
    if selected_card != selected_cpu or len(selected_card) != 16:
        fail('the card and the CPU selected different dictionary entries')
    if err > DFDNET_TOLERANCE or not torch.isfinite(out_card).all():
        fail('DFDNet on the card disagrees with the CPU')
    phase('53b. device time of one DFDNet request (torch.profiler, device activity)')
    busy, by_name, _ = trace_device_ms(request, 'dfdnet_request_trace.json')
    eig = sum(ms for name, (ms, _) in by_name.items() if 'syev' in name)
    print(f'{busy:.3f} ms of device time ({100 * busy / ms:.1f}% of the request by events), '
          f'{sum(n for _, n in by_name.values())} launches; the exact spectral norms\' '
          f'eigensolvers (syev*) {eig:.3f} ms; the longest: {longest_kernels(by_name, 4)}')
    del card, cpu_net


def faces_paths():
    """Phases 50 to 53: StyleGAN2 256 Cmul2, HiFaceGAN and DFDNet; no
    kernel on these paths."""
    t0 = time.perf_counter()
    write_face_inputs()
    model, opt = train_stylegan2()
    del model
    torch.cuda.empty_cache()
    stylegan2_card_vs_cpu(opt)
    sample_stylegan2(opt)
    t1 = time.perf_counter()
    train_and_serve_hifacegan()
    t2 = time.perf_counter()
    serve_dfdnet()
    print(f'phases 50 to 53: {time.perf_counter() - t0:.1f} s (50 {t1 - t0:.1f}, 51-52 '
          f'{t2 - t1:.1f}, 53 {time.perf_counter() - t2:.1f})')


TAMING_CONFIG = 'options/test/taming/test_taming_vqgan8192_synthetic.yml'
TAMING_ITEMS = 4
TAMING_CODE_SHARE = 0.99   # the least share of latent positions whose code card and CPU agree on
TAMING_TOLERANCE = 1e-4    # the encoder's latents and the decoder's output, of their largest
FID_WEIGHTS = 'results/chip_smoke/pt_inception-random.pth'
FID_IMAGES, FID_BATCH = 32, 16
FEATURE_TOLERANCE = 1e-4   # card against CPU, of the largest feature (float32, TF32 off)
# device metrics against the host's on the same 8-bit images: float32 on [0, 1]
# against float64 on [0, 255]. SSIM's E[x^2] - mu^2 cancels in float32: on
# random-weight outputs (SSIM near 0.14) it reads 1.2e-5 off on the CPU and
# 1.5e-5 on an NVIDIA H100 80GB HBM3 at 700 W
METRIC_TOLERANCE = {'psnr': 1e-3, 'ssim': 1e-4}
OPTIM_STEPS = 4
OPTIM_BATCH, OPTIM_GT = 4, 64
# the share of parameter entries whose change after OPTIM_STEPS card and CPU
# agree on to 1e-3 of the tensor's largest change: Adafactor's first update of
# an unfactored tensor is the gradient's sign, which float32 flips near 0
OPTIM_AGREEMENT = 0.999


class ItemLoader:
    """A validation loader of items made in memory (batch 1, in order), as
    ``build_dataloader`` gives a dataset's."""

    def __init__(self, name, items):
        self.dataset = types.SimpleNamespace(opt={'name': name})
        self.items = items

    def __iter__(self):
        return iter(self.items)


def build_test_model(config):
    """The model of a test option file, as ``test.py`` builds it (the
    options parsed, the result folders made)."""
    import argparse

    from basicsr4rs_torch.models import build_model
    from basicsr4rs_torch.utils import make_exp_dirs
    from basicsr4rs_torch.utils.options import parse_options
    args = argparse.Namespace(opt=config, force_yml=None, debug=False, auto_resume=False)
    opt, _ = parse_options(ROOT, is_train=False, args=args)
    opt['root_path'] = ROOT
    make_exp_dirs(opt)
    return build_model(opt)


def write_taming_weights(opt):
    """The seed-0 random VQGAN of the config at its widths, the codebook
    spread over [-1, 1] as in ``random_resshift_weights``, saved as a bare
    state_dict (``param_key_g: null``); returns it on the CPU."""
    from basicsr4rs_torch.archs.autoencoder_arch import VQModelTorch
    gen = torch.Generator().manual_seed(0)
    net = VQModelTorch(**net_options(opt), generator=gen)
    with torch.no_grad():
        net.quantize.embedding.weight.uniform_(-1., 1., generator=gen)
    path = opt['path']['pretrain_network_g']
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(net.state_dict(), path)
    return net.eval()


def taco_items(rng, n, gt_size, bands):
    """Items as ``TacoDataset`` gives them: smooth random reflectances in
    [0, 3000] of ``bands`` bands, over 3000 into [-1, 1]; the LQ the GT's
    x4 area downscale; batch 1."""
    import numpy as np
    items = []
    for i in range(n):
        refl = np.concatenate([smooth_image(rng, gt_size, gt_size)
                               for _ in range(-(-bands // 3))], axis=2)[..., :bands]
        gt = torch.from_numpy(refl.transpose(2, 0, 1).astype(np.float32) / 255. * 3000)[None]
        gt = gt / 3000 * 2 - 1
        name = [f'S2N_synthetic_{i:02d}.taco']
        items.append({'lq': torch.nn.functional.avg_pool2d(gt, SCALE), 'gt': gt,
                      'lq_path': name, 'gt_path': name})
    return items


def serve_taming():
    """Phase 54: TamingModel at the published widths on the card, its
    validation over items of the taco layout, request latency, device time
    and memory; one item against the same network on the CPU, stage by
    stage."""
    import numpy as np

    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(TAMING_CONFIG)
    dd, gt_size = opt['network_g']['ddconfig'], opt['datasets']['test_1']['gt_size']
    phase(f'54. TamingModel through its validation on cuda:0 ({opt["network_g"]["type"]} as '
          f'published: {dd["in_channels"]} bands, ch {dd["ch"]}, ch_mult {dd["ch_mult"]}, '
          f'{opt["network_g"]["n_embed"]} codes of {opt["network_g"]["embed_dim"]}; '
          f'{TAMING_ITEMS} items of the taco layout at GT {gt_size}; no TPU kernel on this path)')
    cpu_net = write_taming_weights(opt)
    items = taco_items(np.random.RandomState(54), TAMING_ITEMS, gt_size, dd['in_channels'])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_test_model(TAMING_CONFIG)
    name = opt['datasets']['test_1']['name']
    model.validation(ItemLoader(name, items), current_iter=model.opt['name'], tb_logger=None,
                     save_img=model.opt['val']['save_img'])
    torch.cuda.synchronize()
    print(f'model build and validation of {TAMING_ITEMS} items (metrics, CSV, band PNGs): '
          f'{time.perf_counter() - t0:.3f} s')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    for metric, value in model.metric_results.items():
        print(f'{metric}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{metric} is not finite')
    vis = model.opt['path']['visualization']
    with open(os.path.join(vis, f'{name}_{model.opt["name"]}.csv')) as f:
        rows = f.read().splitlines()
    saved = {sub: len(os.listdir(os.path.join(vis, sub, name))) for sub in ('RGB', 'NIR')}
    print(f'CSV rows {len(rows) - 1}, saved image folders {saved}')
    if len(rows) != TAMING_ITEMS + 1 or saved != {'RGB': TAMING_ITEMS, 'NIR': TAMING_ITEMS}:
        fail('the validation wrote the wrong rows or images')

    latencies = request_latencies(model, items, lambda item: item['gt'].shape)
    print(f'request latency (GT {gt_size}x{gt_size}x{dd["in_channels"]} through the '
          f'autoencoder): {" ".join(f"{ms:.3f}" for ms in latencies)} ms, mean '
          f'{sum(latencies) / len(latencies):.3f}; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB')
    busy, by_name, _ = trace_device_ms(model.test, 'taming_request_trace.json')
    print(f'device time of a request {busy:.3f} ms, {sum(n for _, n in by_name.values())} '
          f'launches; the longest: {longest_kernels(by_name, 3)}')

    net = model.net_g
    x = items[0]['gt']
    with torch.no_grad():
        h_card, h_cpu = net.encode(x.cuda()), cpu_net.encode(x)
        codes_card = net.quantize(h_card)[2].cpu()
        codes_cpu = cpu_net.quantize(h_cpu)[2]
        quant_card = net.quantize(h_card)[0]
        out_card = net.decode(quant_card, force_not_quantize=True)
        out_cpu = cpu_net.decode(quant_card.cpu(), force_not_quantize=True)
        whole = (net(x.cuda()).cpu() - cpu_net(x)).abs()
    share = (codes_card == codes_cpu).float().mean().item()
    h_err = ((h_card.cpu() - h_cpu).abs().max() / h_cpu.abs().max()).item()
    out_err = ((out_card.cpu() - out_cpu).abs().max() / out_cpu.abs().max()).item()
    print(f'card against the CPU, one item: encoder latents {h_err:.3e} of the largest; '
          f'{100 * share:.3f}% of the {codes_cpu.numel()} latent positions pick the same of '
          f'the {net.quantize.n_e} codes; the decoder on the card\'s codes {out_err:.3e} of '
          f'the largest output; end to end max |err| {whole.max().item():.3e}, '
          f'{100 * (whole > 1e-3).float().mean().item():.3f}% of the values past 1e-3')
    if h_err > TAMING_TOLERANCE or out_err > TAMING_TOLERANCE or share < TAMING_CODE_SHARE:
        fail('the autoencoder differs between the card and the CPU')
    del model


def random_inception_weights(path, seed=0):
    """pytorch-fid's keys, its classifier among them, with He-scaled
    convolutions and BatchNorms near the identity (block 3 stays of order
    one): a stand-in for pt_inception-2015-12-05, not in the repository."""
    import numpy as np

    from basicsr4rs_torch.archs.inception import InceptionV3
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in InceptionV3().state_dict().items():
        shape = tuple(value.shape)
        if key.endswith('num_batches_tracked'):
            sd[key] = value
            continue
        if key.endswith('conv.weight'):
            arr = rng.standard_normal(shape) * np.sqrt(2. / np.prod(shape[1:]))
        elif key.endswith(('bn.weight', 'running_var')):
            arr = rng.uniform(0.8, 1.2, shape)
        else:
            arr = rng.uniform(-0.1, 0.1, shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    sd['fc.weight'] = torch.from_numpy(rng.standard_normal((1008, 2048)).astype(np.float32))
    sd['fc.bias'] = torch.zeros(1008)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)


def fid_on_the_card():
    """Phase 55: the FID InceptionV3's features of two sets of images on
    the card and on the CPU, and the FID of the two sets from the card's."""
    import numpy as np

    from basicsr4rs_torch.metrics.fid import (calculate_fid, calculate_stats,
                                              extract_inception_features,
                                              load_patched_inception_v3)
    phase(f'55. FID: InceptionV3 (the FID variant; random weights in pytorch-fid\'s layout) '
          f'features of 2 sets of {FID_IMAGES} images at 299x299 on cuda:0 and on the CPU, '
          f'calculate_fid from the card\'s (no TPU kernel on this path)')
    random_inception_weights(FID_WEIGHTS)
    card, cpu = (load_patched_inception_v3(FID_WEIGHTS, device=d) for d in ('cuda', 'cpu'))
    rng = np.random.RandomState(55)
    sets = [np.stack([smooth_image(rng, 299, 299).transpose(2, 0, 1)
                      for _ in range(FID_IMAGES)]).astype(np.float32) / 127.5 - 1
            for _ in range(2)]

    def batches(images):
        return (images[i:i + FID_BATCH] for i in range(0, len(images), FID_BATCH))

    extract_inception_features(batches(sets[0][:FID_BATCH]), card)   # warm-up
    t0 = time.perf_counter()
    feats_card = [extract_inception_features(batches(s), card) for s in sets]
    card_s = time.perf_counter() - t0   # each batch's features are read back to the host
    t0 = time.perf_counter()
    feats_cpu = [extract_inception_features(batches(s), cpu) for s in sets]
    cpu_s = time.perf_counter() - t0
    n = 2 * FID_IMAGES
    err = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(feats_card, feats_cpu))
    print(f'features ({n} images in batches of {FID_BATCH}): the card {n / card_s:.1f} images/s '
          f'({1e3 * card_s:.1f} ms), the CPU {n / cpu_s:.1f} images/s; card against CPU '
          f'{err:.3e} of the largest feature (tolerance {FEATURE_TOLERANCE}); features '
          f'{feats_card[0].shape}, largest {np.abs(feats_cpu[0]).max():.3f}')
    if err > FEATURE_TOLERANCE or feats_card[0].shape != (FID_IMAGES, 2048):
        fail('the InceptionV3 features differ between the card and the CPU')
    # one FID, from the card's features: a second from the CPU's took another
    # 2048 x 2048 sqrtm (10 to 22 s on the host) for the script's time
    t0 = time.perf_counter()
    fid = calculate_fid(*calculate_stats(feats_card[0]), *calculate_stats(feats_card[1]))
    print(f'FID of the two sets from the card\'s features: {fid:.6f} '
          f'({time.perf_counter() - t0:.2f} s on the host, scipy sqrtm of 2048 x 2048)')
    if not np.isfinite(fid):
        fail(f'FID {fid}')


def device_metrics():
    """Phase 56: the device PSNR / SSIM through SwinIR-M's validation route,
    then item by item against the host metrics on the same images."""
    import numpy as np

    from basicsr4rs_torch.metrics import psnr_ssim
    from basicsr4rs_torch.utils.img_util import tensor2img
    from basicsr4rs_torch.utils.options import yaml_load
    from basicsr4rs_torch.utils.registry import METRIC_REGISTRY
    phase('56. device PSNR / SSIM (calculate_psnr_pt, calculate_ssim_pt) on SwinIR-M x4 '
          'validation outputs (LQ 128x128, 96x160, 125x94, 64x64) against the host metrics on '
          'the same images')
    if not os.path.exists(WEIGHTS):
        write_inputs()
    seen = []

    def spy(fn):
        return lambda **kw: seen.append((kw['img'].device, kw['img2'].device)) or fn(**kw)
    with mock.patch.dict(METRIC_REGISTRY._obj_map, {
            name: spy(getattr(psnr_ssim, name))
            for name in ('calculate_psnr_pt', 'calculate_ssim_pt')}):
        model = run_test_pipeline(CONFIG, [
            '--force_yml', 'name=test_SwinIR_M_x4_synthetic_device_metrics',
            'val:save_img=false', 'val:metrics:psnr:type=calculate_psnr_pt',
            'val:metrics:ssim:type=calculate_ssim_pt'])
    devices = {d.type for pair in seen for d in pair}
    results = ', '.join(f'{k} {v:.4f}' for k, v in model.metric_results.items())
    print(f'validation on the device route: {results} (random weights); {len(seen)} metric '
          f'calls on {devices}')
    if devices != {'cuda'} or len(seen) != 2 * len(LQ_SIZES):
        fail('the validation did not hand the device metrics the tensors on the card')

    opts = {k: {o: v for o, v in m.items() if o != 'type'}
            for k, m in yaml_load(CONFIG)['val']['metrics'].items()}
    host = {'psnr': psnr_ssim.calculate_psnr, 'ssim': psnr_ssim.calculate_ssim}
    dev = {'psnr': psnr_ssim.calculate_psnr_pt, 'ssim': psnr_ssim.calculate_ssim_pt}
    times = {'host': [], 'device': []}
    for item, (h, w) in zip(model_loader(model), LQ_SIZES):
        model.feed_data(item)
        model.test()
        out, gt = model.output, model.gt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_img, gt_img = tensor2img(out.detach().cpu()), tensor2img(gt.detach().cpu())
        on_host = {k: host[k](out_img, gt_img, **opts[k]) for k in host}
        times['host'].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        on_device = {k: dev[k](out, gt, **opts[k]) for k in dev}
        times['device'].append(time.perf_counter() - t0)
        as_u8 = [torch.from_numpy(np.ascontiguousarray(i.transpose(2, 0, 1))).cuda()
                 for i in (out_img, gt_img)]
        u8 = {k: dev[k](*as_u8, **opts[k]) for k in dev}
        plain = {k: dev[k](out.cpu(), gt.cpu(), **opts[k]) for k in dev}
        print(f'LQ {h}x{w}: host ' + ', '.join(f'{k} {v:.6f}' for k, v in on_host.items())
              + f' in {1e3 * times["host"][-1]:.1f} ms; device on the float output '
              + ', '.join(f'{k} {v:.6f}' for k, v in on_device.items())
              + f' in {1e3 * times["device"][-1]:.1f} ms; device on the 8-bit images '
              + ', '.join(f'{k} {u8[k] - on_host[k]:+.2e}' for k in u8) + ' from the host')
        for k in dev:
            if abs(u8[k] - on_host[k]) > METRIC_TOLERANCE[k]:
                fail(f'{k} on the card differs from the host metric on the same images')
            if abs(plain[k] - on_device[k]) > METRIC_TOLERANCE[k]:
                fail(f'{k} on the card differs from the same function on the CPU')
    print(f'a validation item\'s two metrics, items 2 to {len(LQ_SIZES)}: host route (8-bit '
          f'images, then numpy and cv2) {1e3 * np.mean(times["host"][1:]):.1f} ms, device '
          f'route {1e3 * np.mean(times["device"][1:]):.1f} ms')
    del model


def msrresnet_opt(init_path, optim_g, num_gpu, root, ema_decay=0.999):
    """SRModel training options of ``train_MSRResNet_x4_synthetic.yml``'s
    network, scheduler and loss, from ``init_path``, with ``optim_g``."""
    from basicsr4rs_torch.utils.options import yaml_load
    base = yaml_load(MS_TRAIN_CONFIG)
    return {'name': 'optim', 'model_type': 'SRModel', 'scale': SCALE, 'num_gpu': num_gpu,
            'manual_seed': 0, 'is_train': True, 'dist': False, 'rank': 0, 'world_size': 1,
            'network_g': dict(base['network_g']),
            'path': {'pretrain_network_g': init_path, 'strict_load_g': True,
                     'models': os.path.join(root, 'models'),
                     'training_states': os.path.join(root, 'states')},
            'train': dict(base['train'], ema_decay=ema_decay, optim_g=optim_g), 'val': {}}


def write_two_sets(path):
    """A ``.pth`` of MSRResNet x4 whose ``params`` and ``params_ema`` are two
    different seeded random sets; returns them."""
    from basicsr4rs_torch.archs.srresnet_arch import MSRResNet
    from basicsr4rs_torch.utils.options import yaml_load
    sets = []
    for seed in (57, 58):
        torch.manual_seed(seed)
        sets.append(MSRResNet(**net_options(yaml_load(MS_TRAIN_CONFIG))).state_dict())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'params': sets[0], 'params_ema': sets[1]}, path)
    return sets


def train_with_optimizers(init_path):
    """Phase 57: MSRResNet x4 trained a few steps with Adafactor and with
    Lamb on the card and on the CPU from the same weights and batches; and
    Adafactor's factored route on a 256 -> 256 convolution."""
    import numpy as np

    from basicsr4rs_torch.models import build_model
    from basicsr4rs_torch.models.optimizers import Adafactor, factored_dims
    phase(f'57. MSRResNet x4 (64 x 16) {OPTIM_STEPS} steps with Adafactor and with Lamb on '
          f'cuda:0 against the same steps on the CPU (batch {OPTIM_BATCH}, GT {OPTIM_GT}; no '
          'TPU kernel on this path)')
    rng = np.random.RandomState(57)
    batches = []
    for _ in range(OPTIM_STEPS):
        gt = np.stack([smooth_image(rng, OPTIM_GT, OPTIM_GT) for _ in range(OPTIM_BATCH)])
        gt = torch.from_numpy(gt.transpose(0, 3, 1, 2).astype(np.float32) / 255.)
        batches.append({'gt': gt, 'lq': torch.nn.functional.interpolate(
            gt, scale_factor=1 / SCALE, mode='bicubic', align_corners=False)})
    # Lamb at eps 1e-3: at 1e-8 its first update is the gradient's sign too
    for optim_g in ({'type': 'Adafactor', 'lr': 2e-4},
                    {'type': 'Lamb', 'lr': 2e-4, 'betas': [0.9, 0.99], 'eps': 1e-3,
                     'weight_decay': 1e-4}):
        runs = {}
        for where, num_gpu in (('card', 1), ('CPU', 0)):
            model = build_model(msrresnet_opt(init_path, optim_g, num_gpu,
                                              os.path.join(PROFILE_DIR, 'optim')))
            if type(model.optimizer_g).__name__ != optim_g['type']:
                fail(f'the model built {type(model.optimizer_g).__name__}')
            losses, ms = [], []
            for it, batch in enumerate(batches, start=1):
                model.update_learning_rate(it)
                model.feed_data(batch)
                start = time.perf_counter()
                model.optimize_parameters(it)
                losses.append(model.get_current_log()['l_pix'])   # reads the loss: a sync
                ms.append(1e3 * (time.perf_counter() - start))
            runs[where] = (losses, {k: v.detach().cpu() for k, v in
                                    model.net_g.state_dict().items()}, ms)
        init = torch.load(init_path, weights_only=True)['params']
        (loss_k, params_k, ms_k), (loss_c, params_c, _) = runs['card'], runs['CPU']
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_c))
        agree, total, worst, still = 0, 0, 0., []
        for key, want in params_c.items():
            change = (want - init[key]).abs().max().item()
            off = (params_k[key] - want).abs()
            agree += (off <= 1e-3 * change + 1e-7).sum().item()
            total += off.numel()
            worst = max(worst, off.max().item() / max(change, 1e-30))
            if change == 0:
                still.append(key)
        print(f'{optim_g["type"]}: losses on the card {" ".join(f"{v:.6f}" for v in loss_k)}, '
              f'{loss_err:.2e} relative from the CPU\'s; {100 * agree / total:.4f}% of the '
              f'{total} parameter entries within 1e-3 of their tensor\'s largest change '
              f'(worst {worst:.2e} of it); step {np.mean(ms_k[1:]):.2f} ms on the card')
        if loss_err > 1e-4 or agree < OPTIM_AGREEMENT * total or still:
            fail(f'{optim_g["type"]}: the card and the CPU trained apart, or {still} did not move')
    # the factored route (two dimensions of at least 128), three steps
    gen = torch.Generator().manual_seed(5)
    w = torch.randn(256, 256, 3, 3, generator=gen) * 0.02
    params = [w.clone().cuda().requires_grad_(), w.clone().requires_grad_()]
    opts = [Adafactor([p], 1e-2) for p in params]
    for _ in range(3):
        g = torch.randn(w.shape, generator=gen)
        for p, opt in zip(params, opts):
            p.grad = g.to(p.device)
            opt.step()
    change = (params[1] - w).abs().max().item()
    err = (params[0].detach().cpu() - params[1].detach()).abs().max().item()
    print(f'Adafactor on a 256 -> 256 3x3 convolution (factored over dims '
          f'{factored_dims(w.shape, 128)}), 3 steps: card against CPU {err:.2e}, '
          f'{err / change:.2e} of the change')
    if err > 1e-4 * change:
        fail('Adafactor\'s factored route differs between the card and the CPU')


def ema_start(init_path, sets):
    """Phase 58 (F8): a fine-tune start from a ``.pth`` whose ``params`` and
    ``params_ema`` differ starts the EMA at ``params``; a resumed one at
    ``params_ema``."""
    from basicsr4rs_torch.models import build_model
    phase('58. the EMA of a fine-tune start (F8): SRModel (MSRResNet x4) on cuda:0 from a '
          '.pth whose params and params_ema differ')
    optim_g = {'type': 'Adam', 'lr': 2e-4}
    root = os.path.join(PROFILE_DIR, 'ema_start')
    started = build_model(msrresnet_opt(init_path, optim_g, 1, root))
    resumed_opt = msrresnet_opt(init_path, optim_g, 1, root)
    resumed_opt['path']['resume_state'] = os.path.join(root, 'states', '1.state')
    resumed = build_model(resumed_opt)
    for model, want, other, what in ((started, sets[0], sets[1], 'fine-tune start'),
                                     (resumed, sets[1], sets[0], 'resumed run')):
        ema = model.net_g_ema.state_dict()
        equal = all(torch.equal(ema[k].cpu(), want[k]) for k in want)
        differs = any(not torch.equal(ema[k].cpu(), other[k]) for k in other)
        print(f'{what}: net_g_ema on {ema["conv_first.weight"].device} equals '
              f'{"params" if want is sets[0] else "params_ema"} of the file: {equal}')
        if not (equal and differs):
            fail(f'{what}: the EMA did not start where the JAX package starts it')


def taming_paths():
    """Phases 54 to 58: TamingModel, FID, the device metrics, Adafactor and
    Lamb, and the EMA's start; no kernel on these paths."""
    t0 = time.perf_counter()
    serve_taming()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fid_on_the_card()
    t2 = time.perf_counter()
    device_metrics()
    t3 = time.perf_counter()
    init_path = os.path.join(PROFILE_DIR, 'msrresnet_two_sets.pth')
    sets = write_two_sets(init_path)
    train_with_optimizers(init_path)
    t4 = time.perf_counter()
    ema_start(init_path, sets)
    print(f'phases 54 to 58: {time.perf_counter() - t0:.1f} s (54 {t1 - t0:.1f}, 55 '
          f'{t2 - t1:.1f}, 56 {t3 - t2:.1f}, 57 {t4 - t3:.1f}, 58 '
          f'{time.perf_counter() - t4:.1f})')


# ------------------------------------- SwinIR's options, the unfused routes, SR3
L_TEST_CONFIG = 'options/test/SwinIR/test_SwinIR_L_x4_realworld_synthetic.yml'
L_TRAIN_CONFIG = 'options/train/SwinIR/train_SwinIR_L_x4_realworld_synthetic.yml'
L_DATA_DIR = 'datasets/SwinIR_L_x4_realworld_synthetic'
L_TRAIN_DIR = 'datasets/SwinIR_L_x4_realworld_synthetic_train'
L_REQUESTS, L_LQ, L_TRAIN_IMAGES = 3, 64, 16
L_WIDTHS = (240, 8, 8, 480)   # SwinIR-L: 8 heads of 30, window 8, mlp 2
L_SERVE_SHAPE = (1, L_LQ, L_LQ)
# SR3 16 -> 128: the widths quoted for config/sr_sr3_16_128.json of the public
# SR3 code (Image-Super-Resolution-via-Iterative-Refinement); that file is not
# in this repository and these figures were not checked against it. The
# bicubic-enlarged 16x16 input beside the noisy 128x128 image, 6 channels in
SR3_UNET = dict(in_channel=6, out_channel=3, inner_channel=64, norm_groups=32,
                channel_mults=(1, 2, 4, 8, 8), attn_res=(16,), res_blocks=2, dropout=0.2,
                image_size=128)
SR3_BATCH = 4


def check_swinir_l_kernels():
    """Phase 66a: K2 to K5 at the shapes SwinIR-L real-world x4 gives them
    (C=240 in 8 heads of 30, window 8, hidden 480): the training batch (8 of
    64x64, shifted by 4) with DropPath's scales and as the branch alone (the
    output mode of the ``drop_rate`` route), and the served request (1 of
    64x64) with the residual; each against its plain version by phase 3b's
    rules, timed beside it with its bound. Returns, a kernel, the training
    shape's figures (the served one's for K2 and K4 under ``serve_``)."""
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    from basicsr4rs_torch.utils.options import yaml_load
    phase('66a. K2 to K5 at SwinIR-L\'s shapes (C=240, 8 heads of 30, window 8, hidden 480): '
          'training batch 8 x 64x64 and a served 64x64 request, float32, vs plain versions')
    gen = torch.Generator().manual_seed(66)
    c, heads, ws, hidden = L_WIDTHS
    b_train = yaml_load(L_TRAIN_CONFIG)['datasets']['train']['batch_size_per_gpu']
    cases = [((b_train, L_LQ, L_LQ), mode, True) for mode in ('scaled', 'branch')]
    cases.append((L_SERVE_SHAPE, 'residual', False))
    out = {}
    for (b, h, w), mode, train in cases:
        (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ln2w, ln2b, w1, b1, w2, b2,
         ws, heads, scale) = block_inputs(b, h, w, torch.float32, 4, gen, c, heads, ws, hidden)
        dz = torch.randn(x.shape, generator=gen).cuda()
        s = None
        if mode == 'scaled':   # DropPath's mask / keep: one sample dropped
            s = torch.full((b,), 1 / 0.9, device='cuda')
            s[1] = 0.
        tail = (mode == 'residual', s)
        runs = [('swin_attn_block_fwd', S.swin_attn_block_forward, S.reference_swin_attn_block,
                 (x, ln1w, ln1b, wqkv, bqkv, wproj, bproj, rel, mask, ws, heads, scale) + tail,
                 ('out',)),
                ('swin_attn_block_bwd', S.swin_attn_block_backward,
                 S.reference_swin_attn_block_backward,
                 (x, dz, ln1w, ln1b, wqkv, bqkv, wproj, rel, mask, ws, heads, scale) + tail,
                 ATTN_GRADS),
                ('mlp_block_fwd', M.mlp_block_forward, M.reference_mlp_block,
                 (x, ln2w, ln2b, w1, b1, w2, b2) + tail, ('out',)),
                ('mlp_block_bwd', M.mlp_block_backward, M.reference_mlp_block_backward,
                 (x, dz, ln2w, ln2b, w1, b1, w2) + tail, MLP_GRADS)]
        if not train:
            runs = runs[0:1] + runs[2:3]
        tag = f'B={b} {h}x{w} shift=4 {mode}'
        for name, kernel, plain, args, outputs in runs:
            with torch.no_grad():
                got = kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            worst, err = [], 0.
            for out_name, g, wnt in zip(outputs, got, want):
                rule = 'elementwise' if out_name in ('out', 'dx') else 'sum'
                ok, max_abs, max_rel, tolerance = compare(g, wnt, torch.float32, rule)
                worst.append(f'{out_name} {max_abs:.2e} ({max_rel:.1e})')
                err = max(err, max_abs)
                if not ok:
                    fail(f'{name}: {out_name} disagrees with the plain version at C=240, {tag}: '
                         f'max abs err {max_abs:.3e}, {max_rel:.3e} of max|plain|, '
                         f'tolerance {tolerance}')
            if mode == 'branch':
                print(f'{name:20s} {tag}: max abs err (of max|plain|): ' + ', '.join(worst),
                      flush=True)
                continue
            kernel_ms, plain_ms = time_pair(lambda: plain(*args), lambda: kernel(*args))
            flop, nbytes = kernel_work(name, b, h, w, torch.float32, True, L_WIDTHS)
            (bound, by), cuda_cores = tensor_core_bound_ms(flop, nbytes, torch.float32)
            print(f'{name:20s} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
                  f'{bound:.4f} ms by {by} ({ROUTE[torch.float32]}; CUDA cores '
                  f'{cuda_cores:.4f}) | max abs err (of max|plain|): ' + ', '.join(worst),
                  flush=True)
            key = 'swinir_l_' if train else 'swinir_l_serve_'
            out.setdefault(name, {'max_abs_err': 0.})
            out[name]['max_abs_err'] = max(out[name]['max_abs_err'], err)
            out[name].update({key + 'ms': kernel_ms, key + 'plain_ms': plain_ms,
                              key + 'bound_ms': bound})
    return out


def write_swinir_l_inputs():
    """SwinIR-L's synthetic pairs: L_REQUESTS to serve at LQ 64x64,
    L_TRAIN_IMAGES of GT 256x256 to train on and one to validate; and the
    seed-0 random weights the test config names. Returns the Swin blocks."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    rng = np.random.RandomState(66)
    size = SCALE * L_LQ
    for root, gt_dir, lq_dir, count in ((L_DATA_DIR, 'GT', 'LQ', L_REQUESTS),
                                        (L_TRAIN_DIR, 'GT', 'LQ', L_TRAIN_IMAGES),
                                        (L_TRAIN_DIR, 'val_GT', 'val_LQ', 1)):
        for sub in (gt_dir, lq_dir):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(count):
            gt = smooth_image(rng, size, size)
            lq = cv2.resize(gt, (L_LQ, L_LQ), interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(os.path.join(root, gt_dir, f'{i:04d}.png'), gt)
            cv2.imwrite(os.path.join(root, lq_dir, f'{i:04d}.png'), lq)
    opt = yaml_load(L_TEST_CONFIG)
    net = SwinIR(**net_options(opt), generator=torch.Generator().manual_seed(0))
    path = opt['path']['pretrain_network_g']
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'params': net.state_dict()}, path)
    return sum(opt['network_g']['depths'])


def serve_swinir_l(blocks):
    """Phase 66: SwinIR-L real-world x4 served through ``basicsr4rs_torch.
    test``: K2 and K4 once a block a forward (past K1's widths), none of K1;
    the outputs, one request against the plain forward, request time, a
    request's device time by kernel, peak memory. Returns the launches."""
    import numpy as np

    import basicsr4rs_torch.test as entry
    from basicsr4rs_torch.ops import mlp_block as M
    from basicsr4rs_torch.ops import swin_block as S
    phase(f'66. serve SwinIR-L real-world x4 through basicsr4rs_torch.test (C=240, 9 x 6 blocks, '
          f'8 heads of 30, nearest+conv, 3conv; {L_REQUESTS} requests of LQ {L_LQ}x{L_LQ})')
    counters = {'swin_block_joint_fwd': S.fused_swin_block_full,
                'swin_attn_block_fwd': S.swin_attn_block_forward,
                'mlp_block_fwd': M.mlp_block_forward}
    for wr in counters.values():
        wr.launches = 0
    torch.cuda.reset_peak_memory_stats()
    argv = sys.argv
    sys.argv = ['basicsr4rs_torch.test', '-opt', L_TEST_CONFIG]
    t0 = time.perf_counter()
    try:
        model = entry.test_pipeline(ROOT)
    finally:
        sys.argv = argv
    torch.cuda.synchronize()
    launches = {k: wr.launches for k, wr in counters.items()}
    print(f'pipeline wall time {time.perf_counter() - t0:.3f} s (model build, weight load, '
          f'{L_REQUESTS} requests, metrics, image writes); launches {launches}')
    if model.device.type != 'cuda':
        fail(f'the model ran on {model.device}')
    want = {'swin_block_joint_fwd': 0, 'swin_attn_block_fwd': blocks * L_REQUESTS,
            'mlp_block_fwd': blocks * L_REQUESTS}
    if launches != want:
        fail(f'launches {launches}, expected {want} ({blocks} of K2 and of K4 a request)')
    for name, value in model.metric_results.items():
        print(f'{name}: {value:.4f} (random weights)')
        if not np.isfinite(value):
            fail(f'{name} is not finite')
    loader = list(model_loader(model))
    size = SCALE * L_LQ
    latencies = request_latencies(model, loader, lambda item: (1, 3, size, size),
                                  (S.swin_attn_block_forward, blocks))
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f'request LQ {L_LQ}x{L_LQ} -> {size}x{size}: '
          + ', '.join(f'{ms:.3f}' for ms in latencies) + f' ms (mean {sum(latencies) / len(latencies):.3f}; CUDA events around test(), after a '
          f'warm-up request); peak device memory {peak:.1f} MiB')
    model.feed_data(loader[0])
    print('66b. device time of one request by kernel (torch.profiler):')
    profile_device_time(model.test, 1, 'request', {'K2 (window, head) units': 'swin_attn_fwd_head',
                                                   'K2 proj': 'swin_attn_fwd_proj',
                                                   'K4': 'mlp_block_fwd'},
                        'swinir_l_request_profile.json')
    model.test()
    with_kernels = model.output.float().clamp(0, 1)
    with mock.patch.object(S, 'swin_attn_block_forward', S.reference_swin_attn_block), \
            mock.patch.object(M, 'mlp_block_forward', M.reference_mlp_block):
        model.test()
    err = (with_kernels - model.output.float().clamp(0, 1)).abs().max().item()
    print(f'one request, kernels vs plain versions: max abs difference {err:.3e} on the [0, 1] '
          f'output (tolerance {MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('SwinIR-L: the served output disagrees with the plain forward')
    del model
    torch.cuda.empty_cache()
    return {'swin_attn_block_fwd': launches['swin_attn_block_fwd'],
            'mlp_block_fwd': launches['mlp_block_fwd']}


def train_swinir_l(blocks):
    """Phase 67: SwinIR-L real-world x4 trained through ``basicsr4rs_torch.
    train`` on its synthetic config: K2 to K5 once a block a step (the split
    pair with DropPath's scales; K1 never: C=240 is past its widths), finite
    losses, the loss on the first batch falling, a checkpoint, step time,
    peak memory and one step's device time by kernel. Returns the launches
    of the run (its validation's K2 and K4 among them)."""
    from basicsr4rs_torch.utils.options import yaml_load
    phase('67. train SwinIR-L real-world x4 through basicsr4rs_torch.train '
          f'({os.path.basename(L_TRAIN_CONFIG)})')
    opt = yaml_load(L_TRAIN_CONFIG)
    total_iter = opt['train']['total_iter']
    batch = opt['datasets']['train']['batch_size_per_gpu']
    wrappers = training_kernels()
    exp_dir = fresh_run(opt, wrappers)
    record = {'steps': []}
    t0 = time.perf_counter()
    model = run_train_pipeline([], record, config=L_TRAIN_CONFIG)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f'pipeline wall time {time.perf_counter() - t0:.3f} s for {len(record["steps"])} steps '
          f'of batch {batch} at GT {opt["datasets"]["train"]["gt_size"]}, one validation, '
          f'checkpoints; launches in the run {launches}')
    if model.device.type != 'cuda':
        fail(f'the model trained on {model.device}')
    check_steps(record['steps'], total_iter, 'l_pix', dict.fromkeys(SPLIT_KERNELS, blocks))
    if launches['swin_block_joint_fwd']:
        fail('SwinIR-L launched K1, whose widths stop at C=192')
    loss_after = fixed_batch_loss(model, record['fixed'])
    print(f'l_pix on the first batch, eval mode: {record["fixed_loss_before"]:.6f} before step 1, '
          f'{loss_after:.6f} after step {total_iter}')
    if not loss_after < record['fixed_loss_before']:
        fail('SwinIR-L: the loss on the fixed batch did not fall')
    ckpt = os.path.join(exp_dir, 'models', f'net_g_{total_iter}.pth')
    if sorted(torch.load(ckpt, map_location='cpu', weights_only=True)) != ['params', 'params_ema']:
        fail(f'{ckpt} does not hold params and params_ema')
    print(f'{ckpt}: params and params_ema; peak device memory of the run {peak:.1f} MiB')
    print('67c. device time of one training step by kernel (torch.profiler):')
    model.lq, model.gt = record['fixed']
    model.optimize_parameters(0)
    profile_device_time(lambda: model.optimize_parameters(0), 1, 'step',
                        ('swin_attn_fwd_head', 'swin_attn_fwd_proj', 'swin_attn_block_bwd',
                         'mlp_block_fwd', 'mlp_block_bwd', 'branch_ln_bwd'),
                        'swinir_l_step_profile.json')
    del model
    torch.cuda.empty_cache()
    return launches


def route_run(net, lq, gt, train):
    """One forward (and in training a backward of the L1 loss) of ``net``
    from a freshly seeded mask generator, after one such warm-up run:
    (output, loss, gradients, ms by CUDA events, the block kernels' launches
    of the second run)."""
    wrappers = training_kernels()

    def run():
        net.seed_drop_path(123, 'cuda')
        net.zero_grad(set_to_none=True)
        if not train:
            with torch.no_grad():
                return net(lq)
        out = net(lq)
        (out - gt).abs().mean().backward()
        return out

    run()
    before = {k: w.launches for k, w in wrappers.items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run().detach()
    end.record()
    torch.cuda.synchronize()
    grads = {k: p.grad.clone() for k, p in net.named_parameters()} if train else None
    return (out, (out - gt).abs().mean().item(), grads, start.elapsed_time(end),
            {k: w.launches - before[k] for k, w in wrappers.items()})


def set_fused_attn(net, fused):
    from basicsr4rs_torch.archs.swinir_arch import SwinTransformerBlock
    for m in net.modules():
        if isinstance(m, SwinTransformerBlock):
            m.fused_attn = fused


def swinir_dropout_routes():
    """Phase 68: the routes that SwinIR's options select, at SwinIR-M's width
    (embed 180, 6 x 6 blocks, 6 heads, window 8), seed-0 weights: (a) in
    eval, ``fused_attn: false`` against the kernel route (K1); (b) in
    training with every rate 0 (DropPath 0.1 from one seed), the unfused
    route against the kernel route (K2 to K5), forward and gradients; (c)
    with ``drop_rate: 0.1``, K2 with the unfused MLP against the unfused
    route from the same generator state (the same masks), forward and
    gradients. Returns the kernel routes' launches."""
    from basicsr4rs_torch.archs.swinir_arch import SwinIR
    from basicsr4rs_torch.utils.options import yaml_load
    phase('68. SwinIR-M\'s option routes: (a) eval fused_attn false vs K1, (b) training rates 0 '
          'unfused vs K2 to K5, (c) drop_rate 0.1: K2 + unfused MLP vs unfused, same masks')
    net_opt = net_options(yaml_load(TRAIN_CONFIG))
    blocks = sum(net_opt['depths'])
    gen = torch.Generator().manual_seed(0)
    net = SwinIR(**net_opt, generator=gen).cuda()
    lq = torch.rand(1, 3, 64, 64, generator=gen).cuda()
    gt = torch.rand(1, 3, 256, 256, generator=gen).cuda()
    launches = collections.Counter()
    results = {}
    net.eval()
    for fused in (True, False):
        set_fused_attn(net, fused)
        results[fused] = route_run(net, lq, gt, False)
    (out_k, _, _, ms_k, n_k), (out_u, _, _, ms_u, n_u) = results[True], results[False]
    err = (out_k - out_u).abs().max().item()
    print(f'(a) eval, B=1 64x64, after a warm-up forward each: kernel route {ms_k:.3f} ms, '
          f'launches {n_k}; fused_attn false '
          f'{ms_u:.3f} ms, launches {n_u}; max abs difference {err:.3e} (tolerance '
          f'{MODEL_TOLERANCE})')
    if n_k['swin_block_joint_fwd'] != blocks or any(n_u.values()) or not err <= MODEL_TOLERANCE:
        fail('(a) the unfused eval route disagrees with the kernel route or launched a kernel')
    launches.update(n_k)

    lq = torch.rand(2, 3, 48, 48, generator=gen).cuda()
    gt = torch.rand(2, 3, 192, 192, generator=gen).cuda()
    for label, rates, kernel_launches in (
            ('(b) training, every rate 0', {}, dict.fromkeys(SPLIT_KERNELS, blocks)),
            ('(c) training, drop_rate 0.1', {'drop_rate': 0.1},
             {'swin_attn_block_fwd': blocks, 'swin_attn_block_bwd': blocks})):
        trained = SwinIR(**net_opt, **rates).cuda().train()
        trained.load_state_dict(net.state_dict())
        runs = {}
        for fused in (True, False):
            set_fused_attn(trained, fused)
            runs[fused] = route_run(trained, lq, gt, True)
        (out_k, loss_k, grads_k, ms_k, n_k), (out_u, loss_u, grads_u, ms_u, n_u) = (
            runs[True], runs[False])
        err = (out_k - out_u).abs().max().item()
        want = {k: kernel_launches.get(k, 0) for k in n_k}
        print(f'{label}, B=2 48x48: kernel route {ms_k:.3f} ms (forward and backward), launches '
              f'{n_k}; unfused {ms_u:.3f} ms, launches {n_u}; output max abs difference '
              f'{err:.3e} (tolerance {MODEL_TOLERANCE})')
        if n_k != want or any(n_u.values()):
            fail(f'{label}: launches {n_k} and {n_u}, expected {want} and none')
        if not err <= MODEL_TOLERANCE:
            fail(f'{label}: the outputs disagree')
        compare_gradients(label, loss_k, grads_k, loss_u, grads_u, names=('kernels', 'unfused'))
        launches.update(n_k)
        del trained, runs
    del net
    torch.cuda.empty_cache()
    return dict(launches)


def serve_resshift_unfused():
    """Phase 69: ResShift x4 built from its test config with
    ``network_g:fused_attn=false`` (every SwinBlockGN on the unfused
    chain), one request sampled, then the same request with the blocks
    switched to the fused route (K6) on the same weights and noise: the
    latent, the image and the codes by phase 8's rule. Returns the K6
    launches of the fused request."""
    import argparse

    from basicsr4rs_torch.archs.unet_arch import SwinBlockGN
    from basicsr4rs_torch.data import build_dataloader, build_dataset
    from basicsr4rs_torch.models import build_model
    from basicsr4rs_torch.utils import make_exp_dirs
    from basicsr4rs_torch.utils.options import parse_options
    phase('69. ResShift x4 sampled with fused_attn false against the fused route (K6), same '
          'weights and noise (test_ResShift_x4_synthetic.yml)')
    opt, steps, per_forward = resshift_options(RS_CONFIG)
    if not os.path.exists(opt['path']['pretrain_network_g']):
        write_resshift_inputs(opt)
    args = argparse.Namespace(opt=RS_CONFIG, force_yml=['network_g:fused_attn=false'],
                              debug=False, auto_resume=False)
    opt, _ = parse_options(ROOT, is_train=False, args=args)
    opt['root_path'] = ROOT
    make_exp_dirs(opt)
    model = build_model(opt)
    blocks = [m for m in model.net_g.modules() if isinstance(m, SwinBlockGN)]
    if not blocks or any(b.fused_attn for b in blocks):
        fail('network_g:fused_attn=false did not reach the Swin blocks')
    dataset_opt = opt['datasets']['test_1']
    item = next(iter(build_dataloader(build_dataset(dataset_opt), dataset_opt)))
    forward = attention_wrappers()['window_attention_fwd']
    kept, results = {}, []
    decode = model.base_diffusion.decode_first_stage

    def keep_latent(z, *a, **k):
        kept['z'] = z.clone()
        return decode(z, *a, **k)

    with mock.patch.object(model.base_diffusion, 'decode_first_stage', keep_latent):
        for fused in (False, True):
            for b in blocks:
                b.fused_attn = fused
            forward.launches = 0
            model.generator.manual_seed(11)
            model.feed_data(item)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model.test()
            end.record()
            torch.cuda.synchronize()
            with torch.inference_mode():
                codes = model.first_stage.quantize(kept['z'])[2]
            results.append((kept['z'], model.output.clone(), codes, start.elapsed_time(end),
                            forward.launches))
    (z_u, img_u, codes_u, ms_u, n_u), (z_k, img_k, codes_k, ms_k, n_k) = results
    z_err = (z_k - z_u).abs().max().item()
    img_err = (img_k - img_u).abs().max().item()
    flipped = int((codes_k != codes_u).sum())
    print(f'unfused request {ms_u:.3f} ms, {n_u} K6 launches; fused {ms_k:.3f} ms, {n_k} K6 '
          f'launches ({per_forward} a UNet forward x {steps} steps); latent max abs difference '
          f'{z_err:.3e}, image {img_err:.3e} on [-1, 1] (tolerance {RS_SAMPLE_TOLERANCE}); '
          f'{flipped} of {codes_k.numel()} code indices differ')
    if n_u or n_k != per_forward * steps:
        fail(f'K6 launches {n_u} (unfused) and {n_k} (fused), expected 0 and {per_forward * steps}')
    if z_err > RS_SAMPLE_TOLERANCE or flipped > 4 or (flipped == 0 and
                                                      img_err > RS_SAMPLE_TOLERANCE):
        fail('the unfused and the fused ResShift requests differ')
    del model
    torch.cuda.empty_cache()
    return n_k


def sr3_full_width():
    """Phase 70: SR3UNet at the SR3 16 -> 128 settings, seed-0 weights, B=4
    of 128x128: one training step's forward and backward with its dropout
    (time, peak memory, finite loss and gradients); then, dropout off, the
    output and every gradient in float32 against the same network in
    float64 on the card."""
    from basicsr4rs_torch.archs.sr3_arch import SR3UNet
    phase(f'70. SR3UNet at full width (SR3 16 -> 128: {SR3_UNET}), B={SR3_BATCH} of 128x128, '
          'forward and backward')
    gen = torch.Generator().manual_seed(0)
    net = SR3UNet(**SR3_UNET, generator=gen).cuda()
    params = sum(p.numel() for p in net.parameters())
    size = SR3_UNET['image_size']
    x = torch.randn(SR3_BATCH, SR3_UNET['in_channel'], size, size, generator=gen).cuda()
    t = torch.rand(SR3_BATCH, generator=gen).cuda()
    noise = torch.randn(SR3_BATCH, SR3_UNET['out_channel'], size, size, generator=gen).cuda()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = (net(x, t) - noise).square().mean()
        loss.backward()
        opt.step()
        return loss

    net.train()
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step().item())
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f'{params / 1e6:.2f} M parameters; training step (dropout {SR3_UNET["dropout"]}, Adam): '
          + ', '.join(f'{ms:.3f}' for ms in times) + f' ms; losses {losses}; peak device memory '
          f'{peak:.1f} MiB')
    if not all(math.isfinite(v) for v in losses):
        fail('SR3UNet: a loss is not finite')
    print('70b. device time of one training step by kernel (torch.profiler):')
    profile_device_time(step, 1, 'step', {}, 'sr3_step_profile.json')

    def run(model, dtype):
        model.zero_grad(set_to_none=True)
        out = model(x.to(dtype), t.to(dtype))
        (out - noise.to(dtype)).square().mean().backward()
        return out.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}

    net.eval()   # no dropout: the two runs take the same function
    wide = SR3UNet(**SR3_UNET).cuda().double().eval()
    wide.load_state_dict(net.state_dict())
    out32, grads32 = run(net, torch.float32)
    out64, grads64 = run(wide, torch.float64)
    err = (out32.double() - out64).abs().max().item() / out64.abs().max().item()
    print(f'float32 against float64 on the card: output max abs difference {err:.3e} of '
          f'max|float64| (tolerance {MODEL_TOLERANCE})')
    if not err <= MODEL_TOLERANCE:
        fail('SR3UNet: the float32 output disagrees with float64')
    loss32 = (out32 - noise).square().mean().item()
    loss64 = (out64 - noise.double()).square().mean().item()
    compare_gradients('SR3UNet float32 vs float64', loss32,
                      {k: g.double() for k, g in grads32.items()}, loss64, grads64,
                      names=('float32', 'float64'))
    del net, wide, opt
    torch.cuda.empty_cache()


def options_paths(launches, kernels):
    """Phases 66 to 70: SwinIR-L real-world x4 served and trained, SwinIR's
    option routes, ResShift's unfused route and SR3; their launches are
    added to ``launches``, 66a's kernel figures to ``kernels``."""
    t0 = time.perf_counter()
    for name, figures in check_swinir_l_kernels().items():
        entry = kernels.setdefault(name, {'max_abs_err': 0.})
        entry['max_abs_err'] = max(entry['max_abs_err'], figures.pop('max_abs_err'))
        entry.update(figures)
    t1 = time.perf_counter()
    blocks = write_swinir_l_inputs()
    for name, count in serve_swinir_l(blocks).items():
        launches[name] += count
    t2 = time.perf_counter()
    for name, count in train_swinir_l(blocks).items():
        launches[name] += count
    check_model_gradients('67b', L_TRAIN_CONFIG, (2, 3, L_LQ, L_LQ))
    t3 = time.perf_counter()
    for name, count in swinir_dropout_routes().items():
        launches[name] += count
    t4 = time.perf_counter()
    launches['window_attention_fwd'] += serve_resshift_unfused()
    t5 = time.perf_counter()
    sr3_full_width()
    print(f'phases 66 to 70: {time.perf_counter() - t0:.1f} s (66a {t1 - t0:.1f}, 66 '
          f'{t2 - t1:.1f}, 67 {t3 - t2:.1f}, 68 {t4 - t3:.1f}, 69 {t5 - t4:.1f}, 70 '
          f'{time.perf_counter() - t5:.1f})')


# ------------------------------------------- data preparation and conversion (phase 71)
DATA_TRAIN = 'options/train/SwinIR/train_SwinIR_SRx4_scratch.yml'   # the published file
DATA_ITERS, DATA_LMDB_ITERS = 40, 3
DATA_CROP, DATA_STEP, DATA_THRESH = 480, 240, 0   # extract_subimages' published settings
DATA_VAL = ('0005_s011.png', '0005_s012.png')   # held out: 480x480, sides multiples of 12
BABOON = 'tests/data/baboon.png'


def start_script(script, *args):
    """``python -m basicsr4rs_torch.scripts.<script> args`` in its own
    process, as a user starts it."""
    proc = subprocess.Popen([sys.executable, '-m', f'basicsr4rs_torch.scripts.{script}',
                             *map(str, args)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    return proc


def finish_script(proc, expect_ok=True):
    """Wait for a script; fail unless it exited as expected. Returns its
    standard error."""
    out, err = proc.communicate(timeout=300)
    name = proc.args[2].rsplit('.', 1)[-1]
    if (proc.returncode == 0) != expect_ok:
        fail(f'{name} exited with {proc.returncode}: {err[-1500:]}')
    print(f'{name}: exit {proc.returncode}, collected {time.perf_counter() - proc.started:.1f} s '
          f'after its start; {out.strip().splitlines()[-1] if out.strip() else ""}')
    return err


def crops_along(size):
    """The starts of extract_subimages' crops along a side of ``size``."""
    starts = list(range(0, size - DATA_CROP + 1, DATA_STEP))
    return starts + ([size - DATA_CROP] if size - (starts[-1] + DATA_CROP) > DATA_THRESH else [])


def write_div2k_hr(folder):
    """A DIV2K-style HR folder from baboon.png (480x492): the image, its
    flips, its transpose and its 2x MATLAB bicubic enlargement. Returns
    {name: (h, w)}."""
    import cv2
    import numpy as np

    from basicsr4rs_torch.utils.matlab_functions import imresize_uint8
    img = cv2.imread(BABOON)
    images = [img, img[:, ::-1], img[::-1], img.transpose(1, 0, 2), imresize_uint8(img, 2)]
    os.makedirs(folder)
    shapes = {}
    for i, im in enumerate(images):
        name = f'{i + 1:04d}.png'
        cv2.imwrite(os.path.join(folder, name), np.ascontiguousarray(im))
        shapes[name] = im.shape[:2]
    return shapes


def write_official_edsr(net_opt, root):
    """A seed-0 EDSR-L x4 (drawn on the card) saved twice: as BasicSR's
    ``{'params': ...}`` and under EDSR-PyTorch's key names (with its two
    mean-shift convs). Returns the two paths."""
    from basicsr4rs_torch.archs.edsr_arch import EDSR
    torch.manual_seed(0)
    with torch.device('cuda'):
        state = {k: v.cpu() for k, v in EDSR(**net_opt).state_dict().items()}
    n = net_opt['num_block']
    official = {'sub_mean.weight': torch.eye(3).view(3, 3, 1, 1), 'sub_mean.bias': torch.zeros(3),
                'add_mean.weight': torch.eye(3).view(3, 3, 1, 1), 'add_mean.bias': torch.zeros(3)}
    for key, value in state.items():
        for basicsr, ori in (('conv_first.', 'head.0.'), ('conv_after_body.', f'body.{n}.'),
                             ('upsample.0.', 'tail.0.0.'), ('upsample.2.', 'tail.0.2.'),
                             ('conv_last.', 'tail.1.'), ('.conv1.', '.body.0.'),
                             ('.conv2.', '.body.2.')):
            key = key.replace(basicsr, ori)
        official[key] = value
    paths = os.path.join(root, 'EDSR_Lx4_basicsr.pth'), os.path.join(root, 'EDSR_x4.pt')
    torch.save({'params': state}, paths[0])
    torch.save(official, paths[1])
    return paths


def check_prepared(root, hr_shapes):
    """Phase 71b: the sub-image count by the crop rule, every LR 120x120 of
    a 480x480 GT, one sorted ``name (480,480,3)`` meta-info line each."""
    import cv2
    phase('71b. the prepared layout')
    gt_dir = os.path.join(root, 'DIV2K_train_HR_sub')
    names = sorted(os.listdir(gt_dir))
    want = sum(len(crops_along(h)) * len(crops_along(w)) for h, w in hr_shapes.values())
    if len(names) + len(DATA_VAL) != want or len(names) < 16:
        fail(f'{len(names)} training + {len(DATA_VAL)} held-out sub-images, the crop rule '
             f'gives {want}')
    lr = DATA_CROP // SCALE
    for folder, lq_folder, files in (('DIV2K_train_HR_sub', 'DIV2K_train_LR_bicubic_X4_sub', names),
                                     ('Set5_GTmod12', 'Set5_LRbicx4', DATA_VAL)):
        for name in files:
            gt = cv2.imread(os.path.join(root, folder, name))
            lq = cv2.imread(os.path.join(root, lq_folder, name))
            if gt.shape != (DATA_CROP, DATA_CROP, 3) or lq.shape != (lr, lr, 3):
                fail(f'{folder}/{name}: GT {gt.shape}, LR {lq.shape}')
    with open(os.path.join(root, 'meta_info_DIV2K800sub_GT.txt')) as f:
        meta = f.read()
    if meta != ''.join(f'{n} ({DATA_CROP},{DATA_CROP},3)\n' for n in names):
        fail(f'meta_info: {meta[:200]!r}')
    print(f'{len(names)} training sub-images of {DATA_CROP}x{DATA_CROP} from '
          f'{len(hr_shapes)} HR images (+ {len(DATA_VAL)} held out for validation, as the rule '
          f'gives {want}), every LR {lr}x{lr}, {len(names)} meta-info lines in order')
    return len(names)


def data_train_args(root, extra=()):
    """The one ``--force_yml`` of phase 71's runs of the published file: the
    data roots, the run's length and its logging; nothing else."""
    import importlib.util
    args = ['--force_yml',
            f'datasets:train:dataroot_gt={root}/DIV2K_train_HR_sub',
            f'datasets:train:dataroot_lq={root}/DIV2K_train_LR_bicubic_X4_sub',
            f'datasets:train:meta_info_file={root}/meta_info_DIV2K800sub_GT.txt',
            f'datasets:val:dataroot_gt={root}/Set5_GTmod12',
            f'datasets:val:dataroot_lq={root}/Set5_LRbicx4',
            f'train:total_iter={DATA_ITERS}', f'val:val_freq={10**6}', 'logger:print_freq=10',
            f'logger:save_checkpoint_freq={10**6}']
    if importlib.util.find_spec('tensorboard') is None:
        args.append('logger:use_tb_logger=false')
    return args + list(extra)


def train_prepared(root, wrappers, card):
    """Phase 71c: the published SwinIR-M x4 file trained on the prepared
    data: K2 to K5 36 each a step, K1 36 a validation image, a loss that
    falls, a finite PSNR; step times, busy share, peak memory beside the
    card (``card``: its name and power limit)."""
    import statistics

    import cv2
    from basicsr4rs_torch.models.swinir_model import SwinIRModel
    from basicsr4rs_torch.utils.options import yaml_load
    opt = yaml_load(DATA_TRAIN)
    blocks = sum(opt['network_g']['depths'])
    phase(f'71c. train {DATA_TRAIN} (SwinIR-M x4: embed {opt["network_g"]["embed_dim"]}, '
          f'{blocks} blocks; batch {opt["datasets"]["train"]["batch_size_per_gpu"]}, GT '
          f'{opt["datasets"]["train"]["gt_size"]}, '
          f'{opt["datasets"]["train"]["num_worker_per_gpu"]} loader workers) through '
          f'basicsr4rs_torch.train on the prepared data, {DATA_ITERS} steps')
    fresh_run(opt, wrappers)
    record = {'steps': []}
    ends = []
    model = run_train_pipeline(data_train_args(root), record, config=DATA_TRAIN,
                               model_cls=SwinIRModel, wrappers=wrappers,
                               before_first_step=keep_fed_batch,
                               after_step=lambda m, st: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = {k: w.launches for k, w in wrappers.items()}
    check_steps(record['steps'], DATA_ITERS, 'l_pix', dict.fromkeys(SPLIT_KERNELS, blocks))
    val_images = len(DATA_VAL)
    if launches['swin_block_joint_fwd'] != blocks * val_images:
        fail(f'{launches["swin_block_joint_fwd"]} K1 launches, expected {blocks} a validation '
             f'image x {val_images}')
    losses = [st['l_pix'] for st in record['steps']]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    psnr = model.metric_results['psnr']
    events = statistics.median(st['ms'] for st in record['steps'][2:])
    wall = statistics.median(b - a for a, b in zip(ends[2:], ends[3:])) * 1e3
    print(f'l_pix: mean of the first 5 steps {first:.5f}, of the last 5 {last:.5f}; validation '
          f'PSNR {psnr:.4f} dB on {val_images} held-out pairs (net_g_ema); median step '
          f'{events:.3f} ms by CUDA events, {wall:.3f} ms by the wall clock between step ends '
          f'(data included); peak device memory {peak:.1f} MiB')
    if not last < first:
        fail('the loss did not fall')
    if not math.isfinite(psnr):
        fail('the validation PSNR is not finite')

    phase('71c-b. a step and a validation image by kernel (torch.profiler)')
    counts = dict(launches)
    for key, value in record['batch'].items():
        setattr(model, key, value)
    model.optimize_parameters(0)
    ours = ('swin_attn_fwd_head', 'swin_attn_fwd_proj', 'swin_attn_block_bwd', 'mlp_block_fwd',
            'mlp_block_bwd', 'branch_ln_bwd')
    step = profile_device_time(lambda: model.optimize_parameters(0), 1, 'step', ours,
                               'data_train_step_profile.json')
    lq = cv2.imread(os.path.join(root, 'Set5_LRbicx4', DATA_VAL[0]))[:, :, ::-1] / 255.
    model.feed_data({'lq': torch.from_numpy(lq.copy()).permute(2, 0, 1)[None].float()})
    val = profile_device_time(model.test, 1, 'request', ('swin_block_joint_kernel',),
                              'data_val_profile.json')
    for k, wr in wrappers.items():   # the profiled runs belong to no main path's count
        wr.launches = counts[k]
    per_step = {'swin_attn_fwd_head': blocks, 'swin_attn_fwd_proj': blocks,
                'swin_attn_block_bwd': blocks, 'mlp_block_fwd': blocks, 'mlp_block_bwd': blocks}
    if step is None or val is None:
        fail('the profiler recorded no device time')
    got = {k: step.get(k, (0, 0))[1] for k in per_step}
    got_k1 = val.get('swin_block_joint_kernel', (0, 0))[1]
    print(f'the profiler counts a step {got}, a validation image K1 {got_k1} (the wrappers: '
          f'{blocks} each a step, {blocks} a validation image)')
    if got != per_step or got_k1 != blocks:
        fail('the profiler did not see every launch of the step or of the validation image')
    busy = sum(ms for ms, _ in step.values())
    print(f'phase 71c on {card}: median step {events:.3f} ms by CUDA events, {wall:.3f} ms by '
          f'the wall clock; device busy {busy:.3f} ms a step (profiled) = '
          f'{100 * busy / events:.1f}% of the median step; peak {peak:.1f} MiB; PSNR '
          f'{psnr:.4f} dB')
    del model
    torch.cuda.empty_cache()
    return launches


def lmdb_gate(root, gate, wrappers):
    """Phase 71d: without ``lmdb``, ``create_lmdb`` (``gate``, already
    started) and ``io_backend: lmdb`` at a dataset's first item raise its
    ImportError; with it, the prepared pairs go into two LMDBs and the
    published file trains from them."""
    import importlib.util

    from basicsr4rs_torch.data import build_dataset
    from basicsr4rs_torch.models.swinir_model import SwinIRModel
    from basicsr4rs_torch.utils.options import yaml_load
    phase('71d. the lmdb gate')
    have_lmdb = importlib.util.find_spec('lmdb') is not None
    err = finish_script(gate, expect_ok=have_lmdb)
    if not have_lmdb:
        if 'ImportError' not in err or 'lmdb' not in err:
            fail(f'create_lmdb failed otherwise: {err[-800:]}')
        folders = []
        for name in ('gate_gt.lmdb', 'gate_lq.lmdb'):
            os.makedirs(os.path.join(root, name))
            with open(os.path.join(root, name, 'meta_info.txt'), 'w') as f:
                f.write(f'{DATA_VAL[0][:-4]}.png (480,480,3) 1\n')
            folders.append(os.path.join(root, name))
        opt = dict(yaml_load(DATA_TRAIN)['datasets']['train'], phase='train', scale=SCALE,
                   dataroot_gt=folders[0], dataroot_lq=folders[1], io_backend={'type': 'lmdb'})
        dataset = build_dataset(opt)
        try:
            dataset[0]
        except ImportError as e:
            print(f'no lmdb here: create_lmdb raised ImportError ({err.strip().splitlines()[-1]}); '
                  f'PairedImageDataset in LMDB mode built and raised at its first item ({e})')
        else:
            fail('io_backend: lmdb read an item without lmdb')
        return {}
    for folder in ('DIV2K_train_HR_sub', 'DIV2K_train_LR_bicubic_X4_sub'):
        finish_script(start_script('data_preparation.create_lmdb', '--dataset', 'div2k',
                                   '--input', os.path.join(root, folder), '--output',
                                   os.path.join(root, folder + '.lmdb'), '--n-thread', 4))
    opt = yaml_load(DATA_TRAIN)
    fresh_run(opt, wrappers)
    record = {'steps': []}
    run_train_pipeline(data_train_args(root, [
        'datasets:train:io_backend:type=lmdb', f'train:total_iter={DATA_LMDB_ITERS}',
        f'datasets:train:dataroot_gt={root}/DIV2K_train_HR_sub.lmdb',
        f'datasets:train:dataroot_lq={root}/DIV2K_train_LR_bicubic_X4_sub.lmdb']), record,
        config=DATA_TRAIN, model_cls=SwinIRModel, wrappers=wrappers,
        before_first_step=lambda m, r: None)
    check_steps(record['steps'], DATA_LMDB_ITERS, 'l_pix',
                dict.fromkeys(SPLIT_KERNELS, sum(opt['network_g']['depths'])))
    return {k: w.launches for k, w in wrappers.items()}


def serve_converted(root, converted, basicsr_pth):
    """Phase 71e: EDSR-L x4 served through ``basicsr4rs_torch.test`` from the
    converted checkpoint with ``SWIN_FUSED_CONV=1`` (K10 on the upsampler's
    two convs), its output equal to the same network's loaded from the
    BasicSR-keyed file. Returns K10's launches."""
    from basicsr4rs_torch.ops.conv3x3 import fused_conv3x3
    phase('71e. EDSR-L x4 from an official-key checkpoint converted by convert_models, '
          'served with SWIN_FUSED_CONV=1')
    os.environ['SWIN_FUSED_CONV'] = '1'
    fused_conv3x3.launches = 0
    try:
        model = run_test_pipeline(EDSR_TEST, [
            '--force_yml', f'path:pretrain_network_g={converted}',
            f'datasets:test_1:dataroot_gt={root}/Set5_GTmod12',
            f'datasets:test_1:dataroot_lq={root}/Set5_LRbicx4'])
        torch.cuda.synchronize()
        launches = fused_conv3x3.launches
        if launches != 2 * len(DATA_VAL):
            fail(f'{launches} K10 launches for {len(DATA_VAL)} requests, expected 2 each')
        item = next(iter(model_loader(model)))
        model.feed_data(item)
        model.test()
        got = model.output.clone()
        model.load_network(model.net_g, basicsr_pth, True, 'params')
        model.test()
        want = model.output
    finally:
        os.environ.pop('SWIN_FUSED_CONV')
    fused_conv3x3.launches = launches   # the comparison's requests count for no path
    print(f'{launches} K10 launches on {len(DATA_VAL)} requests (LQ 120x120 -> 480x480); the '
          f'converted network against the BasicSR-keyed one: max abs difference '
          f'{(got - want).abs().max().item():.3e}, '
          f'{"bit for bit" if torch.equal(got, want) else "NOT equal"}')
    if not torch.equal(got, want) or not torch.isfinite(got).all():
        fail('the converted EDSR-L differs from the network it was made from')
    del model
    torch.cuda.empty_cache()
    return launches


def data_path(launches, card, second=None):
    """Phase 71: the user's path from raw images and an official checkpoint
    to a training run and a request, on the port's scripts alone: (a)
    prepare, (b) check the layout, (c) train the published file, (d) the
    lmdb gate, (e) convert and serve. Its launches are added to
    ``launches``; ``card`` is the card's name and power limit. ``second``,
    phase 62's job, runs beside 71a's scripts and is collected after them."""
    from basicsr4rs_torch.utils.options import yaml_load
    t0 = time.perf_counter()
    phase('71a. prepare DIV2K-style data with the port\'s scripts (python -m, no JAX): '
          f'extract_subimages (crop {DATA_CROP}, step {DATA_STEP}, thresh {DATA_THRESH}), '
          'generate_bicubic_lr --scale 4, generate_meta_info; convert_models --model edsr'
          + ('; phase 62\'s second process beside them' if second else ''))
    root = tempfile.mkdtemp(prefix='div2k_prepared_')
    try:
        if second:
            start_second_process(second)
        net_opt = net_options(yaml_load(EDSR_TEST))
        basicsr_pth, official = write_official_edsr(net_opt, root)
        converted = os.path.join(root, 'EDSR_Lx4_converted.pth')
        convert = start_script('model_conversion.convert_models', '--model', 'edsr', '--input',
                               official, '--output', converted, '--num_block',
                               net_opt['num_block'])
        hr = os.path.join(root, 'DIV2K_train_HR')
        hr_shapes = write_div2k_hr(hr)
        sub = os.path.join(root, 'sub')
        extract = start_script('data_preparation.extract_subimages', '--input', hr, '--output',
                               os.path.join(sub, 'DIV2K_train_HR_sub'), '--crop-size', DATA_CROP,
                               '--step', DATA_STEP, '--thresh-size', DATA_THRESH, '--n-thread',
                               len(hr_shapes))
        gate = start_script('data_preparation.create_lmdb', '--dataset', 'div2k', '--input', hr,
                            '--output', os.path.join(root, 'DIV2K_train_HR.lmdb'))
        finish_script(extract)
        os.makedirs(os.path.join(sub, 'Set5_GTmod12'))
        for name in DATA_VAL:
            os.rename(os.path.join(sub, 'DIV2K_train_HR_sub', name),
                      os.path.join(sub, 'Set5_GTmod12', name))
        bicubic = start_script('data_preparation.generate_bicubic_lr', '--input', sub, '--output',
                               os.path.join(root, 'lr'), '--scale', SCALE)
        meta = start_script('data_preparation.generate_meta_info', '--input',
                            os.path.join(sub, 'DIV2K_train_HR_sub'), '--output',
                            os.path.join(root, 'meta_info_DIV2K800sub_GT.txt'))
        for proc in (bicubic, meta, convert):
            finish_script(proc)
        for folder in ('DIV2K_train_HR_sub', 'Set5_GTmod12'):
            os.rename(os.path.join(sub, folder), os.path.join(root, folder))
        os.rename(os.path.join(root, 'lr', 'DIV2K_train_HR_sub'),
                  os.path.join(root, 'DIV2K_train_LR_bicubic_X4_sub'))
        os.rename(os.path.join(root, 'lr', 'Set5_GTmod12'), os.path.join(root, 'Set5_LRbicx4'))
        t62 = time.perf_counter()
        if second:
            for name, count in finish_second_process(second).items():
                launches[name] += count
        t1 = time.perf_counter()
        check_prepared(root, hr_shapes)
        wrappers = training_kernels()
        for name, count in train_prepared(root, wrappers, card).items():
            launches[name] += count
        t2 = time.perf_counter()
        for name, count in lmdb_gate(root, gate, wrappers).items():
            launches[name] += count
        t3 = time.perf_counter()
        launches['conv3x3_fwd'] += serve_converted(root, converted, basicsr_pth)
    finally:
        shutil.rmtree(root)
        if second:
            stop_second_process(second)
    print(f'phase 71: {time.perf_counter() - t0:.1f} s (71a {t62 - t0:.1f}, then phase 62 '
          f'{t1 - t62:.1f}, 71b and 71c '
          f'{t2 - t1:.1f}, 71d {t3 - t2:.1f}, 71e {time.perf_counter() - t3:.1f})')


SUMMARY_KEYS = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
KERNELS = [
    ('swin_block_joint_fwd', 'basicsr4rs_tpu/ops/swin_block.py:287'),
    ('swin_attn_block_fwd', 'basicsr4rs_tpu/ops/swin_block.py:244'),
    ('swin_attn_block_bwd', 'basicsr4rs_tpu/ops/swin_block.py:405'),
    ('mlp_block_fwd', 'basicsr4rs_tpu/ops/mlp_block.py:74'),
    ('mlp_block_bwd', 'basicsr4rs_tpu/ops/mlp_block.py:97'),
    ('window_attention_fwd', 'basicsr4rs_tpu/ops/window_attention.py:120'),
    ('window_attention_bwd', 'basicsr4rs_tpu/ops/window_attention.py:227'),
    ('deform_sample_fwd', 'basicsr4rs_tpu/ops/dcn.py:174'),
    ('deform_sample_bwd', 'basicsr4rs_tpu/ops/dcn.py:224'),
    ('conv3x3_fwd', 'basicsr4rs_tpu/ops/conv3x3.py:47'),
    ('swin_block_joint_int8_fwd', 'basicsr4rs_tpu/ops/swin_block.py:354'),
]


def serving_modes(launches, split_step_ms):
    """Phases 17 to 22 and 59 to 61: the serving modes of the image-SR path,
    the joint training route, the widths past the joint kernel's and
    ahead-of-time serving; their launches are added to ``launches``.
    ``split_step_ms``: phase 6's step time, or None when it did not run.
    Returns phase 62's job (``second_process_job``)."""
    model, loader, conv_launches, k1_fused = serve_fused_conv()
    launches['conv3x3_fwd'] = conv_launches
    launches['swin_block_joint_int8_fwd'] = serve_int8(model, loader)
    del model
    serve_and_train_msrresnet()
    launches['swin_block_joint_fwd'] += k1_fused + serve_tiled()
    for name, count in train_joint(split_step_ms).items():
        launches[name] += count
    for name, count in serve_wide_swinir().items():
        launches[name] += count
    served, second = serve_ahead_of_time()
    for name, count in served.items():
        launches[name] += count
    return second


def main():
    if not torch.cuda.is_available():
        fail('no CUDA device')
    from basicsr4rs_torch.utils.options import yaml_load
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ['rank']:   # one rank of phase 63, 64 or 65, started by torchrun
        dist_rank(sys.argv[2])
        return
    card = card_info()
    rs_batch = resshift_options(RS_TRAIN_CONFIG)[0]['datasets']['train']['batch_size_per_gpu']
    l2s_batch = resshift_options(L2S_CONFIG)[0]['datasets']['train']['batch_size_per_gpu']
    align_batch = yaml_load(ALIGN_JOINT_TRAIN)['datasets']['train']['batch_size_per_gpu']
    build_kernels()
    if sys.argv[1:] == ['cnn']:   # development: the classic CNN and GAN paths alone
        print(json.dumps(check_conv_kernel_cnn()))
        launches = collections.Counter()
        cnn_gan_paths(launches)
        print(json.dumps(launches))
        return
    if sys.argv[1:] == ['video']:   # development: the recurrent video slice alone
        print(json.dumps(check_deform_kernels('3h', recurrent_deform_cases())))
        launches = collections.Counter()
        recurrent_video_paths(launches)
        print(json.dumps(launches))
        return
    if sys.argv[1:] == ['dist']:   # development: phases 63 to 65 (and phase 6's step)
        launches = collections.Counter()
        write_train_inputs()
        dist_paths(launches, train()[1], card)
        print(json.dumps(launches))
        print(card)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ['options']:   # development: phases 66 to 70 alone
        launches, kernels = collections.Counter(), {}
        options_paths(launches, kernels)
        print(json.dumps(launches))
        print(json.dumps(kernels))
        print(card)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ['spatial']:   # development: phase 72 alone
        run = start_spatial()
        try:
            print(json.dumps(finish_spatial(run, card)))
        finally:
            stop_torchrun(run)
        print(card)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ['data']:   # development: phase 71 alone
        launches = collections.Counter()
        data_path(launches, card)
        print(json.dumps(launches))
        print(card)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return
    slices = {'realesrgan': realesrgan_paths, 'faces': faces_paths, 'taming': taming_paths}
    if len(sys.argv) == 2 and sys.argv[1] in slices:   # a slice without kernels alone
        slices[sys.argv[1]]()
        print(card)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': torch.cuda.get_device_name(0),
                                                 'count': torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ['serving']:   # development: the serving modes' kernels and paths alone
        print(json.dumps({'swin_block_joint_fwd': check_joint_kernel(), **check_conv_kernels(),
                          **check_int8_block_kernel()}))
        profile_requests(*serve()[:2])
        write_train_inputs()
        second = serving_modes(collections.Counter(), None)
        try:
            start_second_process(second)
            finish_second_process(second)
        finally:
            stop_second_process(second)
        return
    kernels = {'swin_block_joint_fwd': check_joint_kernel()}
    kernels.update(check_branch_kernels())
    kernels.update(check_attention_kernels(rs_batch, l2s_batch, align_batch))
    kernels.update(check_deform_kernels())
    for name, checked in check_deform_kernels('3h', recurrent_deform_cases()).items():
        kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'], checked['max_abs_err'])
    kernels.update(check_conv_kernels())
    kernels.update(check_int8_block_kernel())
    if sys.argv[1:] == ['kernels']:   # development: the kernel phases alone
        print(json.dumps(kernels))
        return
    # each phase below sets its kernels' counts to 0 just before it drives its
    # path and reads them just after
    model, loader, serve_launches = serve()
    profile_requests(model, loader)
    check_whole_model(model, loader)
    del model
    train_launches, split_step_ms, _ = train()
    check_model_gradients()
    # SwinIR's paths: the serving run plus the training run (its validations
    # go through the joint kernel), then the same training data-parallel
    launches = dict(train_launches)
    launches['swin_block_joint_fwd'] += serve_launches
    # phase 72's ranks start with phases 63 to 65 (their set-up overlaps
    # them) and train once those have left the card
    spatial_go = os.path.join(DIST_DIR, 'spatial.go')
    if os.path.exists(spatial_go):
        os.remove(spatial_go)
    spatial = start_spatial(after=spatial_go)
    try:
        dist_paths(launches, split_step_ms, card)
        open(spatial_go, 'w').close()
        for name, count in finish_spatial(spatial, card).items():
            launches[name] = launches.get(name, 0) + count
    finally:
        stop_torchrun(spatial)
    served = serve_resshift()
    trained = train_resshift()
    check_resshift_gradients()
    l2s = check_l2s_unet()
    # added to phase 65's launches of K6 to K9
    launches['window_attention_fwd'] = launches.get('window_attention_fwd', 0) + served + trained[
        'window_attention_fwd'] + l2s['window_attention_fwd']
    launches['window_attention_bwd'] = launches.get('window_attention_bwd', 0) + trained[
        'window_attention_bwd'] + l2s['window_attention_bwd']
    for name in ('deform_sample_fwd', 'deform_sample_bwd'):
        launches.setdefault(name, 0)
    for i, name in enumerate(VIDEO):
        served, _ = serve_video(name, 11 + 3 * i)
        trained, _, _ = train_video(name, 12 + 3 * i)
        check_video_gradients(name, 13 + 3 * i)
        launches['deform_sample_fwd'] += served + trained['deform_sample_fwd']
        launches['deform_sample_bwd'] += trained['deform_sample_bwd']
    second = serving_modes(launches, split_step_ms)
    l2s_paths(launches)
    align_paths(launches)
    cnn_gan_paths(launches)
    recurrent_video_paths(launches)
    realesrgan_paths()
    faces_paths()
    taming_paths()
    options_paths(launches, kernels)
    data_path(launches, card, second)
    for name, count in launches.items():
        if count == 0:
            fail(f'{name} was never launched on the main paths')
    print(f'total {time.perf_counter() - T0:.1f} s')
    print(card)
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda', 'source': f'basicsr4rs_torch/csrc/{name}.cu',
        'replaces': replaces, 'launches': launches[name],
        'max_abs_err': kernels[name]['max_abs_err'], 'ms': kernels[name]['ms'],
        'plain_ms': kernels[name]['plain_ms'], 'bound_ms': kernels[name]['bound_ms'],
        'bound_by': kernels[name]['bound_by'], 'library_ms': kernels[name].get('library_ms'),
        **{k: v for k, v in kernels[name].items() if k not in SUMMARY_KEYS}}
        for name, replaces in KERNELS]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
