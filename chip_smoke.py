#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``medicalseg_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It imports nothing of JAX or ``medicalseg_tpu``. Phases, each printing one
JSON line; any failure raises and the script exits non-zero:

1. device: require CUDA, print ``nvidia-smi``'s name and power limit, set
   the port's f32 policy (``utils.strict_f32``: TF32 off) for the f32
   references.
2. build: compile ``medicalseg_torch/csrc/*.cu`` (one ``nvcc`` each, in
   parallel) and report the seconds.
3. kernels: at every 5^3 conv shape of the 128^3 batch-2 V-Net forward,
   hold each kernel (head, bf16 stem, fused epilogue; the f32 stem's
   ``stem_tf32_kernel``) against its plain PyTorch
   version in bf16 (atol = rtol = 2e-2, one bf16 ulp at the outputs'
   magnitude) and f32 (atol = rtol = 1e-4, TF32 off: summation order
   only), and the pin kernel against ``contiguous()`` on the permuted
   views the forward pins (exact). Times (CUDA events, one warm-up,
   median of 5) of each kernel, its plain version and ``F.conv3d`` /
   ``contiguous()`` as the library yardstick, beside each kernel's bound.
   Per bf16 head conv also: ``kernel_ms`` (the launch with the packed
   weights kept, as the model calls it; the same number as ``ms_fused``),
   ``pack_ms`` (packing the weights alone), ``cold_ms`` (packing and
   launch, a weight seen for the first time), the launch geometry (tile,
   channel tile, ring stages, K splits), ``vs_library`` (the kernel's ms
   over the library's) and, where K is split, whether two launches agree
   bit for bit (fatal if not). For the bf16 stem (``stem_tc_kernel``) the
   device time without and with the epilogue (``device_ms``,
   ``device_ms_fused``: ten calls replayed from one CUDA graph), the
   host-timed and device times of ``conv5_kernel`` forced in the same
   process (``ms_old``, ``device_ms_old``, each also ``_fused``: the
   kernel it replaced), a fatal bit-for-bit repeat check and its
   geometry. Per pin view the path that ran (16-byte
   words or element-wise) and, beside the host-timed ``ms``, the device
   time of the kernel and of ``contiguous()`` with the host's dispatch
   taken out (ten calls replayed from one CUDA graph): at the small views
   a host-timed call measures the wrapper's Python, not the copy.
   Per conv also the f32 columns (``f32_*``): the routed kernel (the head
   convs' split-TF32 ``conv5_tf32_kernel``, the stem's split-TF32
   ``stem_tf32_kernel``) unfused and fused, ``conv5_kernel`` forced in the
   same process (``ms_old``), the plain version timed once, ``F.conv3d``
   in strict f32 (TF32 off: the library column) and with TF32 on
   (``library_tf32_ms``, a side column: cuDNN's default, a less exact
   function), the bound in split TF32 (three TF32 products a term at 495
   TF/s, or the bytes at 4 bytes an element), a fatal bit-for-bit repeat
   and the geometry; for the stem also the device times of both kernels
   unfused and fused (``f32_device_ms``, ``f32_device_ms_old``, each also
   ``_fused``: ten calls replayed from one CUDA graph). Then the f32 stem
   at ``F32_STEMS`` (the upstream spine recipes' [3, 512, 1, 512, 12], the
   cube's H block behind a 2-row halo, a ragged view 4 bytes into its
   allocation) with the same columns, held to its plain version at 1e-4.
   At every f32 stem shape ``conv5_kernel`` forced, unfused and fused, is
   held to the plain version too (``err_float32_old_*``, fatal): it stays
   for stems wider than 16 channels and every forced comparison.
4. serve: four seeded 128^3 volumes through
   ``medicalseg_torch.deploy.infer.Predictor`` (the lung ``_tpu`` config's
   model section, a seeded init with non-trivial BN statistics, bf16,
   batch 2: two requests after one warm-up batch). The launch counters are
   zeroed just before and read just after; every kernel must have run, 16
   convs and 8 pins per forward. The kernel path's logits are then held
   against the plain-version path's on the same batch (argmax agreement
   >= 99.5% of voxels), and the saved predictions against the logits.
5. kernels_ingest: the HU window + D-resize kernel (``hu_resize``) against
   its plain version, f32, atol 1e-3 on the window's 0..255 scale, at
   200 x 512 x 512 -> 128 and at 37 x 45 x 51 -> 16 (odd H * W, NaN and
   both infinities in the data, a ``hu_nan`` inside the window), and the
   whole ``hu_norm_resize`` against ``resize3d(hu_norm(x))``. Times as in
   phase 3, the bound by bytes (x read once, the output written once),
   ``torch.mm(W, window(x))`` as the library yardstick.
6. serve_raw: two seeded synthetic CT scans of 200 x 512 x 512 (uniform
   in [-2000, 1000], a few NaN) written as ``.nii`` by the port's own
   writer, and a small ``.nii.gz`` and ``.mha`` for the other readers,
   through ``Predictor.run`` (bf16, batch 2): ``hu_resize`` must launch
   once per volume, the convs and pins as in phase 4; the saved
   predictions are 128^3 int32 and equal the argmax of the plain-version
   path's logits (plain HU resize, plain convs) on >= 99.5% of voxels.
   Prints the preprocess time split into read+cast, upload, kernel and
   H/W passes (one big scan, each stage timed on its own), and ms per
   batch.
7. serve_swl: one of the big scans at native resolution through
   ``--use_swl`` (window 128^3, overlap 0.25: 2 x 5 x 5 = 50 windows, two
   per forward): launch counts of 25 forwards, finite blended logits, the
   saved prediction equal to their argmax, and a 128^3 sub-volume (one
   flush window) equal to a direct forward; seconds and peak memory. Then
   one 96^3 request through a 128^3 shape bucket (equal to the direct
   forward of the padded volume, cropped), and one ``--precision int8``
   request (the weights on the card are int8; argmax agreement with bf16
   serving >= ``INT8_AGREE``).
8. kernels_bwd: at the same conv shapes, the backward kernels against
   their plain versions: the input gradient (the forward kernel on the
   flipped, io-transposed weight; not for the stem, whose input is the
   image) with the forward's tolerances, and the weight gradient in its
   three forms (the stem's tensor-core kernel of
   ``csrc/conv5_stem_wgrad.cu``, also at the flagship's stem shape, batch
   3 x 12 x 512 x 512; narrow head and square / wide: the two tensor-copy
   kernels of ``csrc/conv5_wgrad_tma.cu``; each with a fatal bit-for-bit
   repeat check and its geometry; at the stem and the narrow head also the
   time of the kernel each replaced, ``wgrad_kernel`` and
   ``wgrad_mma_kernel<1>``, forced in the same process as
   ``wgrad_old_ms``, and at the stem both device times from graph
   replays, ``wgrad_device_ms`` and ``wgrad_device_ms_old``). dW sums
   one product per voxel, up to 9.4 M of them, so its tolerance is
   relative to the tensor's magnitude: |d| <= tol * (max |dW| + |dW|),
   tol = 2e-2 in bf16 (dW is rounded to bf16, as the JAX package's is)
   and 1e-4 in f32.
   Times as in phase 3 (the plain weight gradient once), with
   ``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` as the library
   yardstick, and for the input gradient the same packing, geometry,
   ratio and repeat columns as the forward's. The f32 columns as in phase
   3 (``wgrad_f32_*``, ``dgrad_f32_*``): ``wgrad_tf32_kernel`` (the stem's
   ``stem_wgrad_tf32_kernel``, with both device times and its geometry)
   beside ``wgrad_kernel`` forced, the input gradient's
   ``conv5_tf32_kernel`` beside ``conv5_kernel`` forced; the stem's weight
   gradient also at ``F32_STEMS``, scaled error within 1e-4, the same
   columns; at every f32 stem shape ``wgrad_kernel`` forced is held to the
   plain version as well (``wgrad_rel_err_float32_old``, fatal). Then the
   bf16 weight gradients on views a tensor copy cannot describe (``ragged``: the tensor-copy kernels fed
   by their software producer, 'ragged' / 'head_ragged', at the 12^3 and
   6^3 levels of a 96^3 V-Net and at narrow heads of W = 12) against their
   plain versions, with time, plain, ``conv3d_weight``, bound, a fatal
   repeat, ``wgrad_mma_kernel`` forced (``wgrad_old_ms``, the kernel they
   replaced), the pad route (``wgrad_pad_ms``: x and g copied into buffers
   whose W is a multiple of 8, then the tensor copy's kernel; the kernel
   alone ``wgrad_pad_kernel_ms``) and a fatal check that the route gives
   the pad route's bits. Then (``spine``) the nine head convs of the spine
   recipe (``SPINE_CONVS``: batch 3, W = 9, 8, 4, 2, 12; 32 -> 20 at
   out_tr) at full size, forward, input gradient and weight gradient: the
   routed kernel against its plain version, its time, the plain version's
   (once), ``F.conv3d`` / ``conv3d_input`` / ``conv3d_weight``, the bound,
   the geometry, and at the ragged weight gradients the side columns
   above; their sum over a step is the ``conv5_wgrad_ragged`` entry of the
   kernels line. The same nine convs in f32 (``spine_f32``): the
   split-TF32 kernels' forward, input gradient and weight gradient, each
   held to its plain version at 1e-4 (dW scaled), their times (median of
   3), the plain versions' (once), strict-f32 ``F.conv3d`` /
   ``conv3d_input`` / ``conv3d_weight`` (TF32 on as a side column), the
   three-TF32-pass bound and the geometry, and the eval forward with its
   BN affine + PReLU fused (``f32_fused_*``: held at 1e-4, timed); then
   one ``spine_f32_step`` line, each pass summed over the convs of a
   spine step.
9. train: the lung ``_tpu`` config's model (bf16, per-block remat),
   optimizer, schedule and loss built by ``Config``, seeded init, batch 2
   at 128^3, seeded volumes and labels in {0, 1, 2}, through
   ``core.state.make_train_step``: two warm-up steps and three timed
   steps on the same batch, the dropout generator re-seeded before each
   step so that the losses are comparable. Fatal checks: finite losses;
   after step 1 every parameter has a finite, non-zero gradient; the
   launch counts of the three timed steps are what the model implies (per
   step, with remat recomputing each block once: 2 x 16 forward convs, 15
   dgrads, 16 wgrads as 1 stem (on its tensor-core kernel) + 1 narrow head
   + 14 square / wide, both of the latter on the tensor-copy kernels, 2 x
   8 forward pins and
   none in the backward); step 1's loss and per-parameter gradients agree
   with the plain-version path from the same state and masks (loss within
   1e-2 relative, each leaf's gradient within a relative L2 error of
   0.35: bf16 activations rounded at other places by the two paths,
   through 31 layers; the same comparison in f32 at 64^3 holds every leaf
   to 2e-2 and the loss to 1e-5); the loss falls. Prints ms per step (the
   median of the three), patches/s, peak memory with and without remat,
   and the profiler's device time by kernel and idle share of one step.
9b. train_f32: the upstream f32 lung recipe
   (``configs/lung_coronavirus/vnet_lung_coronavirus_128_128_128_15k.yml``:
   VNet, 3 classes, float32, no remat, all widths) built by ``Config``,
   seeded init, at 2 x 128^3 (the YAML's batch is 6) on the train phase's
   seeded batch, through ``make_train_step``. Step 1 against the plain
   path from the same state and masks (loss within 1e-5 relative, every
   leaf within ``GRAD_REL_L2_F32``); then one untimed and three timed
   steps with the counts set to 0 just before them: exactly 15 head
   forwards, 15 input gradients and 15 weight gradients a step on the
   split-TF32 kernels, the stem's forward and weight gradient on
   ``stem_tf32_kernel`` / ``stem_wgrad_tf32_kernel``, 8 pins, nothing
   else; the loss falls. Prints the median host ms of the three steps, a
   profiled step's device ms and idle share, the peak memory, then the
   same with the stem's CUDA-core kernels forced (``old_stems``) and with
   every CUDA-core kernel forced (``old``) in the same process (their
   counts exact too). A profiled window must hold every hand-kernel launch
   the wrappers counted over it (taken again, up to three windows; else
   its device figures are None and its counts are printed beside the
   wrappers'); the stems' own device ms in it (``stems_device_ms``) give
   ``old_stems_minus_new_device_ms``.
9c. train_spine: the repo's bf16 spine recipe
   (``configs/mri_spine_seg/vnet_mri_spine_seg_512_512_12_15k_tpu.yml``:
   VNet, 20 classes, bf16, remat, VALID down convs, so W runs 12 -> 9 -> 8
   -> 4 -> 2) built by ``Config`` at its batch of 3 on a seeded [3, 512,
   512, 12, 1] batch with labels in [0, 20), the step only. Step 1 against
   the plain path from the same state and masks (loss within 1e-2, every
   leaf within 0.35 relative L2); then one untimed and three timed steps
   with the counts set to 0 just before them: exactly 30 head forwards and
   2 stem forwards (remat), 15 input gradients, the stem's weight gradient
   on ``stem_wgrad_tc_kernel``, 4 on the tensor copy (W = 8) and 11 on its
   software producer (``conv5_wgrad_ragged``), at least 16 pins a step;
   the loss falls. Prints the median host ms of the three, a profiled
   step's device ms, idle share and device time by category and kernel
   (``medicalseg_torch.tools.trace_ops`` on the step's Chrome trace), the
   peak memory; then the same with ``wgrad_mma_kernel`` forced in the
   same process (its counts exact too).
9d. train_spine_f32: the upstream f32 spine recipe
   (``configs/mri_spine_seg/vnet_mri_spine_seg_512_512_12_15k.yml``: the
   same VNet, float32, no remat) built by ``Config`` at its batch of 3 on
   a seeded [3, 512, 512, 12, 1] batch with labels in [0, 20), the step
   only. Step 1 against the plain path from the same state and masks
   (loss within 1e-5 relative, every leaf within ``GRAD_REL_L2_F32``);
   then one untimed and three timed steps with the counts set to 0 just
   before them: exactly 15 head forwards, 15 input gradients and 15
   weight gradients a step on the split-TF32 head kernels (W = 12, 9, 8,
   4, 2), the stem's forward and weight gradient on the split-TF32 stem
   kernels, at least 8 pins a step; the loss falls. Prints the median
   host ms of the three, a profiled step's device ms, idle share and
   device time by ``trace_ops`` category (the window whole, as in 9b), the
   peak memory; then the same with the stem's CUDA-core kernels forced in
   the same process (its counts exact too).
9e. train_deepsup_spine_f32 (after 9d, in the same process): the
   upstream f32 VNetDeepSup spine recipe
   (``configs/mri_spine_seg/vnetdeepsup_mri_spine_seg_512_512_12_15k.yml``:
   VNetDeepSup, 20 classes, float32, no remat, four MixedLoss heads, SGD
   at LR 0.1 under a poly schedule; W runs 12 -> 9 -> 8 -> 4 -> 2 and the
   heads sit at W = 4, 8, 9) built by ``Config`` at its batch of 3 on 9d's
   seeded batch. Step 1 against the plain path from the same state and
   masks (loss within 1e-5 relative, every leaf within
   ``GRAD_REL_L2_F32``, ``Conv_0..2`` finite and non-zero); then one
   untimed and three timed steps, each restarted from step 1's start
   state (the recipe's LR of 0.1 diverges in a few steps, in the JAX
   package too), the counts set to 0 just before the timed ones: exactly
   9d's counts (the heads' 3^3 convs and upsamples add no hand kernel),
   at least 8 pins a step; the three losses finite and equal (within
   ``REPEAT_LOSS_REL``; whether bit for bit is printed). Prints the
   median host ms, one profiled step's device ms, idle share and
   ``trace_ops`` categories (a window holding every counted launch), the
   peak memory, and 9d's f32 VNet step beside it with the differences;
   then the f32 policy's cost: three steps under PyTorch's TF32 defaults
   (cuDNN TF32 on), their median ms and the first one's loss and
   gradients against the policy's. Eval: the recipe's model, seeded with
   non-trivial BN statistics, on a seeded [1, 512, 512, 12, 1] volume
   through ``core.infer.inference`` of its ``main_output``: exactly one
   f32 eval forward's counts (the split-TF32 kernels with their
   epilogues, 8 pins), no ``ConvHead`` run (a forward hook, fatal), the
   logits equal to the four-output forward's first entry bit for bit
   with cuDNN's deterministic algorithms (its default f32 ones for the
   up/down convs need not repeat: two calls' difference printed), the
   logits within ``EVAL_F32_TOL`` (atol and rtol) of the plain path's and
   argmax agreement with it >= 99.5%; ms of the main output under
   PyTorch's TF32 defaults and its difference from the policy's; ms and
   peak of the main-output call and of the four-output call. CLI: four seeded [512,
   512, 12] volumes in MRISpineSeg's phase0 layout under ``build/``; from
   PyTorch's TF32 defaults (cuDNN on, matmul off) the train CLI on a copy
   of the YAML pointed at them (``--iters 3 --save_interval 3 --log_iters
   1 --do_eval``, the loader's default mode), then from the defaults again
   the val CLI on ``iter_3``: both TF32 flags off after each, every logged
   loss finite, the counts exact for three steps and eight eval forwards
   (graph replays counted as in train_graph), no head run in eval mode.
10. train_flagship: the flagship config
   (``configs/synthetic/vnetdeepsup_synspine_15k.yml``: VNetDeepSup,
   bf16, per-block remat, 20 classes, four MixedLoss heads, SGD with
   momentum, poly LR) built by ``Config``, seeded init, at the YAML's
   batch of 3 on seeded 12 x 512 x 512 volumes and labels in [0, 20)
   made on the card. First one step at batch 1 through the kernels and
   through the plain versions from the same state and masks (loss within
   1e-2 relative, each leaf's gradient within 0.35 relative L2, every
   leaf, the three heads ``Conv_0..2`` among them, finite and non-zero);
   then two warm-up steps and three timed ones at batch 3, the counts set
   to 0 just before the timed ones: every conv count what the model
   implies (the stem's weight gradient on ``stem_wgrad_tc_kernel``,
   out_tr's 32 -> 20 on ``wgrad_tma_kernel``), at least 8 pins a forward.
   Prints ms per step (median of three), patches/s, peak memory, the
   launches of one step and one profiled step's device time by kernel and
   by operator and idle share; then the same step with the recipe's device
   augmentation at its head (``DeviceAugmentor``: RandomRotation3D(30) +
   RandomFlip3D of the raw volumes): one warm-up and three timed steps
   with the counts set to 0 just before them and held to the same counts
   (``aug_ms_per_step``, its peak memory, one profiled step's device time
   and idle share); then the four heads' losses alone, forward
   and backward on seeded f32 logits of the step's shape, in their default
   (fused) form (``losses_ms``, their device time and its operators).
   Run before it, augment: ``DeviceAugmentor`` on a batch of each recipe
   (the flagship's on seeded 3 x 12 x 512 x 512 volumes and labels in
   [0, 20), the lung's RandomResizedCrop3D(128) + RandomRotation3D(90) +
   RandomFlip3D on 2 x 128^3, and a label-bounded crop, ``pre_crop`` with
   ``nonzero_mask``, on 2 x 96^3): one sample on the card against the
   port's CPU path at the same parameters (image within 1e-5; labels equal
   except at .5 ties of the CPU value before rounding), the batch under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), ms per
   batch (CUDA events, median of 5, the host's draws included).
11. train_graph: the cube (lung ``_tpu`` config, batch 2 at 128^3) and
   the flagship (spine config, batch 3 at 12 x 512 x 512), each with its
   recipe's device augmentation, over four seeded raw volumes held on the
   card in the bf16 / uint8 wire dtypes (as ``TrainLoader.
   build_device_cache`` holds them) and one seeded stream of index
   vectors: six (cube) or four (flagship) steps through the eager
   ``make_train_step`` (the loop's rule: the generator re-seeded from
   (seed, step), the batch gathered from the cache; its first step under
   ``set_sync_debug_mode("error")``), then the same steps through
   ``make_cached_train_step`` from the same start (its first call the
   eager warm-up and the capture of one CUDA graph, then replays). The
   counts are set to 0 before each run; a replay does not tick them, so
   the kernels the graphed run launched are the counts, less the
   capture's, plus the replays times the graph's launches a replay, which
   must equal the eager step's launches. Fatal checks: each step's loss,
   every parameter and BatchNorm statistic after the run, and the eval
   logits of a probe volume after every step (an evaluation between
   steps, as ``--do_eval`` makes one, which reads the conv kernels'
   packed-weight cache) equal the eager run's (``GRAPH_LOSS_REL``,
   ``GRAPH_PARAM_REL``: every kernel of the step is deterministic); the
   probe's logits change across replays; the dropout masks change at
   every replay, equal the eager step's at each (seed, step), and a replay
   re-seeded as the last step was draws its mask again. Then the same
   steps two a dispatch (``make_cached_train_step(losses, 2)``, [2, B]
   index rows) from the same start: the eager run's losses and parameters
   again. Prints, eager
   against graphed: ms per step on the host clock (median after the
   first), device ms and idle share of one profiled step, the replay's
   device time alone (CUDA events), peak memory, the launches a replay,
   beside the card's name and power limit.
12. train_cli: the port's train CLI (``medicalseg_torch.train.main``) on a
   copy of the flagship YAML pointed at four seeded 12 x 512 x 512 volumes
   written under ``build/``: six iterations (``--save_interval 3
   --log_iters 3 --loader_mode device``), then a run resumed from
   ``iter_3`` to 6. The counts are set to 0 before the first run and read
   after the second: every flagship kernel, exactly as nine steps imply.
   Both checkpoints load (steps 3 and 6, finite), every logged loss is
   finite, and the loader logs that it reads through the native reader.
   Prints each log window's loss, batch cost (ms per iteration) and
   reader cost, and one profiled iteration of the loop (batch from
   the prefetcher, draws, step): device time and idle share. Then the
   same with the dataset held on the card, three steps a dispatch and a
   trace (``--loader_mode device_cache --steps_per_dispatch 3
   --profiler_options "batch_range=[2,4];..."``) and its resume from
   ``iter_3``: the launches as nine steps imply (counted as in
   train_graph), five and two replays, finite losses, loadable
   checkpoints, the trace file written. The CLI's checkpoints are written
   asynchronously (the loop's default); ``core.train`` with
   ``async_checkpoint=False`` on the same seed and data writes
   ``iter_3`` and ``iter_6`` with the same bytes, and the phase prints the
   host ms each save call holds the loop both ways beside the ms per
   iteration of the three iterations after the save. The CLI's ``Model
   forward cost`` line equals the port's count (``utils/flops.py``) for
   the flagship at batch 3. ``python -m medicalseg_torch.tools.trace_ops``
   reads the trace (three iterations, one a replay): its hand-kernel
   launches a step equal the graph's launches a replay, and its busy ms a
   step the profiler's own device time of the window (``key_averages``)
   within 5%; its table goes to stderr.
13. eval: the cube config (VNet, bf16) pointed at three seeded 128^3
   volumes (labels in [0, 3)) with a dataset.json under ``build/``, seeded
   weights saved as ``model.msgpack``, through the val CLI
   (``medicalseg_torch.val.main``) in this process: whole volumes, with
   ``--sw_num 2`` (27 windows of 64^3 a volume, four to a forward) and
   with ``--auc_roc true --weights_precision int8``. The counts are set
   to 0 just before each run and read just after: exactly the eval
   forwards the mode implies (the fused-epilogue convs and the pins).
   Each run's predictions against the same evaluation with the kernels
   forced to their plain versions (argmax agreement >= 99.5% of voxels,
   mDice within 1e-2), and its dump of the volumes (``.npy`` and
   readable ``.nii.gz`` with the dataset.json spacing). Then the train
   CLI on the same data with ``--do_eval`` (four iterations, an eval at 2
   and 4): ``best_model/best.json`` exists, the best model loads, and a
   run resumed from ``iter_2`` restores the tracker. Prints ms per
   evaluated volume (host clock), the device time of one evaluated volume
   (a profiled whole-volume evaluation), the mDice of each mode and the
   AUC.
14. export (run right after serve): the served lung model's weights
   through the export CLI (``medicalseg_torch.export.main``) on the card
   at [2, 1, 128, 128, 128] with a 128^3 bucket, bf16 as the YAML says:
   ``model.pt2``, ``model_128x128x128.pt2``, ``model.msgpack`` and the
   manifest. The four volumes of serve through the exported manifest,
   plain (a warm-up and two requests) and bucketed (two requests), each
   run through its ``.pt2`` program. The counts are set to 0 just before
   each run and read just after: exactly the eval forwards the run
   implies, so the programs launch the hand kernels (the ``torch.library``
   ops) and no 5^3 conv runs elsewhere; one weight packing per conv (the
   packed-weight cache hits on the program's parameters after the first
   forward); argmax agreement with serve's predictions (the rebuilt
   module) >= 99.5%. Then a program exported with ``--without_argmax``
   against the rebuilt module's logits on one batch (its launches those
   of one forward): the max abs difference, and whether it is 0. Prints
   the export seconds and ms per batch of both paths.
15. prep (after serve_swl): the lung recipe of the port's prep tools
   (``medicalseg_torch.tools.prepare_lung_coronavirus``: HUnorm, then
   resample to 128^3, labels with order 0) on three seeded int16 scans of
   200 x 512 x 512 and their labels in {0, 1, 2}, written as ``.nii``:
   first with the device backend on the card, then with the host backend
   (numpy / scipy). Fatal: the same files and list files, images within
   ``PREP_TOL`` of the host's, labels equal. Prints seconds a scan of
   each backend.
16. native (run right after build): the native volume reader
   (``medicalseg_torch.data_native`` over ``csrc/medloader.cpp``, built
   with ``g++``): the gzip backend that built and ``g++ --version``'s
   first line. On four seeded 12 x 512 x 512 spine volumes (train_cli's
   data) the loader in ``device`` mode (batch 3, bf16 / uint8 wire,
   pinned, the CLI's one reader thread) against the numpy read the loader
   made before (``np.load``, ``np.stack``, cast, pinned): six batches of
   the seeded sequence bit for bit and pinned; the ms of one batch both
   ways with the volumes held in memory, and read from the files (new
   readers; ``np.load``); ``build_device_cache`` against the same numpy
   staging, seconds each, bit for bit. A seeded int16 ``.nii.gz`` scan of
   ``GZ_SCAN`` inflated by ``gzip_read_bytes`` against the gzip module
   (byte for byte, ms each) and read by ``io.nifti.read`` (equal to the
   volume written), then ``load_nii_hu_resize`` to 128^3 on the host
   against the card path (read, upload, the ``hu_resize`` kernel and the
   H/W passes) within ``NATIVE_HU_TOL`` on the window's 0..255 scale, ms
   each.

17. parallel (last): the data x space process mesh
   (``medicalseg_torch.parallel``). One process first takes one eager
   step of the cube (``LUNG_TPU``, bf16, remat, 2 x 128^3) and of the
   flagship (``SPINE``, 6 x 12 x 512 x 512: its batch of 3 a data index)
   at the global batch, then evaluates the stepped weights on the same
   batch. Then four ranks (``chip_smoke.py --parallel-rank``; data 2 x
   space 2, NCCL where the machine has a card a rank, else gloo with all
   four on the one card) each take the same step on their rows and H
   block: the loss within ``LOSS_REL``, every leaf's gradient within
   ``GRAD_REL_L2`` and the BatchNorm statistics within ``PAR_STAT_TOL``
   (scaled) of the one process's; the eval forward through the fused op
   on the one process's stepped weights, its logits gathered over the
   space ranks, argmax agreement >= ``PAR_AGREE``. The counts are set to
   0 before each rank's step and read after it: every rank launches the
   same kernels as often, every conv5 kernel of the path among them. The
   operand shapes of every kernel launch are recorded (the halo'd H/2 + 4
   rows among them), and the ranks share them out: each shape's kernel on
   seeded operands against its plain version (bf16 ``TOL``; the weight
   gradient scaled as kernels_bwd; the pin exact). Then ``torchrun`` with
   two ranks: the train CLI at ``--space 2`` on the cube config and three
   seeded 128^3 volumes (three iterations, ``--do_eval``), and the val CLI
   over the two ranks against the val CLI in this process (mDice within
   ``PAR_MDICE_TOL``, the log's four decimals). Any rank's failure fails
   the run. Prints the backend, the card count, each rank's device, the
   errors, each rank's step ms (host clock: four processes share one card
   over gloo, a check of correctness, not of scaling) and the torchrun
   seconds. The same step and eval forward of the cube config at H = 80
   (``cube_h80``: 2 x 128 x 80 x 128; its deepest level's five rows
   replicated over space 2) against one process at the same bounds, with
   its own shape check: conv launches at the halo'd blocks (44, 24, 14, 9
   rows) and the whole replicated 5 rows, each held to its plain version.
   Each rank's host-mode loader (crop, rotation and flip drawn on the host
   by two threads) against its rows of the one-process loader's batches,
   bit for bit; and ``torchrun`` trains two iterations at ``--space 2
   --loader_mode host --num_workers 2``. Where every rank has a card
   (NCCL) the cube and the flagship also run as the cached step, eager
   and as replays of one CUDA graph a rank (``graphed``: each of four
   steps bit for bit on every rank, host ms a step both ways, a profiled
   step's device ms, NCCL kernel ms and idle share both ways, launches a
   replay), then the same four steps as the cached step with [n, B]
   index rows (a dispatch of three and a remainder of one) and as the
   multi-step form (super-batches of two), each bit for bit the eager
   steps; over gloo the line says ``"graphed": "not run: gloo, one
   card"``.

Then one ``{"kernels": [...]}`` line (times summed over the convs of one
forward or backward; ``launches`` of the forward kernels from the serve
phase, of ``hu_resize`` from serve_raw, of the backward kernels from the
train phase, of the f32 kernels from train_f32 (each also launched on
train_spine_f32's path), of ``conv5_wgrad_ragged`` from train_spine, its
times summed over the spine step's eleven ragged weight gradients) and,
last, the ``{"ok": ...}`` line.
"""

import contextlib
import copy
import gzip
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from medicalseg_torch.core.state import (TrainState,  # noqa: E402
                                         make_cached_train_step,
                                         make_multi_step, make_train_step)
from medicalseg_torch.cvlibs.config import Config, build_model  # noqa: E402
from medicalseg_torch import io as medio  # noqa: E402
from medicalseg_torch.core.sliding_window import (  # noqa: E402
    gaussian_importance, sliding_window_inference)
from medicalseg_torch.deploy import infer  # noqa: E402
from medicalseg_torch.ops import _build  # noqa: E402
from medicalseg_torch.ops import conv5 as c5  # noqa: E402
from medicalseg_torch.ops import hu_resize as hr  # noqa: E402
from medicalseg_torch.ops import intensity, resize  # noqa: E402
from medicalseg_torch.utils.loss_utils import loss_computation  # noqa: E402
from medicalseg_torch import train as train_cli  # noqa: E402
from medicalseg_torch import val as val_cli  # noqa: E402
from medicalseg_torch.core import val as core_val  # noqa: E402
from medicalseg_torch.cvlibs import manager  # noqa: E402
from medicalseg_torch.transforms import (DeviceAugmentor,  # noqa: E402
                                         RandomResizedCrop3D, RandomFlip3D)
from medicalseg_torch.utils import checkpoint as ckpt  # noqa: E402
from medicalseg_torch.utils import train_profiler  # noqa: E402
from medicalseg_torch.utils.flops import forward_flops  # noqa: E402
from medicalseg_torch.utils.utils import strict_f32  # noqa: E402
from medicalseg_torch.tools import trace_ops  # noqa: E402
from medicalseg_torch.tools.conv5_times import padded  # noqa: E402
from medicalseg_torch.models.layers import ChannelDropout  # noqa: E402
from medicalseg_torch.transforms.device import step_seed  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
# H100 SXM dense TF32 tensor-core FLOP/s. An f32 conv at f32 accuracy on the
# tensor cores takes three TF32 products a term (hi*hi + hi*lo + lo*hi of
# each operand split into two TF32 halves: "split TF32"), so its bound by
# operations is 3 * FLOP / PEAK_TF32; one TF32 product alone keeps about 11
# bits, which the f32 tolerance (1e-4) does not allow.
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LUNG_TPU = os.path.join(ROOT, "configs", "lung_coronavirus",
                        "vnet_lung_coronavirus_128_128_128_15k_tpu.yml")
# the upstream f32 lung recipe: no dtype, no remat (train_f32)
LUNG_F32 = os.path.join(ROOT, "configs", "lung_coronavirus",
                        "vnet_lung_coronavirus_128_128_128_15k.yml")
SPINE = os.path.join(ROOT, "configs", "synthetic",
                     "vnetdeepsup_synspine_15k.yml")
# the repo's bf16 spine recipe (VNet, 20 classes, remat, batch 3): its down
# convs are VALID over W, so W runs 12 -> 9 -> 8 -> 4 -> 2 (train_spine)
SPINE_TPU = os.path.join(ROOT, "configs", "mri_spine_seg",
                         "vnet_mri_spine_seg_512_512_12_15k_tpu.yml")
SPINE_VOLUME = (512, 512, 12)  # D, H, W of its volumes as the model sees them
# the upstream f32 spine recipe: the same VNet with no dtype and no remat
# (train_spine_f32)
SPINE_F32 = os.path.join(ROOT, "configs", "mri_spine_seg",
                         "vnet_mri_spine_seg_512_512_12_15k.yml")
# the upstream f32 VNetDeepSup spine recipe: VNetDeepSup, 20 classes, four
# MixedLoss heads, no dtype, no remat (train_deepsup_spine_f32)
SPINE_DS_F32 = os.path.join(ROOT, "configs", "mri_spine_seg",
                            "vnetdeepsup_mri_spine_seg_512_512_12_15k.yml")
SPINE_CLI_VOLUMES = 4  # the volumes a spine CLI run writes
# the deep-sup eval's logits on the routed kernels against the plain path's,
# atol and rtol, f32 after 16 convs (4.7e-5 at most on an H100, logits up
# to 10): a kernel wrong at one level is off by the logits' own scale
EVAL_F32_TOL = 1e-3
# its timed steps, each from step 1's start, against each other: cuDNN's
# default f32 algorithms for the up/down convs need not repeat bit for bit
# (two eval forwards differed by 3e-6 on an H100), so equal within 1e-6
REPEAT_LOSS_REL = 1e-6
# The 5^3 head convs of one spine forward at batch 3: (name, Ci, Co, [N, D,
# H, W], convs a step). W of 9, 4, 2 and 12 gives rows a tensor copy cannot
# describe; the two levels at W = 8 are the describable ones, for contrast.
SPINE_CONVS = [("down_tr32", 32, 32, (3, 256, 256, 9), 1),
               ("down_tr64", 64, 64, (3, 128, 128, 8), 2),
               ("down_tr128", 128, 128, (3, 64, 64, 4), 3),
               ("down_tr256", 256, 256, (3, 32, 32, 2), 2),
               ("up_tr256", 256, 256, (3, 64, 64, 4), 2),
               ("up_tr128", 128, 128, (3, 128, 128, 8), 2),
               ("up_tr64", 64, 64, (3, 256, 256, 9), 1),
               ("up_tr32", 32, 32, (3, 512, 512, 12), 1),
               ("out_tr", 32, 20, (3, 512, 512, 12), 1)]
BATCH = 2
EDGE = 128  # served volume edge
# the f32 stem's shapes beside the cube's (CONVS' in_tr), [N, D, 1, H, W]:
# the upstream spine recipes' stem, the cube's H block behind a 2-row halo
# on each side (a rank of a space-2 mesh: H / 2 + 4 rows), and a ragged
# view (rows of 100, a base 4 bytes into its allocation; g a channel slice)
F32_STEMS = [("in_tr_spine", (3, 512, 512, 12)),
             ("in_tr_halo_h", (BATCH, EDGE, EDGE // 2 + 4, EDGE)),
             ("in_tr_ragged", (1, 64, 96, 100))]
# the flagship's stem input as the weight gradient sees it: [N, D, 1, H, W]
# (configs/synthetic/vnetdeepsup_synspine_15k.yml: batch 3, 12 x 512 x 512)
FLAGSHIP_STEM = (3, 12, 512, 512)
# The 5^3 convs of one V-Net forward at 128^3: (name, kind, Ci, Co, edge,
# convs per forward). 16 convs: the stem, the NConv stacks, the head.
CONVS = [("in_tr", "stem", 1, 16, 128, 1),
         ("down_tr32", "head", 32, 32, 64, 1),
         ("down_tr64", "head", 64, 64, 32, 2),
         ("down_tr128", "head", 128, 128, 16, 3),
         ("down_tr256", "head", 256, 256, 8, 2),
         ("up_tr256", "head", 256, 256, 16, 2),
         ("up_tr128", "head", 128, 128, 32, 2),
         ("up_tr64", "head", 64, 64, 64, 1),
         ("up_tr32", "head", 32, 32, 128, 1),
         ("out_tr", "head", 32, 3, 128, 1)]
# The pins of one forward: each down/up conv output [N, C, D, H, W] seen as
# [N, D, C, H, W]: (C, edge).
PINS = [(32, 64), (64, 32), (128, 16), (256, 8),
        (128, 16), (64, 32), (32, 64), (16, 128)]
SCAN = (200, 512, 512)  # a raw CT scan: slices x rows x columns
HU_TOL = 1e-3  # hu_resize vs plain, on the window's 0..255 scale
# the prep tools' lung recipe, card against the host backend (numpy /
# scipy): float32 against scipy's float64 interpolation, on the window's
# 0..255 scale; labels (nearest) exactly
PREP_SCANS = 3
PREP_TOL = 1e-3
# int8 against bf16 serving, same random-init weights: share of voxels
# with the same argmax
INT8_AGREE = 0.99
FWD_KERNELS = ("conv5_head", "conv5_stem_tc", "conv5_fused_epilogue",
               "pin")
BWD_KERNELS = ("conv5_dgrad", "conv5_wgrad_stem_tc",
               "conv5_wgrad_head_tma", "conv5_wgrad_tma")
# the spine recipe's ragged weight gradients (train_spine): the tensor-copy
# kernel fed by its software producer
SPINE_KERNELS = ("conv5_wgrad_ragged",)
# the f32 route (the upstream f32 recipes, train_f32, train_spine_f32): the
# split-TF32 kernels, the head convs' and the stem's; each f32 form's stats
# key by kind
F32_FWD = {"head": "conv5_head_tf32", "stem": "conv5_stem_tf32"}
F32_DGRAD = "conv5_dgrad_tf32"
F32_WGRAD = {"head": "conv5_wgrad_tf32", "stem": "conv5_wgrad_stem_tf32"}
F32_KERNELS = tuple(F32_FWD.values()) + (F32_DGRAD,) + tuple(
    F32_WGRAD.values())
SOURCES = {"conv5_head": "medicalseg_torch/csrc/conv5_wg.cu",
           "conv5_stem_tc": "medicalseg_torch/csrc/conv5_stem.cu",
           "conv5_fused_epilogue": "medicalseg_torch/csrc/conv5_wg.cu",
           "pin": "medicalseg_torch/csrc/pin.cu",
           "conv5_dgrad": "medicalseg_torch/csrc/conv5_wg.cu",
           "conv5_wgrad_stem_tc": "medicalseg_torch/csrc/conv5_stem_wgrad.cu",
           "conv5_wgrad_tma": "medicalseg_torch/csrc/conv5_wgrad_tma.cu",
           "conv5_wgrad_head_tma": "medicalseg_torch/csrc/conv5_wgrad_tma.cu",
           "conv5_wgrad_ragged": "medicalseg_torch/csrc/conv5_wgrad_tma.cu",
           "hu_resize": "medicalseg_torch/csrc/hu_resize.cu",
           "conv5_head_tf32": "medicalseg_torch/csrc/conv5_tf32.cu",
           "conv5_dgrad_tf32": "medicalseg_torch/csrc/conv5_tf32.cu",
           "conv5_wgrad_tf32": "medicalseg_torch/csrc/conv5_wgrad_tf32.cu",
           "conv5_stem_tf32": "medicalseg_torch/csrc/conv5_stem_tf32.cu",
           "conv5_wgrad_stem_tf32":
               "medicalseg_torch/csrc/conv5_stem_wgrad_tf32.cu"}
REPLACES = {"conv5_head": "medicalseg_tpu/ops/pallas_conv5.py:382",
            "conv5_stem_tc": "medicalseg_tpu/ops/pallas_conv5.py:423",
            "conv5_fused_epilogue": "medicalseg_tpu/ops/pallas_conv5.py:1288",
            "pin": "medicalseg_tpu/ops/pallas_conv5.py:1412",
            "conv5_dgrad": "medicalseg_tpu/ops/pallas_conv5.py:1383",
            "conv5_wgrad_stem_tc": "medicalseg_tpu/ops/pallas_conv5.py:912",
            "conv5_wgrad_tma": "medicalseg_tpu/ops/pallas_conv5.py:832",
            "conv5_wgrad_head_tma": "medicalseg_tpu/ops/pallas_conv5.py:912",
            "conv5_wgrad_ragged": "medicalseg_tpu/ops/pallas_conv5.py:832",
            "hu_resize": "medicalseg_tpu/ops/pallas_kernels.py:86",
            "conv5_head_tf32": "medicalseg_tpu/ops/pallas_conv5.py:309",
            "conv5_dgrad_tf32": "medicalseg_tpu/ops/pallas_conv5.py:1383",
            "conv5_wgrad_tf32": "medicalseg_tpu/ops/pallas_conv5.py:832",
            "conv5_stem_tf32": "medicalseg_tpu/ops/pallas_conv5.py:423",
            "conv5_wgrad_stem_tf32": "medicalseg_tpu/ops/pallas_conv5.py:912"}
TRAIN_SEED = 0
# kernel path vs plain path, relative L2 error per leaf. bf16 at 128^3:
# the two paths round at other places, and the random-init net amplifies
# it (measured worst 0.20, median 0.08, while either bf16 path sits 0.17
# median and 0.49 worst from the f32 gradients). f32 at 64^3: measured
# worst 4e-3.
GRAD_REL_L2 = 0.35
GRAD_REL_L2_F32 = 2e-2
LOSS_REL = 1e-2
# graphed step against the eager step from one state: each step's loss,
# and each parameter and BatchNorm statistic after the run (and the logits
# of a probe), relative. Every kernel of the step is deterministic (the
# hand kernels sum their splits in a fixed order; the cuDNN up/down convs
# and the PyTorch ops picked deterministic algorithms), and both forms ran
# bit for bit alike on an H100: 0.
GRAPH_LOSS_REL = 0.0
GRAPH_PARAM_REL = 0.0
AUG_TOL = 1e-5  # augmented image, card against CPU, same parameters
# the flagship's kernels, each launched by every step of its path
FLAGSHIP_KERNELS = ("conv5_head", "conv5_stem_tc", "pin", "conv5_dgrad",
                    "conv5_wgrad_stem_tc", "conv5_wgrad_tma")
# the eval phase: seeded 128^3 volumes of the cube config, the val CLI's
# three modes (its flags), and the plain-version path's mDice within
EVAL_VOLUMES = 3
EVAL_RUNS = (("whole", []), ("sw2", ["--sw_num", "2"]),
             ("auc_int8", ["--auc_roc", "true", "--weights_precision",
                           "int8"]))
EVAL_MDICE_TOL = 1e-2
# the native phase: device-mode batches held to the numpy reads, the
# inflate's scan (int16; gzip of a full scan would take most of the
# script's time), and the host's fused HU window + resize against the card
# path (the hu_resize kernel, then the H/W passes) on the window's 0..255
# scale, float32 sums in another order
NATIVE_BATCHES = 6
GZ_SCAN = (64, 512, 512)
NATIVE_HU_TOL = HU_TOL
# dataset.json geometry of the eval volumes (x, y, z)
EVAL_GEOMETRY = {"spacing_resample": [0.75, 0.75, 1.5],
                 "origin": [-12.5, 3.0, 40.0],
                 "direction": [1, 0, 0, 0, 1, 0, 0, 0, 1]}


class SmokeFailure(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise SmokeFailure(message)


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed_once(fn):
    """(fn(), its CUDA-event time in ms): one run, no warm-up."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps=5):
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, calls=10, reps=5):
    """Device time of one ``fn()`` in ms with the host's dispatch taken out:
    ``calls`` calls captured into one CUDA graph, the median time of a
    replay over ``calls``. For kernels of a few microseconds, which a
    host-timed call measures as the wrapper's Python."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps) / calls
    del graph
    return ms


def new_stats(keys):
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bound_by": {}} for k in keys}


def add_stats(stats, key, count, ms, plain_ms, bound, by, lib_ms):
    s = stats[key]
    s["ms"] += count * ms
    s["plain_ms"] += count * plain_ms
    s["bound_ms"] += count * bound
    s["bound_by"][by] = s["bound_by"].get(by, 0.0) + count * bound
    s["library_ms"] = (None if lib_ms is None or s["library_ms"] is None
                       else s["library_ms"] + count * lib_ms)


def conv_bound_ms(ci, co, vox, itemsize):
    """The least time of one conv of ``vox`` voxels, forward or backward:
    the same 2 * 125 * Ci * Co FLOP per voxel, and both activations (x and
    y, g and dx, or x and g) moved once beside the f32 weights (read, or dW
    written). bf16 (``itemsize`` 2) at the bf16 tensor-core rate, f32
    (``itemsize`` 4) as split TF32: three TF32 products a term
    (:data:`PEAK_TF32`)."""
    flops = 2.0 * vox * 125 * ci * co
    nbytes = vox * (ci + co) * itemsize + 4 * (125 * ci * co + co)
    ops_ms = (flops / PEAK_BF16 if itemsize == 2 else
              3 * flops / PEAK_TF32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def wg_columns(x, w, b, ep, ci, co, dgrad, ms, lib_ms, prefix=""):
    """The extra columns of a bf16 head conv (forward: ``x`` the input;
    ``dgrad``: ``x`` the cotangent): packing apart from the launch, the
    geometry that ran, the ratio to the library call and, where K is
    split, a fatal bit-for-bit repeat check. ``ms`` is the warm wrapper's
    time, measured by the caller."""
    n, e = x.shape[0], x.shape[1]
    q = c5.conv5_wg_geometry(n, e, e, e, *((co, ci) if dgrad else (ci, co)))

    def call():
        return (c5.conv5_dgrad_kl(x, w) if dgrad else
                c5.conv5_kl_fused(x, w, b, ep, "head"))

    def cold():
        c5._PACKED.clear()
        return call()

    cols = {"kernel_ms": ms,
            "pack_ms": time_ms(lambda: c5._pack_weights_wg(w, q["nt"], dgrad)),
            "cold_ms": time_ms(cold),
            "geometry": {"kernel": "conv5_wg_kernel",
                         "tile": [q["td"], q["th"], q["tw"]], "nt": q["nt"],
                         "mt": q["mt"],
                         "stages": {"halo": c5._WG_XS, "raw": c5._WG_RS,
                                    "weights": q["ws"]},
                         "splits": q["splits"], "smem": q["smem"],
                         "grid": list(q["grid"])},
            "vs_library": ms / lib_ms}
    if q["splits"] > 1:
        first, second = call(), call()
        torch.cuda.synchronize()
        cols["repeat_bit_identical"] = torch.equal(first, second)
        check(cols["repeat_bit_identical"], "two launches of a split-K conv "
              "{} disagree".format(cols["geometry"]))
    return {prefix + k: v for k, v in cols.items()}


def stem_columns(x, w, b, ep):
    """The extra columns of the bf16 stem: the device time of the kernel
    without and with the epilogue, host dispatch taken out, and the times
    of ``conv5_kernel`` (the kernel ``stem_tc_kernel`` replaced), forced in
    the same process; a fatal bit-for-bit repeat check; the geometry."""
    n, e = x.shape[0], x.shape[1]
    cols = {}
    for tag, e_ in (("", None), ("_fused", ep)):
        def call(form=None, e_=e_):
            return c5._conv5_cuda(x, w, b, "stem", e_, form=form)

        first, second = call(), call()
        torch.cuda.synchronize()
        check(torch.equal(first, second), "two launches of the stem kernel "
              "disagree")
        del first, second

        cols.update({"device_ms" + tag: graph_ms(call),
                     "ms_old" + tag: time_ms(lambda: call("stem")),
                     "device_ms_old" + tag: graph_ms(lambda: call("stem"))})
    cols["repeat_bit_identical"] = True
    cols["geometry"] = dict(kernel="stem_tc_kernel",
                            **c5.conv5_stem_tc_geometry(n, e, e, e))
    return cols


# ----------------------------------------------------------------------
@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's own default for f32 convolutions, TF32 on, for one timing:
    a side column only (it computes a less exact function than the f32
    kernels and the strict-f32 library call, which ``phase_device``
    sets)."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def f32_columns(prefix, call, old_call, plain_ms, lib_call, reps=5):
    """The f32 columns of a conv, forward or backward: ``ms`` the routed
    kernel, ``ms_old`` the CUDA-core kernel forced in the same process
    (none where ``old_call`` is None), the plain version's time
    (``plain_ms``, the caller's single timing: it takes up to seconds), the
    library call in strict f32 (``library_ms``) and, as a side column, with
    TF32 on (``library_tf32_ms``); each the median of ``reps``."""
    cols = {"ms": time_ms(call, reps), "plain_ms": plain_ms,
            "library_ms": time_ms(lib_call, reps)}
    with cudnn_tf32():
        cols["library_tf32_ms"] = time_ms(lib_call, reps)
    cols["vs_library"] = cols["ms"] / cols["library_ms"]
    if old_call is not None:
        cols["ms_old"] = time_ms(old_call, reps)
        cols["old_vs_library"] = cols["ms_old"] / cols["library_ms"]
    return {prefix + k: v for k, v in cols.items()}


def tf32_geometry(n, d, h, w, ci, co, wgrad=False):
    """The launch geometry of ``conv5_tf32_kernel`` (``wgrad``:
    ``wgrad_tf32_kernel``) at this conv, as the chip lines print it."""
    if wgrad:
        q = c5.conv5_wgrad_tf32_geometry(n, d, h, w, ci, co)
        keys = ("nf", "th", "tw", "splits", "chan_blocks", "smem")
    else:
        q = c5.conv5_tf32_geometry(n, d, h, w, ci, co)
        keys = ("nf", "td", "th", "tw", "splits", "smem")
    return dict({k: q[k] for k in keys}, grid=list(q["grid"]))


def bit_repeat(call, what):
    """Two launches of ``call`` give the same bits (fatal if not): the
    split sums are added in a fixed order."""
    first, second = call(), call()
    torch.cuda.synchronize()
    same = torch.equal(first, second)
    check(same, "two launches of the {} disagree".format(what))
    return same


def f32_stem_fwd_columns(x, w, b, ep):
    """The f32 stem forward's device columns: ``stem_tf32_kernel`` without
    and with the epilogue and ``conv5_kernel`` forced in the same process
    (the kernel it replaced), each ten calls replayed from one CUDA graph
    (the weights' packing inside each call, as a captured step runs it);
    a fatal bit-for-bit repeat of both forms; the geometry."""
    n, d, _, h, ww = x.shape
    cols = {}
    for tag, e_ in (("", None), ("_fused", ep)):
        def call(form=None, e_=e_):
            return c5._conv5_cuda(x, w, b, "stem", e_, form=form)

        bit_repeat(call, "f32 stem forward" + tag)
        cols.update({"f32_device_ms" + tag: graph_ms(call),
                     "f32_device_ms_old" + tag: graph_ms(
                         lambda: call("stem"))})
    cols["f32_geometry"] = dict(kernel="stem_tf32_kernel",
                                **c5.conv5_stem_tf32_geometry(n, d, h, ww))
    return cols


def f32_stem_wgrad_columns(x, g):
    """The f32 stem weight gradient's device columns:
    ``stem_wgrad_tf32_kernel`` and ``wgrad_kernel`` forced (graph
    replays) and the geometry."""
    n, d, _, h, ww = x.shape

    def call(form=None):
        return c5._conv5_wgrad_cuda(x, g, "stem", form=form)

    return {"wgrad_f32_device_ms": graph_ms(call),
            "wgrad_f32_device_ms_old": graph_ms(lambda: call("stem")),
            "wgrad_f32_geometry": dict(
                kernel="stem_wgrad_tf32_kernel",
                **c5.conv5_wgrad_stem_tf32_geometry(n, d, h, ww))}


def old_stem_err(name, x, w, b, ep, ref, g=None):
    """``conv5_kernel`` (``g`` None; ``ep`` its epilogue or None) or
    ``wgrad_kernel`` forced on an f32 stem, held to its plain version
    ``ref`` as the routed kernel is (dW scaled by its magnitude); fatal.
    The CUDA-core kernels the split-TF32 stems replaced stay in the port:
    they serve stems wider than 16 channels and every forced comparison.
    Returns the error."""
    tol = TOL[torch.float32]
    if g is None:
        got = c5._conv5_cuda(x, w, b, "stem", ep, form="stem")
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, atol=tol, rtol=tol)
        what = "conv5_kernel{}".format(" fused" if ep else "")
    else:
        err = scaled_err(c5._conv5_wgrad_cuda(x, g, "stem", form="stem"), ref)
        ok = err <= tol
        what = "wgrad_kernel"
    check(ok, "{} f32 {} (forced) disagrees with its plain version: "
          "error {}".format(name, what, err))
    return err


def f32_stem_operands(name, shape, gen, co=16):
    """Seeded f32 stem operands at one :data:`F32_STEMS` shape: x, g, w, b
    and the epilogue; the ragged shape's x lies 4 bytes into its allocation
    and its g is a channel slice of a wider tensor."""
    n, d, h, ww = shape
    dev = torch.device("cuda")
    if name == "in_tr_ragged":
        flat = torch.randn((n * d * h * ww + 1,), generator=gen, device=dev)
        x = flat[1:].view(n, d, 1, h, ww)
        g = torch.randn((n, d, co + 4, h, ww), generator=gen,
                        device=dev)[:, :, 2:2 + co]
    else:
        x = torch.randn((n, d, 1, h, ww), generator=gen, device=dev)
        g = torch.randn((n, d, co, h, ww), generator=gen, device=dev)
    w = torch.randn((5, 5, 5, 1, co), generator=gen, device=dev) / 125 ** 0.5
    b = torch.randn((co,), generator=gen, device=dev)
    ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
          torch.randn((co,), generator=gen, device=dev),
          torch.rand((co,), generator=gen, device=dev))
    return x, g, w, b, ep


def f32_stem_rows(stats, backward):
    """The f32 stem at :data:`F32_STEMS` (the spine recipes' stem, a
    halo'd H block, a ragged view): ``backward`` False, the forward
    unfused and fused (phase ``kernels``), else the weight gradient (phase
    ``kernels_bwd``), each against its plain version (f32: atol = rtol =
    1e-4; dW scaled by its magnitude), with a fatal bit-for-bit repeat,
    host and device times of the routed kernel and of the kernel it
    replaced forced (``ms_old``, ``device_ms_old``), the library call in
    strict f32 and with TF32 on, the bound and the geometry. Their errors
    join ``stats``; their times are not a cube pass's."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, shape in F32_STEMS:
        x, g, w, b, ep = f32_stem_operands(name, shape, gen)
        n, d, _, h, ww = x.shape
        co = g.shape[2]
        bound, by = conv_bound_ms(1, co, n * d * h * ww, 4)
        x_nc = x.transpose(1, 2).contiguous()
        w_o = w.permute(4, 3, 0, 1, 2).contiguous()
        line = {"phase": "kernels_bwd" if backward else "kernels",
                "conv": name, "kind": "stem", "ci": 1, "co": co,
                "shape": [n, d, 1, h, ww], "x_stride": list(x.stride()),
                "f32_bound_ms": bound, "f32_bound_by": by, "per_forward": 0}
        if not backward:
            for tag, e_ in (("plain_form", None), ("fused", ep)):
                got = (c5.conv5_kl_fused(x, w, b, e_, "stem") if e_ else
                       c5.conv5_kl(x, w, b, "stem"))
                ref = c5.conv5_kl_plain(x, w, b, e_)
                err = (got - ref).abs().max().item()
                check(torch.allclose(got, ref, atol=TOL[torch.float32],
                                     rtol=TOL[torch.float32]),
                      "{} f32 {} disagrees with its plain version: max |d| "
                      "{}".format(name, tag, err))
                line["err_float32_" + tag] = err
                line["err_float32_old_" + tag] = old_stem_err(
                    name, x, w, b, e_, ref)
                key = F32_FWD["stem"]
                stats[key]["err"] = max(stats[key]["err"], err)
                del got, ref
            _, plain = timed_once(lambda: c5.conv5_kl_plain(x, w, b))
            line.update(f32_columns(
                "f32_", lambda: c5.conv5_kl(x, w, b, "stem"),
                lambda: c5._conv5_cuda(x, w, b, "stem", None, form="stem"),
                plain, lambda: F.conv3d(x_nc, w_o, b, padding=2)))
            line.update(
                f32_ms_fused=time_ms(
                    lambda: c5.conv5_kl_fused(x, w, b, ep, "stem")),
                f32_ms_old_fused=time_ms(
                    lambda: c5._conv5_cuda(x, w, b, "stem", ep, form="stem")))
            line.update(f32_stem_fwd_columns(x, w, b, ep),
                        f32_form="conv5_" + c5.conv5_form(x, co, "stem"))
        else:
            got = c5.conv5_wgrad_kl(x, g, "stem")
            ref, plain = timed_once(lambda: c5.conv5_wgrad_kl_plain(x, g))
            rel = scaled_err(got, ref)
            check(rel <= TOL[torch.float32], "{} f32 weight gradient "
                  "disagrees with its plain version: scaled error {}".format(
                      name, rel))
            key = F32_WGRAD["stem"]
            stats[key]["err"] = max(stats[key]["err"],
                                    (got - ref).abs().max().item())
            line.update(wgrad_rel_err_float32=rel,
                        wgrad_rel_err_float32_old=old_stem_err(
                            name, x, None, None, None, ref, g),
                        wgrad_max_abs_float32=ref.abs().max().item())
            del got, ref
            g_nc = g.transpose(1, 2).contiguous()
            line.update(f32_columns(
                "wgrad_f32_", lambda: c5.conv5_wgrad_kl(x, g, "stem"),
                lambda: c5._conv5_wgrad_cuda(x, g, "stem", form="stem"),
                plain, lambda: torch.nn.grad.conv3d_weight(
                    x_nc, w_o.shape, g_nc, padding=2)))
            line.update(f32_stem_wgrad_columns(x, g),
                        wgrad_f32_form="conv5_wgrad_" + c5.conv5_wgrad_form(
                            x, g, "stem"),
                        wgrad_f32_repeat_bit_identical=bit_repeat(
                            lambda: c5.conv5_wgrad_kl(x, g, "stem"),
                            name + " f32 weight gradient"))
            del g_nc
        emit(line)
        del x, g, x_nc


def smi_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = smi_line()
    print(smi, flush=True)
    strict_f32()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    t0 = time.time()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": [p.name for p in paths.values()]})


def write_spine_phase0(wd, shape=FLAGSHIP_STEM[1:], scale=255.0):
    """Four seeded spine volumes of ``shape`` (float32 in [0, ``scale``);
    the flagship's 12 x 512 x 512 in [0, 255] by default) and labels in
    [0, 20) (uint8) as ``.npy`` with train and val lists under
    ``wd/phase0`` (MRISpineSeg's phase0 layout); returns that
    directory."""
    phase0 = os.path.join(wd, "phase0")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(phase0, sub))
    rng = np.random.RandomState(TRAIN_SEED)
    lines = []
    for i in range(SPINE_CLI_VOLUMES):
        name = "spine{}.npy".format(i)
        np.save(os.path.join(phase0, "images", name),
                (rng.rand(*shape) * scale).astype(np.float32))
        np.save(os.path.join(phase0, "labels", name),
                rng.randint(0, 20, shape).astype(np.uint8))
        lines.append("images/{0} labels/{0}\n".format(name))
    for split in ("train", "val"):
        with open(os.path.join(phase0, split + "_list.txt"), "w") as f:
            f.writelines(lines)
    return phase0


def host_ms(fn, reps=5, sync=False):
    """(last result, median host-clock ms of ``reps`` calls of ``fn``),
    each call synchronized with the card when ``sync``."""
    times = []
    for _ in range(reps):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def numpy_batch(pairs, uidx, img_dtype, lab_dtype, held=None):
    """A device-mode batch as the loader read it with numpy before the
    native reader: ``np.load`` (kept in ``held`` as its LRU cache kept the
    volumes; each call reads the files when None), ``np.stack`` as float32,
    cast to the wire dtypes, pinned as the prefetcher pinned it."""
    vols = []
    for i in uidx:
        item = None if held is None else held.get(i)
        if item is None:
            item = tuple(np.load(p) for p in pairs[i])
            if held is not None:
                held[i] = item
        vols.append(item)
    images = np.stack([np.asarray(v[0], np.float32) for v in vols])
    labels = np.stack([np.asarray(v[1]) for v in vols])
    return (torch.from_numpy(images).to(img_dtype).pin_memory(),
            torch.from_numpy(labels).to(lab_dtype).pin_memory())


def phase_native():
    """The native volume reader (module docstring, ``native``)."""
    from medicalseg_torch import data_native
    from medicalseg_torch.core.loader import TrainLoader
    from medicalseg_torch.datasets import MedicalDataset
    t0 = time.perf_counter()
    backend = data_native.backend()
    line = {"phase": "native", "gpu": smi_line(), "backend": backend,
            "gxx": _build.gxx_identity(_build._gxx(), False).splitlines()[0],
            "build_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        phase0 = write_spine_phase0(wd)
        ds = MedicalDataset(phase0, phase0, [RandomFlip3D()], 20)
        kw = dict(batch_size=FLAGSHIP_STEM[0], num_workers=0,
                  seed=TRAIN_SEED, wire_dtype="bfloat16")
        loader = TrainLoader(ds, mode="device", pin_memory=True, **kw)
        index = TrainLoader(ds, mode="device_cache", **kw)
        pairs = loader.unique_pairs
        wire = (loader._img_dtype, loader._lab_dtype)
        held = {}
        try:
            for _ in range(NATIVE_BATCHES):
                uidx = next(index)  # the same seeded sequence
                got = next(loader)
                want = numpy_batch(pairs, uidx, *wire, held)
                check(all(t.is_pinned() for t in got), "a native batch "
                      "is not in pinned memory")
                check(all(g.dtype == w.dtype and torch.equal(g, w)
                          for g, w in zip(got, want)),
                      "native batch {} differs from the numpy read".format(
                          list(uidx)))
            # one batch, every volume in each reader's cache (in ``held``)
            _, native_ms = host_ms(lambda: loader.read_batch(uidx))
            _, numpy_ms = host_ms(lambda: numpy_batch(pairs, uidx, *wire,
                                                      held))
            _, numpy_read_ms = host_ms(lambda: numpy_batch(pairs, uidx,
                                                           *wire))
        finally:
            loader.stop()
            index.stop()

        def native_cold():  # new readers: the files read again
            readers = [data_native.NativeVolumeLoader(
                [p[k] for p in pairs], threads=1) for k in (0, 1)]
            try:
                images, labels = (torch.empty(
                    (len(uidx),) + FLAGSHIP_STEM[1:], dtype=w,
                    pin_memory=True) for w in wire)
                images.copy_(torch.from_numpy(readers[0].load_batch(uidx)))
                return images, readers[1].load_batch(uidx, wire[1],
                                                     out=labels)
            finally:
                for r in readers:
                    r.close()

        _, native_read_ms = host_ms(native_cold)
        line["reader"] = {
            "batch": list(map(int, uidx)), "wire": [str(w) for w in wire],
            "batches_equal": NATIVE_BATCHES,
            "native_ms": native_ms, "numpy_ms": numpy_ms,
            "native_new_readers_ms": native_read_ms,
            "numpy_from_files_ms": numpy_read_ms}

        cached = TrainLoader(ds, mode="device_cache", **kw)
        try:
            got, native_s = host_ms(lambda: cached.build_device_cache("cuda"),
                                    reps=1, sync=True)
        finally:
            cached.stop()

        def numpy_cache():
            shape = np.load(pairs[0][0], mmap_mode="r").shape
            images = torch.empty((len(pairs),) + shape, dtype=wire[0])
            labels = torch.empty((len(pairs),) + shape, dtype=wire[1])
            for i, (img, lab) in enumerate(pairs):
                images[i] = torch.from_numpy(np.load(img))
                labels[i] = torch.from_numpy(np.load(lab))
            return images.to("cuda"), labels.to("cuda")

        want, numpy_s = host_ms(numpy_cache, reps=1, sync=True)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "the native device cache differs from the numpy one")
        line["device_cache"] = {"volumes": len(pairs),
                                "native_s": native_s / 1e3,
                                "numpy_s": numpy_s / 1e3}
        del got, want

        scan = os.path.join(wd, "ct.nii.gz")
        vol = np.nan_to_num(raw_scan(GZ_SCAN, 40).cpu().numpy()).astype(
            np.int16)
        t0 = time.perf_counter()
        medio.write_image(scan, vol, spacing=(0.7, 0.7, 1.5))
        write_s = time.perf_counter() - t0

        def gzip_module():
            with gzip.open(scan, "rb") as f:
                return f.read()

        raw, inflate_ms = host_ms(lambda: data_native.gzip_read_bytes(scan),
                                  reps=3)
        ref, gzip_ms = host_ms(gzip_module, reps=3)
        check(raw is not None and bytes(raw) == ref, "the native inflate "
              "differs from the gzip module's bytes")
        read, read_ms = host_ms(lambda: medio.read_image(scan)[0], reps=3)
        check(np.array_equal(read, vol), "io.nifti.read of the .nii.gz "
              "differs from the volume written")
        del raw, ref

        size = (EDGE,) * 3
        host, nii_ms = host_ms(lambda: data_native.load_nii_hu_resize(
            scan, size, out_dtype="float32"), reps=3)
        hr.reset_launches()
        card, card_ms = host_ms(lambda: hr.hu_norm_resize(torch.from_numpy(
            medio.read_image(scan)[0]).to("cuda"), size), reps=3, sync=True)
        check(hr.LAUNCHES["hu_resize"] == 3, "the card path did not run the "
              "hu_resize kernel: {}".format(hr.LAUNCHES))
        err = (host.to("cuda") - card).abs().max().item()
        check(tuple(host.shape) == size and err <= NATIVE_HU_TOL,
              "load_nii_hu_resize differs from the hu_resize kernel's path: "
              "max |d| {}".format(err))
        line["inflate"] = {"scan": list(GZ_SCAN), "dtype": "int16",
                           "file_mb": os.path.getsize(scan) / 2 ** 20,
                           "payload_mb": vol.nbytes / 2 ** 20,
                           "write_s": write_s, "native_ms": inflate_ms,
                           "gzip_module_ms": gzip_ms,
                           "nifti_read_ms": read_ms}
        line["hu_resize"] = {"size": list(size), "max_abs_err": err,
                             "tol": NATIVE_HU_TOL,
                             "host_load_nii_hu_resize_ms": nii_ms,
                             "card_read_upload_kernel_ms": card_ms}
    emit(line)
    return line


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    stats = new_stats(FWD_KERNELS + tuple(F32_FWD.values()))

    def add(*args):
        add_stats(stats, *args)

    for name, kind, ci, co, e, count in CONVS:
        x = torch.randn((BATCH, e, ci, e, e), generator=gen, device=dev)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device=dev)
        ep = (0.5 + torch.rand((co,), generator=gen, device=dev),
              torch.randn((co,), generator=gen, device=dev),
              torch.rand((co,), generator=gen, device=dev))
        form = "conv5_" + c5.conv5_form(x.to(torch.bfloat16), co, kind)
        line = {"phase": "kernels", "conv": name, "kind": kind, "ci": ci,
                "co": co, "shape": [BATCH, e, ci, e, e], "form": form}
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            for fused in (False, True):
                e_ = ep if fused else None
                got = (c5.conv5_kl_fused(xd, w, b, e_, kind) if fused else
                       c5.conv5_kl(xd, w, b, kind))
                ref = c5.conv5_kl_plain(xd, w, b, e_)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                tag = "{}_{}".format(str(dtype)[6:],
                                     "fused" if fused else "plain_form")
                line["err_" + tag] = err
                check(torch.allclose(got.float(), ref.float(),
                                     atol=TOL[dtype], rtol=TOL[dtype]),
                      "{} {} disagrees with its plain version: max |d| "
                      "{}".format(name, tag, err))
                if dtype == torch.bfloat16:
                    key = "conv5_fused_epilogue" if fused else form
                    stats[key]["err"] = max(stats[key]["err"], err)
                    if fused and kind == "stem":
                        stats[form]["err"] = max(stats[form]["err"], err)
                else:
                    key = F32_FWD[kind]
                    stats[key]["err"] = max(stats[key]["err"], err)
                    if kind == "stem":
                        line["err_float32_old_" + tag[8:]] = old_stem_err(
                            name, xd, w, b, e_, ref)
                del got, ref
        xb = x.to(torch.bfloat16)
        ms = time_ms(lambda: c5.conv5_kl(xb, w, b, kind))
        ms_f = time_ms(lambda: c5.conv5_kl_fused(xb, w, b, ep, kind))
        plain = time_ms(lambda: c5.conv5_kl_plain(xb, w, b))
        plain_f = time_ms(lambda: c5.conv5_kl_plain(xb, w, b, ep))
        x_ncdhw = xb.transpose(1, 2).contiguous()
        w_oidhw = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        b16 = b.to(torch.bfloat16)
        lib = time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, b16, padding=2))
        bound, by = conv_bound_ms(ci, co, BATCH * e ** 3, 2)
        line.update(ms=ms, ms_fused=ms_f, plain_ms=plain,
                    plain_ms_fused=plain_f, library_ms=lib, bound_ms=bound,
                    bound_by=by, per_forward=count)
        if kind == "head":
            line.update(wg_columns(xb, w, b, ep, ci, co, False, ms_f, lib))
        else:
            line.update(stem_columns(xb, w, b, ep))
        # float32: the routed kernel beside the CUDA-core conv5_kernel
        # forced, cuDNN in strict f32 (TF32 on as a side column)
        x_nc32 = x.transpose(1, 2).contiguous()
        w_o32 = w.permute(4, 3, 0, 1, 2).contiguous()
        _, plain32 = timed_once(lambda: c5.conv5_kl_plain(x, w, b))
        cols = f32_columns(
            "f32_", lambda: c5.conv5_kl(x, w, b, kind),
            lambda: c5._conv5_cuda(x, w, b, kind, None, form=kind), plain32,
            lambda: F.conv3d(x_nc32, w_o32, b, padding=2))
        bound32, by32 = conv_bound_ms(ci, co, BATCH * e ** 3, 4)
        cols.update(f32_ms_fused=time_ms(
            lambda: c5.conv5_kl_fused(x, w, b, ep, kind)),
            f32_ms_old_fused=time_ms(
                lambda: c5._conv5_cuda(x, w, b, kind, ep, form=kind)),
            f32_bound_ms=bound32, f32_bound_by=by32,
            f32_form=F32_FWD[kind])
        cols["f32_repeat_bit_identical"] = bit_repeat(
            lambda: c5.conv5_kl(x, w, b, kind), name + " f32 forward")
        if kind == "head":
            cols["f32_geometry"] = tf32_geometry(BATCH, e, e, e, ci, co)
        else:
            cols.update(f32_stem_fwd_columns(x, w, b, ep))
        line.update(cols)
        emit(line)
        add(form, count, ms, plain, bound, by, lib)
        add("conv5_fused_epilogue", count, ms_f, plain_f, bound, by, None)
        add(F32_FWD[kind], count, cols["f32_ms"], cols["f32_plain_ms"],
            bound32, by32, cols["f32_library_ms"])
        del x, xb, x_ncdhw, x_nc32
    f32_stem_rows(stats, backward=False)

    for c, e in PINS:
        src = torch.randn((BATCH, c, e, e, e), generator=gen,
                          device=dev).to(torch.bfloat16)
        view = src.transpose(1, 2)
        got = c5.pin_kl(view)
        torch.cuda.synchronize()
        check(got.is_contiguous() and torch.equal(got, view.contiguous()),
              "pin disagrees with contiguous() at C={} edge={}".format(c, e))
        ms = time_ms(lambda: c5.pin_kl(view))
        plain = time_ms(lambda: c5.pin_kl_plain(view))
        nbytes = 2 * src.numel() * src.element_size()
        bound = nbytes / PEAK_BYTES * 1e3
        dev_ms = graph_ms(lambda: c5.pin_kl(view))
        dev_lib = graph_ms(lambda: c5.pin_kl_plain(view))
        emit({"phase": "kernels", "pin": [BATCH, e, c, e, e], "ms": ms,
              "plain_ms": plain, "library_ms": plain, "bound_ms": bound,
              "bound_by": "bytes", "err": 0.0, "vs_library": ms / plain,
              "device_ms": dev_ms, "library_device_ms": dev_lib,
              "device_vs_library": dev_ms / dev_lib,
              "path": c5.pin_plan(tuple(view.shape), view.stride(),
                                  view.element_size(),
                                  view.data_ptr())["path"]})
        add("pin", 1, ms, plain, bound, "bytes", plain)
    return stats


def scaled_err(got, ref):
    """max |got - ref| / (max |ref| + |ref|): the error relative to the
    tensor's magnitude, for sums whose entries grow with the voxel count."""
    ref = ref.float()
    return ((got.float() - ref).abs() /
            (ref.abs().max() + ref.abs())).max().item()


def phase_kernels_bwd():
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    stats = new_stats(BWD_KERNELS + (F32_DGRAD,) + tuple(F32_WGRAD.values())
                      + SPINE_KERNELS)
    # the convs of one cube backward, and the flagship's stem (counted
    # apart: the kernels line sums one cube backward)
    shapes = [(name, kind, ci, co, (BATCH, e, e, e), count)
              for name, kind, ci, co, e, count in CONVS]
    shapes.append(("in_tr_flagship", "stem", 1, 16, FLAGSHIP_STEM, 0))
    for name, kind, ci, co, (n, d, h, ww), count in shapes:
        x = torch.randn((n, d, ci, h, ww), generator=gen, device=dev)
        g = torch.randn((n, d, co, h, ww), generator=gen, device=dev)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device=dev) / (125 * ci) ** 0.5
        form = "conv5_wgrad_" + c5.conv5_wgrad_form(
            x.to(torch.bfloat16), g.to(torch.bfloat16), kind)
        line = {"phase": "kernels_bwd", "conv": name, "kind": kind, "ci": ci,
                "co": co, "shape": [n, d, ci, h, ww], "wgrad_form": form}
        plain_w, plain_d = {}, {}  # the plain versions, timed once a dtype
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype)[6:]
            xd, gd = x.to(dtype), g.to(dtype)
            got = c5.conv5_wgrad_kl(xd, gd, kind)
            torch.cuda.synchronize()
            ref, plain_w[dtype] = timed_once(
                lambda: c5.conv5_wgrad_kl_plain(xd, gd))
            check(tuple(got.shape) == (5, 5, 5, ci, co) and
                  got.dtype == torch.float32, name + " dW shape/dtype")
            rel = scaled_err(got, ref)
            line["wgrad_rel_err_" + tag] = rel
            line["wgrad_max_abs_" + tag] = ref.abs().max().item()
            check(bool(torch.isfinite(got).all()) and rel <= TOL[dtype],
                  "{} wgrad {} disagrees with its plain version: scaled "
                  "error {}".format(name, tag, rel))
            key = form if dtype == torch.bfloat16 else F32_WGRAD[kind]
            stats[key]["err"] = max(stats[key]["err"],
                                    (got - ref).abs().max().item())
            if dtype == torch.float32 and kind == "stem":
                line["wgrad_rel_err_float32_old"] = old_stem_err(
                    name, xd, None, None, None, ref, gd)
            del got, ref
            if kind != "stem":
                got = c5.conv5_dgrad_kl(gd, w)
                ref, plain_d[dtype] = timed_once(
                    lambda: c5.conv5_dgrad_kl_plain(gd, w))
                err = (got.float() - ref.float()).abs().max().item()
                line["dgrad_err_" + tag] = err
                check(torch.allclose(got.float(), ref.float(),
                                     atol=TOL[dtype], rtol=TOL[dtype]),
                      "{} dgrad {} disagrees with its plain version: max "
                      "|d| {}".format(name, tag, err))
                key = ("conv5_dgrad" if dtype == torch.bfloat16 else
                       F32_DGRAD)
                stats[key]["err"] = max(stats[key]["err"], err)
                del got, ref
            del xd, gd
        xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
        bound, by = conv_bound_ms(ci, co, n * d * h * ww, 2)
        x_ncdhw = xb.transpose(1, 2).contiguous()
        g_ncdhw = gb.transpose(1, 2).contiguous()
        w_oidhw = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        ms_w = time_ms(lambda: c5.conv5_wgrad_kl(xb, gb, kind))
        lib_w = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x_ncdhw, w_oidhw.shape, g_ncdhw, padding=2))
        line.update(wgrad_ms=ms_w, wgrad_plain_ms=plain_w[torch.bfloat16],
                    wgrad_library_ms=lib_w, bound_ms=bound, bound_by=by,
                    per_step=count)
        if form in ("conv5_wgrad_tma", "conv5_wgrad_head_tma",
                    "conv5_wgrad_stem_tc"):
            if form == "conv5_wgrad_stem_tc":
                q = c5.conv5_wgrad_stem_tc_geometry(n, d, h, ww)
                keys = ("th", "tw", "dc", "chunks", "items", "per", "blocks",
                        "smem")
            else:
                q = (c5.conv5_wgrad_tma_geometry if form == "conv5_wgrad_tma"
                     else c5.conv5_wgrad_head_tma_geometry)(n, d, h, ww, ci,
                                                             co)
                keys = ("th", "tw", "stages", "splits", "chan_blocks", "smem")
            first, second = (c5.conv5_wgrad_kl(xb, gb, kind) for _ in "12")
            torch.cuda.synchronize()
            line.update(wgrad_repeat_bit_identical=torch.equal(first, second),
                        wgrad_geometry={k: q[k] for k in keys})
            check(line["wgrad_repeat_bit_identical"], "two launches of the "
                  "{} weight gradient disagree".format(name))
            del first, second
        # the kernel each of these routes replaced, forced, in the same
        # process; for the stem also both device times (graph replays)
        old_form = {"conv5_wgrad_head_tma": "head",
                    "conv5_wgrad_stem_tc": "stem"}.get(form)
        if old_form:
            def old_call(old_form=old_form):
                return c5._conv5_wgrad_cuda(xb, gb, kind, form=old_form).to(
                    torch.bfloat16).float()

            line["wgrad_old_ms"] = time_ms(old_call)
        if form == "conv5_wgrad_stem_tc":
            line.update(
                wgrad_device_ms=graph_ms(lambda: c5.conv5_wgrad_kl(
                    xb, gb, kind)),
                wgrad_device_ms_old=graph_ms(old_call),
                wgrad_old_scaled_err=scaled_err(old_call(), c5.conv5_wgrad_kl(
                    xb, gb, kind)))
        add_stats(stats, form, count, ms_w, plain_w[torch.bfloat16], bound,
                  by, lib_w)
        if kind != "stem":
            ms_d = time_ms(lambda: c5.conv5_dgrad_kl(gb, w))
            lib_d = time_ms(lambda: torch.nn.grad.conv3d_input(
                x_ncdhw.shape, w_oidhw, g_ncdhw, padding=2))
            line.update(dgrad_ms=ms_d,
                        dgrad_plain_ms=plain_d[torch.bfloat16],
                        dgrad_library_ms=lib_d)
            line.update(wg_columns(gb, w, None, None, ci, co, True, ms_d,
                                   lib_d, prefix="dgrad_"))
            add_stats(stats, "conv5_dgrad", count, ms_d,
                      plain_d[torch.bfloat16], bound, by, lib_d)
        del xb, gb, x_ncdhw, g_ncdhw
        line.update(f32_bwd_columns(stats, name, kind, x, g, w, count,
                                    plain_w[torch.float32],
                                    plain_d.get(torch.float32)))
        emit(line)
        del x, g
    f32_stem_rows(stats, backward=True)
    phase_ragged_wgrad()
    spine_conv_rows(stats)
    return stats


def spine_conv_rows(stats):
    """Each :data:`SPINE_CONVS` conv in bf16 at full size, forward, input
    gradient and weight gradient: the routed kernel against its plain
    version (the forward's tolerances; dW scaled as kernels_bwd), its time,
    the plain version's (once), the library call's (``F.conv3d``,
    ``conv3d_input``, ``conv3d_weight``), the bound and the geometry; for
    a ragged weight gradient also ``wgrad_mma_kernel<4>`` forced
    (``wgrad_old_ms``). The ragged weight gradients of one step are summed
    into ``stats`` under their form. Then each conv in f32
    (:func:`spine_f32_row`), and one line of the f32 passes summed over a
    spine step (``spine_f32_step``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    sums = {p: dict.fromkeys(SPINE_F32_SUMS, 0.0) for p in SPINE_F32_PASSES}
    for name, ci, co, (n, d, h, ww), count in SPINE_CONVS:
        x = torch.randn((n, d, ci, h, ww), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        g = torch.randn((n, d, co, h, ww), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((5, 5, 5, ci, co), generator=gen,
                        device="cuda") / (125 * ci) ** 0.5
        b = torch.randn((co,), generator=gen, device="cuda")
        x_nc, g_nc = (t.transpose(1, 2).contiguous() for t in (x, g))
        w_o = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        bound, by = conv_bound_ms(ci, co, n * d * h * ww, 2)
        head = {"ci": ci, "co": co, "shape": [n, d, ci, h, ww],
                "per_step": count, "bound_ms": bound, "bound_by": by}
        q = c5.conv5_wg_geometry(n, d, h, ww, ci, co)
        qd = c5.conv5_wg_geometry(n, d, h, ww, co, ci)
        wg_keys = ("td", "th", "tw", "nt", "splits", "smem")

        got = c5.conv5_kl(x, w, b)
        ref, plain = timed_once(lambda: c5.conv5_kl_plain(x, w, b))
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.allclose(got.float(), ref.float(), atol=TOL[x.dtype],
                             rtol=TOL[x.dtype]), "spine {} forward disagrees "
              "with its plain version: max |d| {}".format(name, err))
        del got, ref
        b16 = b.to(torch.bfloat16)
        emit(dict(head, phase="kernels", spine=name, form="conv5_" +
                  c5.conv5_form(x, co, "head"), kernel="conv5_wg_kernel",
                  err=err, ms=time_ms(lambda: c5.conv5_kl(x, w, b), 3),
                  plain_ms=plain, library_ms=time_ms(
                      lambda: F.conv3d(x_nc, w_o, b16, padding=2), 3),
                  geometry={k: q[k] for k in wg_keys}))

        got = c5.conv5_dgrad_kl(g, w)
        ref, plain = timed_once(lambda: c5.conv5_dgrad_kl_plain(g, w))
        err = (got.float() - ref.float()).abs().max().item()
        check(torch.allclose(got.float(), ref.float(), atol=TOL[x.dtype],
                             rtol=TOL[x.dtype]), "spine {} input gradient "
              "disagrees with its plain version: max |d| {}".format(
                  name, err))
        del got, ref
        line = dict(head, phase="kernels_bwd", spine=name,
                    dgrad_err=err, dgrad_ms=time_ms(
                        lambda: c5.conv5_dgrad_kl(g, w), 3),
                    dgrad_plain_ms=plain, dgrad_library_ms=time_ms(
                        lambda: torch.nn.grad.conv3d_input(
                            x_nc.shape, w_o, g_nc, padding=2), 3),
                    dgrad_geometry={k: qd[k] for k in wg_keys})

        form = c5.conv5_wgrad_form(x, g, "head")
        got = c5.conv5_wgrad_kl(x, g)
        ref, plain = timed_once(lambda: c5.conv5_wgrad_kl_plain(x, g))
        rel = scaled_err(got, ref)
        check(bool(torch.isfinite(got).all()) and rel <= TOL[x.dtype],
              "spine {} weight gradient ({}) disagrees with its plain "
              "version: scaled error {}".format(name, form, rel))
        werr = (got - ref).abs().max().item()
        del got, ref
        ms = time_ms(lambda: c5.conv5_wgrad_kl(x, g), 3)
        lib = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x_nc, w_o.shape, g_nc, padding=2), 3)
        line.update(wgrad_form="conv5_wgrad_" + form,
                    wgrad_rel_err=rel, wgrad_ms=ms, wgrad_plain_ms=plain,
                    wgrad_library_ms=lib, wgrad_geometry=wgrad_geometry(
                        form, n, d, h, ww, ci, co),
                    wgrad_repeat_bit_identical=bit_repeat(
                        lambda: c5.conv5_wgrad_kl(x, g),
                        "spine {} weight gradient".format(name)))
        if form in ("ragged", "head_ragged"):
            line.update(ragged_columns(x, g, 3))
        key = "conv5_wgrad_" + form
        if key in SPINE_KERNELS:
            stats[key]["err"] = max(stats[key]["err"], werr)
            add_stats(stats, key, count, ms, plain, bound, by, lib)
        emit(line)
        del x, g, x_nc, g_nc
        spine_f32_row(name, ci, co, (n, d, h, ww), count, gen, sums)
    emit({"phase": "kernels_bwd", "spine_f32_step": sums,
          "nvidia_smi": smi_line()})


# the split-TF32 kernels' passes of the spine step, each summed over its
# convs a step (SPINE_CONVS' counts)
SPINE_F32_PASSES = ("f32", "dgrad_f32", "wgrad_f32")
SPINE_F32_SUMS = ("ms", "plain_ms", "library_ms", "library_tf32_ms",
                  "bound_ms")


def spine_f32_row(name, ci, co, shape, count, gen, sums):
    """One :data:`SPINE_CONVS` conv in f32 at full size: the split-TF32
    kernels' forward, input gradient and weight gradient each held to its
    plain version (1e-4; dW scaled by its magnitude), their times, the
    plain versions' (once), strict-f32 ``F.conv3d`` / ``conv3d_input`` /
    ``conv3d_weight`` with TF32 on as a side column, the bound in split
    TF32 and the geometry; each pass's columns times the conv's count a
    step added to ``sums``. Then the eval forward, its BN affine + PReLU
    fused (``conv5_kl_fused``), held to its plain version at 1e-4 and
    timed (``f32_fused_*``)."""
    n, d, h, ww = shape
    tol = TOL[torch.float32]
    x = torch.randn((n, d, ci, h, ww), generator=gen, device="cuda")
    g = torch.randn((n, d, co, h, ww), generator=gen, device="cuda")
    w = torch.randn((5, 5, 5, ci, co), generator=gen,
                    device="cuda") / (125 * ci) ** 0.5
    b = torch.randn((co,), generator=gen, device="cuda")
    x_nc, g_nc = (t.transpose(1, 2).contiguous() for t in (x, g))
    w_o = w.permute(4, 3, 0, 1, 2).contiguous()
    bound, by = conv_bound_ms(ci, co, n * d * h * ww, 4)
    line = {"phase": "kernels_bwd", "spine_f32": name, "ci": ci, "co": co,
            "shape": [n, d, ci, h, ww], "per_step": count,
            "f32_bound_ms": bound, "f32_bound_by": by,
            "f32_geometry": tf32_geometry(n, d, h, ww, ci, co),
            "dgrad_f32_geometry": tf32_geometry(n, d, h, ww, co, ci),
            "wgrad_f32_geometry": tf32_geometry(n, d, h, ww, ci, co, True)}
    for prefix, call, plain, lib in (
            ("f32_", lambda: c5.conv5_kl(x, w, b),
             lambda: c5.conv5_kl_plain(x, w, b),
             lambda: F.conv3d(x_nc, w_o, b, padding=2)),
            ("dgrad_f32_", lambda: c5.conv5_dgrad_kl(g, w),
             lambda: c5.conv5_dgrad_kl_plain(g, w),
             lambda: torch.nn.grad.conv3d_input(x_nc.shape, w_o, g_nc,
                                                padding=2)),
            ("wgrad_f32_", lambda: c5.conv5_wgrad_kl(x, g),
             lambda: c5.conv5_wgrad_kl_plain(x, g),
             lambda: torch.nn.grad.conv3d_weight(x_nc, w_o.shape, g_nc,
                                                 padding=2))):
        got = call()
        ref, plain_ms = timed_once(plain)
        if prefix == "wgrad_f32_":
            err = scaled_err(got, ref)
            ok = bool(torch.isfinite(got).all()) and err <= tol
        else:
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, atol=tol, rtol=tol)
        check(ok, "spine {} {}disagrees with its plain version: error "
              "{}".format(name, prefix, err))
        del got, ref
        cols = f32_columns(prefix, call, None, plain_ms, lib, reps=3)
        cols[prefix + "err"] = err
        line.update(cols)
        key = prefix[:-1]
        for col in SPINE_F32_SUMS:
            value = bound if col == "bound_ms" else cols[prefix + col]
            sums[key][col] += count * value
    ep = (0.5 + torch.rand((co,), generator=gen, device="cuda"),
          torch.randn((co,), generator=gen, device="cuda"),
          torch.rand((co,), generator=gen, device="cuda"))
    got = c5.conv5_kl_fused(x, w, b, ep)
    ref = c5.conv5_kl_plain(x, w, b, ep)
    err = (got - ref).abs().max().item()
    check(torch.allclose(got, ref, atol=tol, rtol=tol), "spine {} fused f32 "
          "forward disagrees with its plain version: max |d| {}".format(
              name, err))
    del got, ref
    line.update(f32_fused_err=err, f32_fused_ms=time_ms(
        lambda: c5.conv5_kl_fused(x, w, b, ep), 3))
    emit(line)


def wgrad_geometry(form, n, d, h, w, ci, co):
    """The launch geometry of the weight-gradient kernel of ``form`` at
    this conv, as the chip lines print it."""
    if form in ("tma", "ragged"):
        q = c5.conv5_wgrad_tma_geometry(n, d, h, w, ci, co)
    elif form in ("head_tma", "head_ragged"):
        q = c5.conv5_wgrad_head_tma_geometry(n, d, h, w, ci, co)
    else:
        q = c5.conv5_wgrad_mma_geometry(n, d, h, w, ci, co)
    keys = ("th", "tw", "stages", "splits", "chan_blocks", "smem", "nf")
    if form in ("ragged", "head_ragged"):
        keys += ("producer_warps", "producer_warps_realigned", "xspan",
                 "gspan")
    return {k: q[k] for k in keys if k in q}


def f32_bwd_columns(stats, name, kind, x, g, w, count, plain_w, plain_d):
    """The f32 weight gradient (and, but for the stem, input gradient) of
    one conv: the routed kernel beside the CUDA-core kernel forced
    (``wgrad_kernel``, ``conv5_kernel``), cuDNN's in strict f32 (TF32 on as
    a side column), the split-TF32 bound, a fatal bit-for-bit repeat (for
    the stem also both device times and the geometry); added to
    ``stats``."""
    n, d, ci, h, ww = x.shape
    co = g.shape[2]
    bound, by = conv_bound_ms(ci, co, n * d * h * ww, 4)
    x_nc = x.transpose(1, 2).contiguous()
    g_nc = g.transpose(1, 2).contiguous()
    w_o = w.permute(4, 3, 0, 1, 2).contiguous()
    old = "stem" if kind == "stem" else "head" if co <= 16 else "mid"
    cols = f32_columns(
        "wgrad_f32_", lambda: c5.conv5_wgrad_kl(x, g, kind),
        lambda: c5._conv5_wgrad_cuda(x, g, kind, form=old), plain_w,
        lambda: torch.nn.grad.conv3d_weight(x_nc, w_o.shape, g_nc,
                                            padding=2))
    if kind != "stem":
        cols["wgrad_f32_geometry"] = tf32_geometry(n, d, h, ww, ci, co, True)
        cols["dgrad_f32_geometry"] = tf32_geometry(n, d, h, ww, co, ci)
    else:
        cols.update(f32_stem_wgrad_columns(x, g))
    cols.update(wgrad_f32_bound_ms=bound, wgrad_f32_bound_by=by,
                wgrad_f32_form=F32_WGRAD[kind],
                wgrad_f32_repeat_bit_identical=bit_repeat(
                    lambda: c5.conv5_wgrad_kl(x, g, kind),
                    name + " f32 weight gradient"))
    add_stats(stats, F32_WGRAD[kind], count, cols["wgrad_f32_ms"], plain_w,
              bound, by, cols["wgrad_f32_library_ms"])
    if kind != "stem":
        cols.update(f32_columns(
            "dgrad_f32_", lambda: c5.conv5_dgrad_kl(g, w),
            lambda: c5._conv5_cuda(g, w, None, "head", None, dgrad=True,
                                   form="head"), plain_d,
            lambda: torch.nn.grad.conv3d_input(x_nc.shape, w_o, g_nc,
                                               padding=2)))
        cols.update(dgrad_f32_bound_ms=bound, dgrad_f32_bound_by=by,
                    dgrad_f32_repeat_bit_identical=bit_repeat(
                        lambda: c5.conv5_dgrad_kl(g, w),
                        name + " f32 input gradient"))
        add_stats(stats, F32_DGRAD, count, cols["dgrad_f32_ms"], plain_d,
                  bound, by, cols["dgrad_f32_library_ms"])
    return cols


# bf16 weight gradients on views a tensor copy cannot describe (a W row of
# 12 or 6 elements is 24 or 12 bytes) at the deep levels of a 96^3 V-Net
# (down_tr128 and up_tr256 at 12^3, down_tr256 at 6^3, batch 2) and at
# narrow heads of the same W: (name, Ci, Co, edge)
RAGGED_WGRAD = [("down_tr128_96", 128, 128, 12), ("up_tr256_96", 256, 256, 12),
                ("down_tr256_96", 256, 256, 6), ("head3_w12", 32, 3, 12),
                ("head16_w12", 32, 16, 12)]


def ragged_columns(x, g, reps=5):
    """The side columns of a ragged weight gradient (routed to the
    software producer): ``wgrad_mma_kernel`` forced (``wgrad_old_ms``,
    the kernel it replaced); the pad route, x and g copied into buffers
    whose W is a multiple of 8 and the tensor copy's kernel on them
    (``wgrad_pad_ms``; the kernel alone ``wgrad_pad_kernel_ms``), whose
    MMA work is the same; and whether the route gives the pad route's
    bits (fatal if not: the producer fills the same boxes)."""
    co = g.shape[2]
    old = "mid" if co > 16 else "head"
    xp, gp = padded(x), padded(g)
    same = torch.equal(c5._conv5_wgrad_cuda(x, g, "head"),
                       c5._conv5_wgrad_cuda(xp, gp, "head"))
    check(same and c5.conv5_wgrad_form(xp, gp, "head") in ("tma",
                                                            "head_tma"),
          "the software producer's weight gradient of {} differs from the "
          "tensor copy's on the padded copies".format(tuple(x.shape)))
    cols = {"wgrad_old_ms": time_ms(lambda: c5._conv5_wgrad_cuda(
                x, g, "head", form=old), reps),
            "wgrad_pad_kernel_ms": time_ms(lambda: c5._conv5_wgrad_cuda(
                xp, gp, "head"), reps),
            "wgrad_pad_ms": time_ms(lambda: c5._conv5_wgrad_cuda(
                padded(x), padded(g), "head"), reps),
            "tensor_copy_bit_identical": same}
    del xp, gp
    return cols


def phase_ragged_wgrad():
    """Each :data:`RAGGED_WGRAD` weight gradient in bf16 against its plain
    version (scaled as kernels_bwd), with its time, the plain version's
    (once), ``conv3d_weight``'s, the bound, a fatal bit-for-bit repeat
    and :func:`ragged_columns`."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, ci, co, e in RAGGED_WGRAD:
        shape = (BATCH, e, e, e)
        x = torch.randn((BATCH, e, ci, e, e), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        g = torch.randn((BATCH, e, co, e, e), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        form = c5.conv5_wgrad_form(x, g, "head")
        check(form in ("ragged", "head_ragged"), name + " took " + form)
        got = c5.conv5_wgrad_kl(x, g)
        ref, plain = timed_once(lambda: c5.conv5_wgrad_kl_plain(x, g))
        rel = scaled_err(got, ref)
        check(rel <= TOL[torch.bfloat16], "{} ragged wgrad disagrees with "
              "its plain version: scaled error {}".format(name, rel))
        x_nc, g_nc = x.transpose(1, 2).contiguous(), g.transpose(
            1, 2).contiguous()
        bound, by = conv_bound_ms(ci, co, BATCH * e ** 3, 2)
        line = {"phase": "kernels_bwd", "ragged": name, "ci": ci, "co": co,
                "shape": [BATCH, e, ci, e, e], "wgrad_form": "conv5_wgrad_" +
                form, "wgrad_rel_err_bfloat16": rel,
                "wgrad_ms": time_ms(lambda: c5.conv5_wgrad_kl(x, g)),
                "wgrad_plain_ms": plain,
                "wgrad_library_ms": time_ms(
                    lambda: torch.nn.grad.conv3d_weight(
                        x_nc, (co, ci, 5, 5, 5), g_nc, padding=2)),
                "bound_ms": bound, "bound_by": by,
                "repeat_bit_identical": bit_repeat(
                    lambda: c5.conv5_wgrad_kl(x, g),
                    name + " weight gradient"),
                "geometry": wgrad_geometry(form, *shape, ci, co)}
        line.update(ragged_columns(x, g))
        emit(line)
        del x, g, x_nc, g_nc, got, ref


KERNEL_TAGS = ("conv5_wg_kernel", "conv5_reduce_kernel", "conv5_kernel",
               "conv5_tf32_kernel", "conv5_tf32_reduce_kernel",
               "wgrad_tf32_kernel", "wgrad_tf32_reduce_kernel",
               "wgrad_kernel", "wgrad_reduce_kernel", "wgrad_tma_kernel",
               "wgrad_tma_reduce_kernel", "wgrad_head_tma_kernel",
               "stem_tc_kernel", "stem_wgrad_tc_kernel",
               "stem_wgrad_reduce_kernel", "pin_vec_kernel", "pin_kernel",
               "stem_tf32_kernel", "stem_wgrad_tf32_kernel",
               "stem_wgrad_tf32_reduce_kernel")


def profiled(fn, lead=False):
    """(the finished profiler over one call of ``fn``, that call's host
    wall ms). ``lead``: the window opens with one one-element fill and
    20 ms of host sleep before ``fn``, outside its wall time, so that the
    call's first kernels do not fall at the window's edge (the fill adds
    its microseconds to the busy time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead:
            torch.ones((1,), device="cuda")
            torch.cuda.synchronize()
            time.sleep(0.02)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def profile_call(fn, lead=False):
    """Device time by kernel over one call of ``fn`` (torch.profiler), the
    device time of the kernels each PyTorch operator launched itself (its
    self device time; the ten largest of each), and the device's idle share
    of the host wall time of that call. NCCL kernels are summed apart
    (``nccl_ms``), out of the busy time: a collective's kernel runs on its
    own stream and spins while it waits for the other ranks, so its time
    overlaps the compute stream's and is not work."""
    return profile_stats(*profiled(fn, lead))


# the f32 stem's kernels in a step: the split-TF32 ones and, forced, the
# CUDA-core ones they replaced (each with its reduce)
STEM_TAGS = {False: ("stem_tf32_kernel", "stem_wgrad_tf32_kernel",
                     "stem_wgrad_tf32_reduce_kernel"),
             True: ("conv5_kernel", "wgrad_kernel", "wgrad_reduce_kernel")}


def counted_profile(fn, profiler=profile_call, attempts=3):
    """``profiler(fn, lead=True)`` whose window holds every hand-kernel
    launch the wrappers counted over the same call: the trace's launches
    of the csrc kernels (a split sum's second kernel not counted) against
    the sum of ``LAUNCHES`` (the fused epilogue, a second count of a
    forward, not counted). A window short of a kernel is taken again, up to
    ``attempts`` windows (``trace_windows``). Where none is whole
    (``whole`` False) its device time and idle share are not given (None)
    and the last window's hand-kernel counts by name (``hand_counts``) stand
    beside the wrappers' (``counted``). Leaves ``LAUNCHES`` at the profiled
    call's counts. For paths whose every wrapper launches one kernel
    besides its reduce (the f32 steps)."""
    for attempt in range(1, attempts + 1):
        c5.reset_launches()
        stats = profiler(fn, lead=True)
        want = sum(v for k, v in c5.LAUNCHES.items()
                   if k != "conv5_fused_epilogue")
        stats.update(trace_windows=attempt,
                     whole=stats["hand_launches"] == want)
        if stats["whole"]:
            return stats
    stats.update(device_busy_ms=None, idle_share=None,
                 counted={k: v for k, v in c5.LAUNCHES.items() if v})
    return stats


def stems_ms(profile, old):
    """The f32 stem's own device ms in a profiled step (forward, weight
    gradient and its reduce; ``old``: the CUDA-core kernels forced, the
    heads on the split-TF32 kernels), None where the window was not
    whole."""
    if not profile["whole"]:
        return None
    return sum(profile["hand_ms"].get(k, 0.0) for k in STEM_TAGS[old])


def minus(a, b):
    return None if a is None or b is None else a - b


def device_groups(prof):
    """({kernel group: device ms}, NCCL ms) of a finished profiler: its
    device events (``key_averages``), the hand kernels grouped by
    :data:`KERNEL_TAGS`, NCCL's apart."""
    groups, nccl_ms = {}, 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if "nccl" in ev.key.lower():
            nccl_ms += ms
            continue
        # the longest tag in the name: "stem_wgrad_tf32_kernel" holds
        # "wgrad_tf32_kernel" too
        name = max((tag for tag in KERNEL_TAGS if tag in ev.key), key=len,
                   default=ev.key)
        groups[name] = groups.get(name, 0.0) + ms
    return groups, nccl_ms


def hand_counts(prof):
    """{csrc kernel: launches} of a finished profiler's device events."""
    counts = {}
    for ev in prof.key_averages():
        kernel = (trace_ops.hand_kernel(ev.key) if getattr(
            ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                  else None)
        if kernel is not None:
            counts[kernel] = counts.get(kernel, 0) + ev.count
    return counts


def profile_stats(prof, wall_ms):
    """:func:`profile_call`'s figures from a finished profiler over a
    window of ``wall_ms`` on the host clock."""
    groups, nccl_ms = device_groups(prof)
    busy_ms = sum(groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    ops = [(ev.key, ev.self_device_time_total / 1e3)
           for ev in prof.key_averages()
           if getattr(ev, "device_type", None) ==
           torch.autograd.DeviceType.CPU and ev.self_device_time_total]
    counts = hand_counts(prof)
    hand = sum(v for k, v in counts.items()
               if k not in trace_ops.REDUCE_KERNELS)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "hand_launches": hand,
            "hand_ms": {k: v for k, v in groups.items() if k in KERNEL_TAGS},
            "hand_counts": counts,
            "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "nccl_ms": nccl_ms,
            "device_ms_by_kernel": [[k[:80], v] for k, v in top],
            "device_ms_by_op": [[k[:80], v] for k, v in sorted(
                ops, key=lambda kv: -kv[1])[:10]]}


@contextlib.contextmanager
def plain_ops():
    """Route every kernel launch of the model, forward and backward, to
    its plain version (the reference path on the card). The autograd
    Functions stay in place: only what they launch changes."""
    names = ("_conv5_forward", "conv5_kl_fused", "conv5_dgrad_kl",
             "conv5_wgrad_kl", "_pin_forward", "_pin_cuda")
    saved = [getattr(c5, n) for n in names]
    c5._conv5_forward = lambda xk, w, b, kind: c5.conv5_kl_plain(xk, w, b)
    c5.conv5_kl_fused = (lambda xk, w, b, ep, kind="head":
                         c5.conv5_kl_plain(xk, w, b, ep))
    c5.conv5_dgrad_kl = c5.conv5_dgrad_kl_plain
    c5.conv5_wgrad_kl = (lambda xk, gk, kind="head":
                         c5.conv5_wgrad_kl_plain(xk, gk))
    c5._pin_forward = c5.pin_kl_plain
    c5._pin_cuda = c5.pin_kl_plain  # the pin op's CUDA implementation
    saved_hu = hr._hu_resize_d_cuda
    hr._hu_resize_d_cuda = (
        lambda x, out_d, hu_min, hu_max, hu_nan: hr.hu_resize_d_plain(
            x, resize._linear_matrix(x.shape[0], out_d, device=x.device),
            hu_min, hu_max, hu_nan))
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(c5, n, fn)
        hr._hu_resize_d_cuda = saved_hu


def seeded_model(model_cfg):
    """The model of a config's model section, a seeded init with
    non-trivial BN statistics."""
    gen = torch.Generator().manual_seed(0)
    model = build_model(model_cfg, generator=gen)
    for key, val in model.state_dict().items():
        if key.endswith("running_mean"):
            val.copy_(0.1 * torch.randn(val.shape, generator=gen))
        elif key.endswith("running_var"):
            val.copy_(0.5 + torch.rand(val.shape, generator=gen))
    return model


def write_deploy(workdir):
    """model.pt (:func:`seeded_model`) and two manifests in
    ``workdir``: deploy.yaml, and deploy_buckets.yaml with one 128^3 shape
    bucket."""
    model_cfg = Config(LUNG_TPU).dic["model"]
    torch.save(seeded_model(model_cfg).state_dict(),
               os.path.join(workdir, "model.pt"))
    import yaml
    deploy = {"model": "model.stablehlo", "params": "model.pt",
              "transforms": [], "output_op": "argmax",
              "input_shape_ndhwc": [1, EDGE, EDGE, EDGE, 1],
              "model_config": model_cfg}
    for name, extra in (("deploy.yaml", {}), ("deploy_buckets.yaml", {
            "shape_buckets": [[EDGE, EDGE, EDGE]]})):
        with open(os.path.join(workdir, name), "w") as f:
            yaml.dump({"Deploy": {**deploy, **extra}}, f)


def make_predictor(workdir, save, *extra, config="deploy.yaml"):
    return infer.Predictor(infer.parse_args([
        "--config", os.path.join(workdir, config), "--image_path", workdir,
        "--save_dir", os.path.join(workdir, save), "--precision", "bf16",
        "--benchmark", "true", *extra]))


def forward_counts(forwards):
    """The launch counts ``forwards`` eval forwards of V-Net imply."""
    expect = {"conv5_head": 15 * forwards, "conv5_stem_tc": forwards,
              "conv5_fused_epilogue": 16 * forwards, "pin": 8 * forwards}
    expect.update({k: 0 for k in c5.LAUNCHES if k not in expect})
    return expect


def reset_counts():
    c5.reset_launches()
    hr.reset_launches()


def phase_serve(workdir):
    img_dir = os.path.join(workdir, "images")
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    imgs = []
    for i in range(4):
        path = os.path.join(img_dir, "vol{}.npy".format(i))
        np.save(path, (rng.rand(EDGE, EDGE, EDGE) * 1000).astype(np.float32))
        imgs.append(path)
    predictor = make_predictor(workdir, "pred", "--batch_size", str(BATCH))
    check(predictor.model.dtype == torch.bfloat16, "model is not bf16")

    reset_counts()
    saved = predictor.run(imgs)
    torch.cuda.synchronize()
    launches = dict(c5.LAUNCHES)
    expect = forward_counts(1 + len(imgs) // BATCH)  # warm-up + 2 requests
    check(launches == expect, "launch counts {} != expected {}".format(
        launches, expect))
    check(hr.LAUNCHES["hu_resize"] == 0, "hu_resize ran for .npy volumes")

    with torch.inference_mode():
        x = torch.cat([predictor._preprocess(p) for p in imgs[:BATCH]])
        check(x.device.type == "cuda", "preprocessed volumes left the card")
        logits = predictor.model(x)[0]
        with plain_ops():
            logits_plain = predictor.model(x)[0]
        torch.cuda.synchronize()
    check(tuple(logits.shape) == (BATCH, EDGE, EDGE, EDGE, 3)
          and logits.dtype == torch.float32, "logits shape/dtype")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean()
    max_d = (logits - logits_plain).abs().max().item()
    check(agree.item() >= 0.995, "argmax agreement {} < 0.995".format(
        agree.item()))
    for j in range(BATCH):
        pred = np.load(saved[j])
        check(pred.shape == (EDGE,) * 3 and pred.dtype == np.int32,
              "saved prediction shape/dtype")
        check(np.array_equal(pred, logits[j].argmax(-1).cpu().numpy()),
              "saved prediction differs from the logits' argmax")
    def forward():
        with torch.inference_mode():
            predictor.model(x)[0].argmax(-1)

    profile = profile_call(forward)
    inf_s = predictor.timer.stages["inference"]
    emit({"phase": "serve", "volumes": len(imgs), "batch": BATCH,
          "requests": len(inf_s), "ms_per_batch": 1e3 * float(np.mean(inf_s)),
          "ms_per_batch_each": [1e3 * t for t in inf_s],
          "vol_per_s": len(imgs) / float(np.sum(inf_s)),
          "preprocess_ms": 1e3 * float(np.mean(
              predictor.timer.stages["preprocess"])),
          "launches": launches, "max_abs_logit_diff_vs_plain": max_d,
          "argmax_agreement_vs_plain": agree.item(),
          "logit_absmax": logits.abs().max().item(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "profile": profile})
    return launches


def phase_export(workdir):
    """The seeded lung model (``write_deploy``'s weights) through the export
    CLI on the card, then served from the exported manifest (module
    docstring, ``export``)."""
    from medicalseg_torch import export as export_cli
    imgs = sorted(os.path.join(workdir, "images", f)
                  for f in os.listdir(os.path.join(workdir, "images")))
    served = [np.load(os.path.join(workdir, "pred", os.path.basename(p)))
              for p in imgs]  # phase_serve's predictions (rebuilt module)
    out, out_logits = (os.path.join(workdir, d) for d in ("export",
                                                          "export_logits"))
    common = ["--config", LUNG_TPU, "--model_path",
              os.path.join(workdir, "model.pt"), "--input_shape",
              str(BATCH), "1", str(EDGE), str(EDGE), str(EDGE)]
    t0 = time.perf_counter()
    export_cli.main(export_cli.parse_args(common + [
        "--save_dir", out, "--shape_buckets", str(EDGE), str(EDGE),
        str(EDGE)]))
    export_s = time.perf_counter() - t0
    import yaml
    with open(os.path.join(out, "deploy.yaml")) as f:
        manifest = yaml.safe_load(f)["Deploy"]
    check(manifest["model"] == "model.pt2" and manifest["bucket_models"] == {
        "{0}x{0}x{0}".format(EDGE): "model_{0}x{0}x{0}.pt2".format(EDGE)},
          "exported manifest {}".format(manifest))
    manifest.update(shape_buckets=[], bucket_models={})
    with open(os.path.join(out, "deploy_plain.yaml"), "w") as f:
        yaml.dump({"Deploy": manifest}, f)

    packs = [0]
    saved_pack = c5._pack_weights_wg, c5._pack_weights_stem

    def counted(fn):
        def pack(*args, **kw):
            packs[0] += 1
            return fn(*args, **kw)
        return pack

    runs = {}
    c5._pack_weights_wg, c5._pack_weights_stem = map(counted, saved_pack)
    try:
        # plain batches: a warm-up and two requests; buckets: two requests
        for mode, config, forwards in (("plain", "deploy_plain.yaml", 3),
                                       ("buckets", "deploy.yaml", 2)):
            predictor = make_predictor(out, "pred_" + mode, "--batch_size",
                                       str(BATCH), config=config)
            program = (predictor._program if mode == "plain" else None)
            packs[0] = 0
            reset_counts()
            saved = predictor.run(imgs)
            torch.cuda.synchronize()
            launches = dict(c5.LAUNCHES)
            if mode == "buckets":
                program = predictor._bucket_calls[(EDGE,) * 3]
            check(program is not None, mode + ": the .pt2 program did not "
                  "serve")
            expect = forward_counts(forwards)
            check(launches == expect, "{}: launch counts {} != expected "
                  "{}".format(mode, launches, expect))
            # one packing per conv: later forwards find it in the cache
            check(packs[0] == 16, "{}: {} weight packings for {} forwards"
                  .format(mode, packs[0], forwards))
            agree = min(float((np.load(p) == ref).mean())
                        for p, ref in zip(saved, served))
            check(agree >= 0.995, "{}: argmax agreement with the rebuilt "
                  "module {} < 0.995".format(mode, agree))
            inf_s = predictor.timer.stages["inference"]
            runs[mode] = {"launches": launches, "weight_packings": packs[0],
                          "argmax_agreement_vs_rebuilt": agree,
                          "ms_per_batch": 1e3 * float(np.mean(inf_s)),
                          "ms_per_batch_each": [1e3 * t for t in inf_s]}
    finally:
        c5._pack_weights_wg, c5._pack_weights_stem = saved_pack

    # the logits: a program without the argmax against the rebuilt module
    t0 = time.perf_counter()
    export_cli.main(export_cli.parse_args(common + [
        "--save_dir", out_logits, "--without_argmax"]))
    logits_export_s = time.perf_counter() - t0
    module = torch.export.load(os.path.join(out_logits, "model.pt2")).module()
    with torch.inference_mode():
        x = torch.cat([predictor._preprocess(p) for p in imgs[:BATCH]])
        module.load_state_dict({"net." + k: v for k, v in
                                predictor.model.state_dict().items()})
        reset_counts()
        got = module(x)
        torch.cuda.synchronize()
        check(dict(c5.LAUNCHES) == forward_counts(1), "logits program: "
              "launch counts {}".format(dict(c5.LAUNCHES)))
        ref = predictor.model(x)[0]
    check(got.shape == ref.shape and got.dtype == ref.dtype == torch.float32,
          "logits program shape/dtype")
    max_d = (got - ref).abs().max().item()
    emit({"phase": "export", "gpu": smi_line(), "batch": BATCH,
          "input_shape": [BATCH, 1, EDGE, EDGE, EDGE],
          "export_seconds": export_s,
          "logits_export_seconds": logits_export_s,
          "pt2_mb": os.path.getsize(os.path.join(out, "model.pt2")) / 2 ** 20,
          "plain": runs["plain"], "buckets": runs["buckets"],
          "max_abs_logit_diff_vs_rebuilt": max_d,
          "logits_identical": max_d == 0.0})


def raw_scan(shape, seed, device="cuda"):
    """A synthetic CT scan: uniform in [-2000, 1000] with a few NaN, f32,
    made on the card from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=gen, device=device) * 3000.0 - 2000.0
    idx = torch.randint(0, x.numel(), (64,), generator=gen, device=device)
    x.view(-1)[idx] = float("nan")
    return x


def phase_kernels_ingest():
    dev = torch.device("cuda")
    stats = new_stats(("hu_resize",))
    # (shape, out_d, window): the served scan with the default window, and
    # an odd shape with a hu_nan inside the window and both infinities
    cases = [(SCAN, EDGE, (-1200.0, 600.0, -2000.0)),
             ((37, 45, 51), 16, (-1000.0, 400.0, -300.0))]
    for i, (shape, out_d, window) in enumerate(cases):
        x = raw_scan(shape, 10 + i)
        if i == 1:
            x.view(-1)[::97] = float("inf")
            x.view(-1)[5::89] = float("-inf")
        d, h, w = shape
        wmat = resize._linear_matrix(d, out_d, device=dev)
        got = hr.hu_resize_d(x, out_d, *window)
        torch.cuda.synchronize()
        ref = hr.hu_resize_d_plain(x, wmat, *window)
        err = (got - ref).abs().max().item()
        check(tuple(got.shape) == (out_d, h, w) and
              got.dtype == torch.float32, "hu_resize shape/dtype")
        check(bool(torch.isfinite(got).all()), "hu_resize: non-finite output")
        check(err <= HU_TOL, "hu_resize {} -> {} disagrees with its plain "
              "version: max |d| {}".format(shape, out_d, err))
        size = (out_d, max(1, h // 4), max(1, w // 4))
        full = hr.hu_norm_resize(x, size, *window)
        comp = resize.resize3d(intensity.hu_norm(x, *window), size, order=1)
        full_err = (full - comp).abs().max().item()
        check(full_err <= HU_TOL, "hu_norm_resize {} -> {} disagrees with "
              "resize3d(hu_norm(x)): max |d| {}".format(shape, size,
                                                        full_err))
        ms = time_ms(lambda: hr.hu_resize_d(x, out_d, *window))
        plain = time_ms(lambda: hr.hu_resize_d_plain(x, wmat, *window))
        flat = x.reshape(d, h * w)
        lib = time_ms(lambda: torch.mm(wmat, intensity.hu_window(
            flat, *window)))
        hw_ms = time_ms(lambda: resize.resize3d(got, size, order=1))
        bound = 4.0 * (d + out_d) * h * w / PEAK_BYTES * 1e3
        emit({"phase": "kernels_ingest", "shape": list(shape),
              "out_d": out_d, "window": list(window), "err": err,
              "hu_norm_resize_size": list(size),
              "hu_norm_resize_err": full_err, "ms": ms, "plain_ms": plain,
              "library_ms": lib, "bound_ms": bound, "bound_by": "bytes",
              "hw_passes_ms": hw_ms,
              "gb_per_s": 4.0 * (d + out_d) * h * w / ms / 1e6})
        if i == 0:  # the main path's shape
            stats["hu_resize"]["err"] = err
            add_stats(stats, "hu_resize", 1, ms, plain, bound, "bytes", lib)
        else:
            stats["hu_resize"]["err"] = max(stats["hu_resize"]["err"], err)
        del x, got, ref, full, comp, flat
    return stats


def phase_serve_raw(workdir):
    """Returns (launches of the run, path of one big scan)."""
    scan_dir = os.path.join(workdir, "scans")
    os.makedirs(scan_dir)
    t0 = time.perf_counter()
    scans = []
    for i in range(2):
        scans.append(os.path.join(scan_dir, "ct{}.nii".format(i)))
        medio.write_image(scans[-1], raw_scan(SCAN, 20 + i).cpu().numpy(),
                          spacing=(0.7, 0.7, 1.5))
    # the other readers, at a small size (gzip of a full scan would take
    # most of the script's time)
    for i, name in enumerate(("ct2.nii.gz", "ct3.mha")):
        scans.append(os.path.join(scan_dir, name))
        medio.write_image(scans[-1], np.nan_to_num(raw_scan(
            (40, 96, 80), 30 + i).cpu().numpy()).astype(np.int16))
    write_s = time.perf_counter() - t0
    predictor = make_predictor(workdir, "pred_raw", "--batch_size",
                               str(BATCH))

    reset_counts()
    saved = predictor.run(scans)
    torch.cuda.synchronize()
    launches = dict(c5.LAUNCHES, **hr.LAUNCHES)
    expect = forward_counts(1 + len(scans) // BATCH)
    expect["hu_resize"] = len(scans)  # once per volume
    check(launches == expect, "launch counts {} != expected {}".format(
        launches, expect))

    # the same requests through the plain versions: plain HU resize, plain
    # convs and pins
    agree = []
    with torch.inference_mode(), plain_ops():
        reset_counts()
        for j, path in enumerate(scans):
            logits = predictor.model(predictor._preprocess(path))[0][0]
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            pred = np.load(saved[j])
            check(pred.shape == (EDGE,) * 3 and pred.dtype == np.int32,
                  "saved prediction shape/dtype")
            agree.append((torch.from_numpy(pred).to(logits.device) ==
                          logits.argmax(-1)).float().mean().item())
        check(not any(c5.LAUNCHES.values()) and not any(hr.LAUNCHES.values()),
              "the plain path launched a kernel")
    check(min(agree) >= 0.995, "argmax agreement with the plain-version "
          "path {} < 0.995".format(agree))

    # the preprocess stages of one big scan, each on its own
    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    size = (EDGE,) * 3
    data, read_ms = host_ms(lambda: medio.read_image(scans[0])[0].astype(
        np.float32))
    raw, upload_ms = host_ms(lambda: torch.from_numpy(data).to("cuda"))
    reduced, kernel_ms = timed_once(lambda: hr.hu_resize_d(raw, EDGE))
    small, hw_ms = timed_once(lambda: resize.resize3d(reduced, size))
    _, scale_ms = timed_once(lambda: intensity.scale_by_max(small))
    pre = predictor.timer.stages["preprocess"]
    inf_s = predictor.timer.stages["inference"]
    emit({"phase": "serve_raw", "scans": [list(SCAN)] * 2 + [[40, 96, 80]] * 2,
          "files": [os.path.basename(p) for p in scans],
          "file_mb": os.path.getsize(scans[0]) / 2 ** 20,
          "write_seconds": write_s, "batch": BATCH,
          "preprocess_ms_per_batch": [1e3 * t for t in pre],
          "preprocess_ms_per_big_scan": 1e3 * pre[0] / BATCH,
          "stage_ms": {"read_cast": read_ms, "upload": upload_ms,
                       "kernel": kernel_ms, "hw_passes": hw_ms,
                       "scale_by_max": scale_ms},
          "ms_per_batch_each": [1e3 * t for t in inf_s],
          "big_scan_vol_per_s": BATCH / (pre[0] + inf_s[0]),
          "launches": launches, "argmax_agreement_vs_plain": agree})
    return launches, scans[0]


def phase_prep(workdir):
    """The lung recipe of the port's prep tools on raw scans, on the card
    and with the host backend (module docstring, ``prep``)."""
    from medicalseg_torch.tools import preprocess_utils as pu
    from medicalseg_torch.tools import prepare_lung_coronavirus as lung
    root = os.path.join(workdir, "prep")
    raw = os.path.join(root, "lung_coronavirus_raw")
    os.makedirs(os.path.join(raw, "20_ncov_scan"))
    os.makedirs(os.path.join(raw, "lung_mask"))
    t0 = time.perf_counter()
    for i in range(PREP_SCANS):
        name = "coronacases_org_00{}.nii".format(i + 1)
        medio.write_image(os.path.join(raw, "20_ncov_scan", name),
                          np.nan_to_num(raw_scan(SCAN, 40 + i).cpu().numpy())
                          .astype(np.int16), spacing=(0.7, 0.7, 1.5))
        medio.write_image(os.path.join(raw, "lung_mask", name.replace(
            "_org_", "_")), np.random.RandomState(50 + i).randint(
                0, 3, SCAN).astype(np.int16), spacing=(0.7, 0.7, 1.5))
    write_s = time.perf_counter() - t0
    prep = lung.Prep_lung_coronavirus(dataset_root=root)
    check(len(prep.image_files) == len(prep.label_files) == PREP_SCANS,
          "prep: raw files {} / {}".format(prep.image_files,
                                           prep.label_files))
    prep.generate_dataset_json(
        modalities=("CT",), labels={0: "background", 1: "lung",
                                    2: "infection"},
        dataset_name="COVID-19 CT scans")
    phase_dir = os.path.normpath(prep.phase_path)
    seconds, outs = {}, {}
    saved = pu.use_device(), pu.global_var["device"]
    try:
        for backend, on in (("gpu", True), ("cpu", False)):
            pu.set_use_device(on)
            pu.set_device("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep.load_save(preprocess=prep.preprocess)
            torch.cuda.synchronize()
            seconds[backend] = time.perf_counter() - t0
            prep.generate_txt()
            os.rename(phase_dir, phase_dir + "_" + backend)
            os.makedirs(prep.image_path)
            os.makedirs(prep.label_path)
            outs[backend] = phase_dir + "_" + backend
    finally:
        pu.set_use_device(saved[0])
        pu.set_device(saved[1])
    img_err, label_diff = 0.0, 0
    for sub in ("images", "labels"):
        names = sorted(os.listdir(os.path.join(outs["gpu"], sub)))
        check(names == sorted(os.listdir(os.path.join(outs["cpu"], sub)))
              and len(names) == PREP_SCANS, "prep: {} {}".format(sub, names))
        for name in names:
            got, ref = (np.load(os.path.join(outs[b], sub, name))
                        for b in ("gpu", "cpu"))
            check(got.shape == ref.shape == (EDGE,) * 3 and got.dtype ==
                  ref.dtype == (np.float32 if sub == "images" else np.int32),
                  "prep: {} {} {} {}".format(name, got.shape, got.dtype,
                                             ref.dtype))
            if sub == "images":
                check(bool(np.isfinite(got).all()), "prep: non-finite image")
                img_err = max(img_err, float(np.abs(got - ref).max()))
            else:
                label_diff += int((got != ref).sum())
    for txt in ("train_list.txt", "val_list.txt"):
        check(open(os.path.join(outs["gpu"], txt)).read() == open(
            os.path.join(outs["cpu"], txt)).read(), "prep: " + txt)
    check(img_err <= PREP_TOL, "prep: images on the card differ from the "
          "host backend's by {} > {}".format(img_err, PREP_TOL))
    check(label_diff == 0, "prep: {} label voxels differ".format(label_diff))
    emit({"phase": "prep", "gpu": smi_line(), "scans": PREP_SCANS,
          "scan": list(SCAN), "recipe": "lung: HUnorm + resample to 128^3 "
          "(labels order 0)", "write_seconds": write_s,
          "seconds_per_scan": {b: t / PREP_SCANS for b, t in seconds.items()},
          "max_abs_image_diff_vs_cpu": img_err,
          "label_voxels_differing": label_diff})


def phase_serve_swl(workdir, scan):
    # ---- one scan at native resolution
    predictor = make_predictor(workdir, "pred_swl", "--use_swl", "true")
    predictor.window_batch = BATCH
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    saved = predictor.run([scan])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(c5.LAUNCHES, **hr.LAUNCHES)
    windows = 2 * 5 * 5
    expect = forward_counts(windows // BATCH)
    expect["hu_resize"] = 0  # native resolution: the window only
    check(launches == expect, "sliding-window launch counts {} != expected "
          "{}".format(launches, expect))
    pred = np.load(saved[0])
    check(pred.shape == SCAN and pred.dtype == np.int32,
          "sliding-window prediction shape/dtype")

    roi = (EDGE,) * 3
    vol = predictor._preprocess(scan)[0]  # [D, H, W, 1]
    logits = sliding_window_inference(predictor._model_call, vol, roi, 3,
                                      window_batch=BATCH)
    check(tuple(logits.shape) == SCAN + (3,) and
          logits.dtype == torch.float32, "blended logits shape/dtype")
    check(bool(torch.isfinite(logits).all()), "non-finite blended logits")
    same = (logits.argmax(-1).cpu() == torch.from_numpy(pred)).float().mean()
    check(same.item() >= 0.9999, "saved sliding-window prediction differs "
          "from the blended logits' argmax: {}".format(same.item()))
    del logits
    # a sub-volume that one window covers flush: the blend of one window
    # is the forward itself (where the Gaussian is above the 1e-8 floor of
    # the weight, all but the window's far corners)
    sub = vol[:EDGE, :EDGE, :EDGE].contiguous()
    tiled = sliding_window_inference(predictor._model_call, sub, roi, 3,
                                     window_batch=BATCH)
    with torch.inference_mode():
        direct = predictor.model(sub[None])[0][0]
    inner = gaussian_importance(roi, device=sub.device) >= 1e-8
    sub_err = (tiled - direct)[inner].abs().max().item()
    check(sub_err <= 1e-4 * direct.abs().max().item(), "one flush window "
          "differs from the direct forward by {}".format(sub_err))
    emit({"phase": "serve_swl", "scan": list(SCAN), "roi": list(roi),
          "overlap": 0.25, "windows": windows, "window_batch": BATCH,
          "forwards": windows // BATCH, "seconds": seconds,
          "preprocess_ms": 1e3 * predictor.timer.stages["preprocess"][0],
          "inference_ms": 1e3 * predictor.timer.stages["inference"][0],
          "postprocess_ms": 1e3 * predictor.timer.stages["postprocess"][0],
          "peak_mem_gb": peak, "launches": launches,
          "argmax_same_as_blended_logits": same.item(),
          "flush_window_max_abs_diff": sub_err})
    del vol, sub, tiled, direct, predictor

    # ---- a 96^3 request through the 128^3 bucket
    small = os.path.join(workdir, "small.npy")
    np.save(small, (np.random.RandomState(3).rand(96, 96, 96) * 1000).astype(
        np.float32))
    predictor = make_predictor(workdir, "pred_bucket",
                               config="deploy_buckets.yaml")
    reset_counts()
    out = np.load(predictor.run([small])[0])
    check(dict(c5.LAUNCHES) == forward_counts(1), "bucket launch counts "
          "{}".format(c5.LAUNCHES))
    check(out.shape == (96,) * 3 and out.dtype == np.int32,
          "bucket prediction shape/dtype")
    bucket_ms = 1e3 * predictor.timer.stages["inference"][0]
    with torch.inference_mode():
        x = predictor._preprocess(small)
        padded = F.pad(x, (0, 0) + (0, EDGE - 96) * 3)
        direct = predictor.model(padded)[0][0, :96, :96, :96].argmax(-1)
    bucket_same = (direct.cpu() == torch.from_numpy(out)).float().mean().item()
    check(bucket_same >= 0.9999, "bucketed prediction differs from the "
          "padded forward, cropped: {}".format(bucket_same))

    # ---- an int8 request against bf16 serving
    full = os.path.join(workdir, "images", "vol0.npy")
    bf16 = np.load(make_predictor(workdir, "pred_bf16").run([full])[0])
    predictor = make_predictor(workdir, "pred_int8", "--precision", "int8")
    weights = {k: v for k, v in predictor._qstate.items()
               if k.endswith(".weight.__quant__")}
    check(len(weights) == 24 and all(
        v.dtype == torch.int8 and v.device.type == "cuda"
        for v in weights.values()), "int8 serving does not hold its conv "
        "weights as int8 on the card")
    check(all(p.is_meta for p in predictor.model.parameters()),
          "int8 serving keeps float weights")
    reset_counts()
    int8 = np.load(predictor.run([full])[0])
    check(dict(c5.LAUNCHES) == forward_counts(2), "int8 launch counts "
          "{}".format(c5.LAUNCHES))
    int8_agree = float((int8 == bf16).mean())
    check(int8_agree >= INT8_AGREE, "int8 argmax agreement with bf16 {} < "
          "{}".format(int8_agree, INT8_AGREE))
    emit({"phase": "serve_modes", "bucket": [EDGE] * 3,
          "bucket_request": [96] * 3,
          "bucket_same_as_padded_forward": bucket_same,
          "bucket_ms": bucket_ms,
          "int8_weights": len(weights),
          "int8_weight_mb": sum(v.numel() for v in weights.values()) / 2 ** 20,
          "int8_argmax_agreement_vs_bf16": int8_agree,
          "int8_ms_per_batch": 1e3 * predictor.timer.stages["inference"][0]})


def grad_rel_l2(grads, ref_grads):
    """{leaf: ||g - ref|| / ||ref||}. The bias of a conv that feeds a
    BatchNorm has a zero gradient up to rounding (the batch mean removes
    it), so its error is held relative to the gradient of its conv's
    weight."""
    rels = {}
    for name, gp in ref_grads.items():
        scale = gp.norm()
        if name.endswith(("conv1.bias", "down_conv.bias", "up_conv.bias")):
            scale = ref_grads[name[:-4] + "weight"].norm()
        rels[name] = ((grads[name] - gp).norm() /
                      scale.clamp_min(1e-30)).item()
    return rels


def phase_train():
    cfg = Config(LUNG_TPU)
    check(cfg.dic["model"]["remat"] is True and
          cfg.dic["model"]["dtype"] == "bfloat16", "lung config changed")
    dev = torch.device("cuda")
    rng = np.random.RandomState(TRAIN_SEED)
    images = torch.from_numpy(
        rng.rand(BATCH, EDGE, EDGE, EDGE, 1).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 3, (BATCH, EDGE, EDGE, EDGE)).astype(np.uint8)).to(dev)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(cfg.dic["model"], generator=torch.Generator(
        ).manual_seed(TRAIN_SEED))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state):
        """One step on the batch with the same dropout masks every time;
        returns (loss, ms on the host clock, synchronized)."""
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    state = new_state()
    model = state.model
    check(model.dtype == torch.bfloat16 and model.remat, "model is not the "
          "bf16 remat model of the config")
    start = copy.deepcopy(model.state_dict())

    # step 1 (warm-up): gradients on every parameter
    torch.cuda.reset_peak_memory_stats()
    loss1, warm_ms = run(state)
    peak_remat = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = {}
    for name, p in model.named_parameters():
        check(p.grad is not None, name + " has no gradient")
        check(bool(torch.isfinite(p.grad).all()), name + ": non-finite "
              "gradient")
        check(p.grad.abs().sum().item() > 0, name + ": zero gradient")
        grads[name] = p.grad.float().clone()

    # the same step through the plain versions, from the same state
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss1_plain, plain_ms = run(ref)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    ref_grads = {n: p.grad.float() for n, p in ref.model.named_parameters()}
    rels = grad_rel_l2(grads, ref_grads)
    worst = max(rels.items(), key=lambda kv: kv[1])
    rel_sorted = sorted(rels.values())
    check(abs(loss1 - loss1_plain) <= LOSS_REL * abs(loss1_plain),
          "step-1 loss {} vs plain path {}".format(loss1, loss1_plain))
    check(worst[1] <= GRAD_REL_L2, "gradient of {} differs from the plain "
          "path's by {} relative L2".format(*worst))
    del ref, grads, ref_grads

    # the same comparison in f32 at 64^3, where rounding leaves it power
    f32 = {}
    for path in ("kernel", "plain"):
        st32 = TrainState.create(
            build_model(cfg.dic["model"], dtype=torch.float32,
                        generator=torch.Generator().manual_seed(TRAIN_SEED)),
            cfg.build_optimizer, cfg.lr_scheduler, seed=TRAIN_SEED)
        with (plain_ops() if path == "plain" else contextlib.nullcontext()):
            _, metrics = step(st32, images[:, :64, :64, :64],
                              labels[:, :64, :64, :64])
        f32[path] = (metrics["loss"].item(), {
            n: p.grad.clone() for n, p in st32.model.named_parameters()})
        del st32
    rels32 = grad_rel_l2(f32["kernel"][1], f32["plain"][1])
    worst32 = max(rels32.items(), key=lambda kv: kv[1])
    check(abs(f32["kernel"][0] - f32["plain"][0]) <= 1e-5 * f32["plain"][0],
          "f32 step-1 loss {} vs plain path {}".format(f32["kernel"][0],
                                                       f32["plain"][0]))
    check(worst32[1] <= GRAD_REL_L2_F32, "f32 gradient of {} differs from "
          "the plain path's by {} relative L2".format(*worst32))
    del f32

    # one more untimed step (the comparisons above emptied the caching
    # allocator's pools), then three timed steps, the counts set to 0 just
    # before them
    loss2, _ = run(state)
    c5.reset_launches()
    timed = [run(state) for _ in range(3)]
    launches = dict(c5.LAUNCHES)
    losses = [loss1, loss2] + [l for l, _ in timed]
    step_ms = [ms for _, ms in timed]
    check(all(np.isfinite(losses)), "non-finite loss: {}".format(losses))
    check(losses[-1] < losses[0], "the loss did not fall: {}".format(losses))
    fwd = 2  # remat: each block's forward runs again in the backward
    expect = {"conv5_head": 3 * fwd * 15, "conv5_stem": 0,
              "conv5_stem_tc": 3 * fwd,
              "conv5_fused_epilogue": 0, "conv5_dgrad": 3 * 15,
              "conv5_wgrad_stem": 0, "conv5_wgrad_stem_tc": 3,
              "conv5_wgrad_head": 0,
              "conv5_wgrad_head_tma": 3, "conv5_wgrad_mid": 0,
              "conv5_wgrad_tma": 3 * 14}
    got = {k: launches[k] for k in expect}
    check(got == expect, "launch counts {} != expected {}".format(
        got, expect))
    # pins: the 8 up/down conv outputs of each forward run; no cotangent
    # of the backward arrives non-contiguous
    check(launches["pin"] == 3 * fwd * 8, "pin launches {} != expected "
          "{}".format(launches["pin"], 3 * fwd * 8))

    profile = profile_call(lambda: run(state))

    # the same step without remat: time and peak memory
    model.remat = False
    run(state)
    torch.cuda.reset_peak_memory_stats()
    _, ms_no_remat = run(state)
    peak_no_remat = torch.cuda.max_memory_allocated() / 2 ** 30
    model.remat = True

    mean_ms = float(np.median(step_ms))
    emit({"phase": "train", "batch": BATCH, "edge": EDGE, "dtype": "bfloat16",
          "remat": True, "steps": len(losses), "losses": losses,
          "loss_step1_plain_path": loss1_plain,
          "worst_grad_rel_l2_vs_plain": list(worst),
          "f32_64_worst_grad_rel_l2_vs_plain": list(worst32),
          "median_grad_rel_l2_vs_plain": rel_sorted[len(rel_sorted) // 2],
          "lr": [state.schedule(i) for i in range(len(losses))],
          "ms_per_step": mean_ms, "ms_per_step_each": step_ms,
          "patches_per_s": BATCH / mean_ms * 1e3, "warmup_step_ms": warm_ms,
          "plain_path_step_ms": plain_ms,
          "ms_per_step_no_remat": ms_no_remat,
          "peak_mem_gb_remat": peak_remat,
          "peak_mem_gb_no_remat": peak_no_remat,
          "launches": launches, "profile": profile})
    return launches


@contextlib.contextmanager
def old_f32_kernels(stems_only=False):
    """Route every f32 conv to the CUDA-core kernels the split-TF32
    kernels replaced (``conv5_kernel`` forward and input gradient,
    ``wgrad_kernel``; ``stems_only``: the stem's forward and weight
    gradient alone), to time both in one process."""
    form, wform = c5.conv5_form, c5.conv5_wgrad_form

    def old_form(xk, co, kind):
        f = form(xk, co, kind)
        if f == "stem_tf32":
            return "stem"
        return "head" if f == "head_tf32" and not stems_only else f

    def old_wform(xk, gk, kind):
        f = wform(xk, gk, kind)
        if f == "stem_tf32":
            return "stem"
        if f == "tf32" and not stems_only:
            return "head" if gk.shape[2] <= 16 else "mid"
        return f

    c5.conv5_form, c5.conv5_wgrad_form = old_form, old_wform
    try:
        yield
    finally:
        c5.conv5_form, c5.conv5_wgrad_form = form, wform


def f32_step_counts(steps, old=None):
    """The launch counts ``steps`` steps of the f32 lung V-Net imply (no
    remat): 15 head convs, their 15 input gradients and 15 weight
    gradients on the split-TF32 kernels, the stem's forward and weight
    gradient on the split-TF32 stem kernels, 8 pins a forward, nothing
    else. ``old='stems'``: the stem on the CUDA-core kernels; ``old='all'``:
    every conv on them (out_tr's weight gradient as the narrow head)."""
    expect = {k: 0 for k in c5.LAUNCHES}
    per = ({"conv5_head": 15, "conv5_dgrad": 15, "conv5_wgrad_mid": 14,
            "conv5_wgrad_head": 1} if old == "all" else
           {"conv5_head_tf32": 15, "conv5_dgrad_tf32": 15,
            "conv5_wgrad_tf32": 15})
    per.update({"conv5_stem_tf32": 1, "conv5_wgrad_stem_tf32": 1}
               if old is None else {"conv5_stem": 1, "conv5_wgrad_stem": 1})
    per["pin"] = 8
    expect.update({k: steps * v for k, v in per.items()})
    return expect


def phase_train_f32():
    """The upstream f32 lung recipe at 2 x 128^3 (module docstring)."""
    cfg = Config(LUNG_F32)
    dev = torch.device("cuda")
    rng = np.random.RandomState(TRAIN_SEED)
    images = torch.from_numpy(
        rng.rand(BATCH, EDGE, EDGE, EDGE, 1).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 3, (BATCH, EDGE, EDGE, EDGE)).astype(np.uint8)).to(dev)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(cfg.dic["model"], generator=torch.Generator(
        ).manual_seed(TRAIN_SEED))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state):
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    state = new_state()
    model = state.model
    check(type(model).__name__ == "VNet" and model.dtype == torch.float32
          and not model.remat and cfg.dic["model"]["num_classes"] == 3,
          "the f32 lung recipe's model is not VNet, float32, no remat, 3 "
          "classes")
    start = copy.deepcopy(model.state_dict())

    # step 1 against the plain path from the same state and masks
    loss1, _ = run(state)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss1_plain, plain_ms = run(ref)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    rels = grad_rel_l2(grads, {n: p.grad for n, p in
                               ref.model.named_parameters()})
    worst = max(rels.items(), key=lambda kv: kv[1])
    check(abs(loss1 - loss1_plain) <= 1e-5 * abs(loss1_plain),
          "f32 step-1 loss {} vs plain path {}".format(loss1, loss1_plain))
    check(worst[1] <= GRAD_REL_L2_F32, "f32 gradient of {} differs from the "
          "plain path's by {} relative L2".format(*worst))
    del ref, grads

    def timed(old):
        """One untimed step, then three timed ones with the counts set to 0
        just before them (exact), their peak memory and one profiled step;
        ``old``: None, 'stems' or 'all' (:func:`f32_step_counts`)."""
        with (old_f32_kernels(old == "stems") if old else
              contextlib.nullcontext()):
            loss_w, _ = run(state)
            torch.cuda.reset_peak_memory_stats()
            c5.reset_launches()
            steps = [run(state) for _ in range(3)]
            launches = dict(c5.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check(launches == f32_step_counts(3, old), "f32 step launch "
                  "counts ({} kernels) {} != expected {}".format(
                      old or "new", launches, f32_step_counts(3, old)))
            profile = counted_profile(lambda: run(state))
        return launches, {"losses": [loss_w] + [l for l, _ in steps],
                "ms_per_step": float(np.median([ms for _, ms in steps])),
                "ms_per_step_each": [ms for _, ms in steps],
                "device_ms": profile["device_busy_ms"],
                "idle_share": profile["idle_share"], "peak_mem_gb": peak,
                "launches_per_step": {k: v // 3 for k, v in launches.items()
                                      if v},
                "device_ms_by_kernel": profile["device_ms_by_kernel"],
                "stems_device_ms": (stems_ms(profile, old == "stems")
                                    if old != "all" else None),
                "trace_windows": profile["trace_windows"],
                "trace_whole": profile["whole"],
                "trace_counts": None if profile["whole"] else [
                    profile["hand_counts"], profile["counted"]]}

    launches, new = timed(None)
    losses = [loss1] + new["losses"]
    check(all(np.isfinite(losses)), "non-finite f32 loss: {}".format(losses))
    check(losses[-1] < losses[0], "the f32 loss did not fall: {}".format(
        losses))
    _, old_stems = timed("stems")
    _, old = timed("all")
    for run_ in (old_stems, old):
        check(all(np.isfinite(run_["losses"])), "non-finite f32 loss on the "
              "old kernels: {}".format(run_["losses"]))
    emit({"phase": "train_f32", "config": os.path.relpath(LUNG_F32, ROOT),
          "batch": BATCH, "edge": EDGE, "dtype": "float32", "remat": False,
          "losses": losses, "loss_step1_plain_path": loss1_plain,
          "worst_grad_rel_l2_vs_plain": list(worst),
          "plain_path_step_ms": plain_ms, "new": new, "old_stems": old_stems,
          "old": old,
          "old_stems_over_new_ms": old_stems["ms_per_step"] /
          new["ms_per_step"],
          "old_stems_minus_new_device_ms": minus(
              old_stems["stems_device_ms"], new["stems_device_ms"]),
          "old_over_new_ms": old["ms_per_step"] / new["ms_per_step"],
          "nvidia_smi": smi_line()})
    return launches


@contextlib.contextmanager
def old_ragged_kernels():
    """Route every bf16 weight gradient of a view a tensor copy cannot
    describe to ``wgrad_mma_kernel`` (the kernel the software producer of
    ``csrc/conv5_wgrad_tma.cu`` replaced), to time both in one process."""
    wform = c5.conv5_wgrad_form

    def old_wform(xk, gk, kind):
        f = wform(xk, gk, kind)
        return {"ragged": "mid", "head_ragged": "head"}.get(f, f)

    c5.conv5_wgrad_form = old_wform
    try:
        yield
    finally:
        c5.conv5_wgrad_form = wform


def spine_step_counts(steps, old=False):
    """The launch counts ``steps`` steps of the bf16 spine V-Net imply, pins
    apart (remat runs each block's forward twice): 15 head forwards and the
    stem's, 15 input gradients; the stem's weight gradient on
    ``stem_wgrad_tc_kernel``, the four at W = 8 on the tensor copy and the
    eleven at W = 12, 9, 4 and 2 (out_tr's 32 -> 20 among them) on the
    software producer (``old``: ``wgrad_mma_kernel<4>``)."""
    expect = {k: 0 for k in c5.LAUNCHES if k != "pin"}
    per = {"conv5_head": 2 * 15, "conv5_stem_tc": 2, "conv5_dgrad": 15,
           "conv5_wgrad_stem_tc": 1, "conv5_wgrad_tma": 4,
           "conv5_wgrad_mid" if old else "conv5_wgrad_ragged": 11}
    expect.update({k: steps * v for k, v in per.items()})
    return expect


def profile_trace(fn, lead=False):
    """:func:`profile_call`'s figures for one call of ``fn``, and the
    device time by category and the top kernels as
    ``medicalseg_torch.tools.trace_ops`` reads them from the Chrome trace
    of the same window."""
    prof, wall_ms = profiled(fn, lead)
    stats = profile_stats(prof, wall_ms)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        path = os.path.join(wd, "trace.json")
        prof.export_chrome_trace(path)
        read = trace_ops.summarize(path)
    stats["categories"] = read["categories"]
    stats["top_kernels"] = [[k[:100]] + v for k, v in list(
        read["kernels"].items())[:12]]
    return stats


def phase_train_spine():
    """The repo's bf16 spine recipe (``SPINE_TPU``: VNet, 20 classes, bf16,
    remat, VALID down convs over W) built by ``Config`` at its batch of 3
    on a seeded [3, 512, 512, 12, 1] batch with labels in [0, 20), the
    step only: step 1 against the plain path from the same state and
    masks (loss within ``LOSS_REL``, every leaf within ``GRAD_REL_L2``),
    then one untimed and three timed steps with the counts set to 0 just
    before them (exact, :func:`spine_step_counts`; at least 8 pins a
    forward) and one profiled step, first on the routed kernels, then with
    ``wgrad_mma_kernel`` forced in the same process; the loss falls."""
    cfg = Config(SPINE_TPU)
    mc = cfg.dic["model"]
    check(mc["type"] == "VNet" and mc["dtype"] == "bfloat16" and
          mc["remat"] is True and mc["num_classes"] == 20 and
          cfg.batch_size == 3 and mc["kernel_size"][0] == [2, 2, 4] and
          mc["stride_size"][0] == [2, 2, 1], "spine recipe changed")
    batch, classes = cfg.batch_size, mc["num_classes"]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    images = torch.rand((batch,) + SPINE_VOLUME + (1,), generator=gen,
                        device=dev)
    labels = torch.randint(0, classes, (batch,) + SPINE_VOLUME,
                           generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(mc, generator=torch.Generator().manual_seed(
            TRAIN_SEED))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state):
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    state = new_state()
    model = state.model
    check(type(model).__name__ == "VNet" and model.dtype == torch.bfloat16
          and model.remat, "the spine recipe's model is not the bf16 remat "
          "VNet")
    start = copy.deepcopy(model.state_dict())

    # step 1 against the plain path from the same state and masks
    loss1, _ = run(state)
    grads = {}
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and
              p.grad.abs().sum().item() > 0, name + ": no finite, non-zero "
              "gradient")
        grads[name] = p.grad.float().clone()
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss1_plain, plain_ms = run(ref)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    rels = grad_rel_l2(grads, {n: p.grad.float() for n, p in
                               ref.model.named_parameters()})
    worst = max(rels.items(), key=lambda kv: kv[1])
    rel_sorted = sorted(rels.values())
    check(abs(loss1 - loss1_plain) <= LOSS_REL * abs(loss1_plain),
          "spine step-1 loss {} vs plain path {}".format(loss1, loss1_plain))
    check(worst[1] <= GRAD_REL_L2, "spine gradient of {} differs from the "
          "plain path's by {} relative L2".format(*worst))
    del ref, grads
    torch.cuda.empty_cache()

    def timed(old):
        with (old_ragged_kernels() if old else contextlib.nullcontext()):
            loss_w, _ = run(state)
            torch.cuda.reset_peak_memory_stats()
            c5.reset_launches()
            steps = [run(state) for _ in range(3)]
            launches = dict(c5.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = {k: v for k, v in launches.items() if k != "pin"}
            check(got == spine_step_counts(3, old), "spine step launch "
                  "counts{} {} != expected {}".format(
                      " (old kernels)" if old else "", got,
                      spine_step_counts(3, old)))
            check(launches["pin"] >= 3 * 2 * 8, "spine pin launches {} < "
                  "{}".format(launches["pin"], 3 * 2 * 8))
            profile = profile_trace(lambda: run(state))
        return launches, {
            "losses": [loss_w] + [l for l, _ in steps],
            "ms_per_step": float(np.median([ms for _, ms in steps])),
            "ms_per_step_each": [ms for _, ms in steps],
            "device_ms": profile["device_busy_ms"],
            "idle_share": profile["idle_share"], "peak_mem_gb": peak,
            "launches_per_step": {k: v // 3 for k, v in launches.items()
                                  if v},
            "device_ms_by_category": profile["categories"],
            "top_kernels": profile["top_kernels"]}

    launches, new = timed(False)
    losses = [loss1] + new["losses"]
    check(all(np.isfinite(losses)), "non-finite spine loss: {}".format(
        losses))
    check(losses[-1] < losses[0], "the spine loss did not fall: {}".format(
        losses))
    _, old = timed(True)
    check(all(np.isfinite(old["losses"])), "non-finite spine loss on the "
          "old kernels: {}".format(old["losses"]))
    emit({"phase": "train_spine", "config": os.path.relpath(SPINE_TPU, ROOT),
          "batch": batch, "shape": list(SPINE_VOLUME), "classes": classes,
          "dtype": "bfloat16", "remat": True, "losses": losses,
          "loss_step1_plain_path": loss1_plain,
          "worst_grad_rel_l2_vs_plain": list(worst),
          "median_grad_rel_l2_vs_plain": rel_sorted[len(rel_sorted) // 2],
          "plain_path_step_ms": plain_ms, "new": new, "old": old,
          "old_over_new_ms": old["ms_per_step"] / new["ms_per_step"],
          "nvidia_smi": smi_line()})
    return launches


def spine_f32_step_counts(steps, old_stems=False):
    """The launch counts ``steps`` steps of the f32 spine V-Net imply, pins
    apart (no remat): 15 head forwards, 15 input gradients and 15 weight
    gradients on the split-TF32 head kernels at W = 12, 9, 8, 4 and 2
    (out_tr's 32 -> 20 among them), the stem's forward and weight gradient
    on the split-TF32 stem kernels (``old_stems``: ``conv5_kernel`` and
    ``wgrad_kernel``)."""
    expect = {k: 0 for k in c5.LAUNCHES if k != "pin"}
    per = {"conv5_head_tf32": 15, "conv5_dgrad_tf32": 15,
           "conv5_wgrad_tf32": 15}
    per.update({"conv5_stem": 1, "conv5_wgrad_stem": 1} if old_stems else
               {"conv5_stem_tf32": 1, "conv5_wgrad_stem_tf32": 1})
    expect.update({k: steps * v for k, v in per.items()})
    return expect


def f32_spine_step(cfg, kind):
    """An f32 spine recipe's step at its batch on the seeded [batch, 512,
    512, 12, 1] batch with labels in [0, classes): (new_state, run).
    ``new_state(weights)`` builds the seeded model (its weights replaced
    by ``weights`` where given; fatal unless it is the f32 ``kind``
    without remat) and its train state; ``run(state)`` takes one step, the
    dropout generator re-seeded first: (loss, host ms)."""
    mc = cfg.dic["model"]
    batch, classes = cfg.batch_size, mc["num_classes"]
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    images = torch.rand((batch,) + SPINE_VOLUME + (1,), generator=gen,
                        device=dev)
    labels = torch.randint(0, classes, (batch,) + SPINE_VOLUME,
                           generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(mc, generator=torch.Generator().manual_seed(
            TRAIN_SEED))
        check(type(model).__name__ == kind and model.dtype == torch.float32
              and not model.remat, "the recipe's model is not the f32 {} "
              "without remat".format(kind))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state):
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    return new_state, run


def f32_step1_against_plain(state, new_state, run, start, what):
    """Step 1 of ``state`` (from the weights ``start``) against the plain
    path from the same state and masks: every leaf's gradient finite and
    non-zero, the loss within 1e-5 relative, every leaf within
    ``GRAD_REL_L2_F32``; fatal. Returns {loss1, loss_step1_plain_path,
    plain_path_step_ms, worst_grad_rel_l2_vs_plain,
    median_grad_rel_l2_vs_plain}."""
    loss1, _ = run(state)
    grads = {}
    for name, p in state.model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and
              p.grad.abs().sum().item() > 0, name + ": no finite, non-zero "
              "gradient")
        grads[name] = p.grad.clone()
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss1_plain, plain_ms = run(ref)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    rels = grad_rel_l2(grads, {n: p.grad for n, p in
                               ref.model.named_parameters()})
    worst = max(rels.items(), key=lambda kv: kv[1])
    rel_sorted = sorted(rels.values())
    check(abs(loss1 - loss1_plain) <= 1e-5 * abs(loss1_plain),
          "{} step-1 loss {} vs plain path {}".format(what, loss1,
                                                      loss1_plain))
    check(worst[1] <= GRAD_REL_L2_F32, "{} gradient of {} differs from the "
          "plain path's by {} relative L2".format(what, *worst))
    del ref, grads
    torch.cuda.empty_cache()
    return {"loss1": loss1, "loss_step1_plain_path": loss1_plain,
            "plain_path_step_ms": plain_ms,
            "worst_grad_rel_l2_vs_plain": list(worst),
            "median_grad_rel_l2_vs_plain": rel_sorted[len(rel_sorted) // 2]}


def phase_train_spine_f32():
    """The upstream f32 spine recipe (``SPINE_F32``: VNet, 20 classes,
    float32, no remat, VALID down convs over W, so W runs 12 -> 9 -> 8 -> 4
    -> 2) built by ``Config`` at its batch of 3 on a seeded [3, 512, 512,
    12, 1] batch with labels in [0, 20), the step only: step 1 against the
    plain path from the same state and masks (loss within 1e-5 relative,
    every leaf within ``GRAD_REL_L2_F32``), then one untimed and three
    timed steps with the counts set to 0 just before them (exact,
    :func:`spine_f32_step_counts`; at least 8 pins a step) and one
    profiled step (device time by ``trace_ops`` category), first on the
    routed kernels, then with the stem's CUDA-core kernels forced in the
    same process; the loss falls."""
    cfg = Config(SPINE_F32)
    mc = cfg.dic["model"]
    check(mc["type"] == "VNet" and "dtype" not in mc and
          not mc.get("remat") and mc["num_classes"] == 20 and
          cfg.batch_size == 3 and mc["kernel_size"][0] == [2, 2, 4] and
          mc["stride_size"][0] == [2, 2, 1], "f32 spine recipe changed")
    batch, classes = cfg.batch_size, mc["num_classes"]
    new_state, run = f32_spine_step(cfg, "VNet")
    state = new_state()
    start = copy.deepcopy(state.model.state_dict())
    step1 = f32_step1_against_plain(state, new_state, run, start,
                                    "f32 spine")
    loss1 = step1.pop("loss1")

    def timed(old_stems):
        with (old_f32_kernels(stems_only=True) if old_stems else
              contextlib.nullcontext()):
            loss_w, _ = run(state)
            torch.cuda.reset_peak_memory_stats()
            c5.reset_launches()
            steps = [run(state) for _ in range(3)]
            launches = dict(c5.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = {k: v for k, v in launches.items() if k != "pin"}
            want = spine_f32_step_counts(3, old_stems)
            check(got == want, "f32 spine step launch counts{} {} != "
                  "expected {}".format(" (old stems)" if old_stems else "",
                                       got, want))
            check(launches["pin"] >= 3 * 8, "f32 spine pin launches {} < "
                  "{}".format(launches["pin"], 3 * 8))
            profile = counted_profile(lambda: run(state), profile_trace)
        return launches, {
            "losses": [loss_w] + [l for l, _ in steps],
            "ms_per_step": float(np.median([ms for _, ms in steps])),
            "ms_per_step_each": [ms for _, ms in steps],
            "device_ms": profile["device_busy_ms"],
            "idle_share": profile["idle_share"], "peak_mem_gb": peak,
            "launches_per_step": {k: v // 3 for k, v in launches.items()
                                  if v},
            "device_ms_by_category": profile["categories"],
            "top_kernels": profile["top_kernels"],
            "stems_device_ms": stems_ms(profile, old_stems),
            "trace_windows": profile["trace_windows"],
            "trace_whole": profile["whole"],
            "trace_counts": None if profile["whole"] else [
                profile["hand_counts"], profile["counted"]]}

    launches, new = timed(False)
    losses = [loss1] + new["losses"]
    check(all(np.isfinite(losses)), "non-finite f32 spine loss: {}".format(
        losses))
    check(losses[-1] < losses[0], "the f32 spine loss did not fall: "
          "{}".format(losses))
    _, old = timed(True)
    check(all(np.isfinite(old["losses"])), "non-finite f32 spine loss on "
          "the old stems: {}".format(old["losses"]))
    emit({"phase": "train_spine_f32",
          "config": os.path.relpath(SPINE_F32, ROOT), "batch": batch,
          "shape": list(SPINE_VOLUME), "classes": classes,
          "dtype": "float32", "remat": False, "losses": losses, **step1,
          "new": new, "old_stems": old,
          "old_stems_over_new_ms": old["ms_per_step"] / new["ms_per_step"],
          "old_stems_minus_new_device_ms": minus(
              old["stems_device_ms"], new["stems_device_ms"]),
          "nvidia_smi": smi_line()})
    return launches, new


def f32_forward_counts(forwards):
    """The launch counts ``forwards`` f32 eval forwards of a spine V-Net
    imply (a VNetDeepSup's main output alone): 15 head convs and the stem
    on the split-TF32 kernels, each with its epilogue fused, 8 pins."""
    expect = {k: 0 for k in c5.LAUNCHES}
    expect.update({"conv5_head_tf32": 15 * forwards,
                   "conv5_stem_tf32": forwards,
                   "conv5_fused_epilogue": 16 * forwards,
                   "pin": 8 * forwards})
    return expect


class EvalHeads:
    """Counts the forwards of deep-supervision heads (``ConvHead``) run in
    eval mode, through a global forward hook, while entered; training
    forwards, where the heads feed the losses, are counted apart."""

    def __enter__(self):
        from medicalseg_torch.models.vnet_deepsup import ConvHead
        self.eval = self.train = 0

        def hook(module, inputs, output):
            if isinstance(module, ConvHead):
                if module.training:
                    self.train += 1
                else:
                    self.eval += 1

        self._handle = torch.nn.modules.module.register_module_forward_hook(
            hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def torch_tf32_defaults():
    """PyTorch's own TF32 defaults (cuDNN on, matrix products off), as a
    process that set nothing has them."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_default_steps(state, run, restart):
    """The f32 policy's cost: one step from step 1's start under the
    policy, then one untimed and three timed steps, each from that start,
    under PyTorch's TF32 defaults (:func:`cudnn_tf32`; the matmul flag is
    off in both): the median host ms against the policy's step, and the
    TF32 step's loss and gradients against the policy's."""
    restart()
    loss, strict_ms = run(state)
    strict = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    with cudnn_tf32():
        restart()
        loss_tf32, _ = run(state)
        rels = grad_rel_l2({n: p.grad for n, p in
                            state.model.named_parameters()}, strict)
        steps = []
        for _ in range(3):
            restart()
            steps.append(run(state)[1])
    del strict
    worst = max(rels.items(), key=lambda kv: kv[1])
    ms = float(np.median(steps))
    return {"ms_per_step": ms, "ms_per_step_each": steps,
            "policy_ms_same_call": strict_ms,
            "loss": loss_tf32, "loss_policy": loss,
            "loss_rel_vs_policy": abs(loss_tf32 - loss) / abs(loss),
            "worst_grad_rel_l2_vs_policy": list(worst),
            "median_grad_rel_l2_vs_policy": sorted(
                rels.values())[len(rels) // 2]}


def deepsup_step_part(cfg, vnet):
    """The step of :func:`phase_train_deepsup_spine_f32`: (its line's
    fields, the launches of the three timed steps)."""
    new_state, run = f32_spine_step(cfg, "VNetDeepSup")
    state = new_state()
    model = state.model
    start = copy.deepcopy(model.state_dict())
    opt_start = copy.deepcopy(state.optimizer.state_dict())

    def restart():
        """Step 1's start: weights, BatchNorm statistics, optimizer slots
        (none yet) and step counter."""
        model.load_state_dict(start)
        state.optimizer.load_state_dict(opt_start)
        state.step = 0

    check(sum(n.startswith(("Conv_0.", "Conv_1.", "Conv_2."))
              for n, _ in model.named_parameters()) == 6,
          "the three heads are missing")
    step1 = f32_step1_against_plain(state, new_state, run, start,
                                    "deep-sup f32 spine")
    loss1 = step1.pop("loss1")

    # one untimed and three timed steps, each from step 1's start: the
    # recipe's learning rate of 0.1 diverges within a few steps
    restart()
    loss_w, _ = run(state)
    torch.cuda.reset_peak_memory_stats()
    c5.reset_launches()
    steps = []
    for _ in range(3):
        restart()
        steps.append(run(state))
    launches = dict(c5.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {k: v for k, v in launches.items() if k != "pin"}
    want = spine_f32_step_counts(3)
    check(got == want, "deep-sup f32 spine step launch counts {} != "
          "expected {}".format(got, want))
    check(launches["pin"] >= 3 * 8, "deep-sup f32 spine pin launches {} < "
          "{}".format(launches["pin"], 3 * 8))
    losses = [l for l, _ in steps]
    check(all(np.isfinite(losses)) and
          max(losses) - min(losses) <= REPEAT_LOSS_REL * abs(losses[0]),
          "the timed deep-sup f32 spine steps' losses, each from step 1's "
          "start, are not finite and equal: {}".format(losses))
    profile = counted_profile(
        lambda: run(state),
        lambda fn, lead=False: (restart(), profile_trace(fn, lead))[1])
    new = {"losses": [loss_w] + losses,
           "ms_per_step": float(np.median([ms for _, ms in steps])),
           "ms_per_step_each": [ms for _, ms in steps],
           "device_ms": profile["device_busy_ms"],
           "idle_share": profile["idle_share"], "peak_mem_gb": peak,
           "launches_per_step": {k: v // 3 for k, v in launches.items()
                                 if v},
           "device_ms_by_category": profile["categories"],
           "top_kernels": profile["top_kernels"],
           "trace_windows": profile["trace_windows"],
           "trace_whole": profile["whole"],
           "trace_counts": None if profile["whole"] else [
               profile["hand_counts"], profile["counted"]]}
    new["pytorch_tf32_defaults"] = tf32_default_steps(state, run, restart)
    cats = sorted(set(new["device_ms_by_category"]) |
                  set(vnet["device_ms_by_category"]))
    fields = {
        "losses": [loss1] + new["losses"],
        "timed_losses_bit_equal": len(set(losses)) == 1,
        "timed_losses_equal_step1": losses[0] == loss1, **step1, "new": new,
        "vnet_spine_f32": {k: vnet[k] for k in (
            "ms_per_step", "device_ms", "idle_share", "peak_mem_gb",
            "device_ms_by_category")},
        "over_vnet_ms": new["ms_per_step"] / vnet["ms_per_step"],
        "minus_vnet": {
            "ms": new["ms_per_step"] - vnet["ms_per_step"],
            "device_ms": minus(new["device_ms"], vnet["device_ms"]),
            "peak_mem_gb": peak - vnet["peak_mem_gb"],
            "device_ms_by_category": {c: minus(
                new["device_ms_by_category"].get(c, 0.0),
                vnet["device_ms_by_category"].get(c, 0.0)) for c in cats}}}
    del state, model, start, opt_start
    torch.cuda.empty_cache()
    return fields, launches


def deepsup_eval_part(mc):
    """The eval of :func:`phase_train_deepsup_spine_f32`: its line's
    fields."""
    from medicalseg_torch.core import infer as core_infer
    model = seeded_model(mc).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED + 1)
    vol = torch.rand((1,) + SPINE_VOLUME + (1,), generator=gen,
                     device="cuda")

    def main_call():
        return core_infer.inference(model.main_output, vol)

    def four():
        with torch.inference_mode():
            return model(vol)

    with EvalHeads() as heads:
        main_call()  # warm-up: packed weights
        reset_counts()
        pred, logit = main_call()
        launches = dict(c5.LAUNCHES)
        check(heads.eval == 0, "the eval forward ran {} deep-supervision "
              "head(s)".format(heads.eval))
        # cuDNN's f32 algorithms for the up/down convs need not repeat bit
        # for bit; with deterministic ones the two calls must
        repeat_err = (main_call()[1] - logit).abs().max().item()
        torch.backends.cudnn.deterministic = True
        try:
            main = main_call()[1]
            outs = four()
        finally:
            torch.backends.cudnn.deterministic = False
        check(heads.eval == 3, "the four-output call ran {} heads, not "
              "3".format(heads.eval))
    check(launches == f32_forward_counts(1), "deep-sup eval launch counts "
          "{} != expected {}".format(launches, f32_forward_counts(1)))
    same = torch.equal(outs[0], main)
    check(same, "the main output differs from the four-output forward's "
          "first entry by {} (cuDNN deterministic)".format(
              (outs[0] - main).abs().max().item()))
    check(tuple(logit.shape) == (1,) + SPINE_VOLUME + (mc["num_classes"],)
          and bool(torch.isfinite(logit).all()), "deep-sup eval logits: "
          "shape {} or non-finite".format(tuple(logit.shape)))
    del outs, main
    with plain_ops():
        reset_counts()
        plain_pred, plain_logit = main_call()
        check(not any(c5.LAUNCHES.values()), "the plain eval launched a "
              "kernel: {}".format(c5.LAUNCHES))
    diff = (logit - plain_logit).abs()
    max_abs = diff.max().item()
    scale = plain_logit.abs().max().item()
    check(torch.allclose(logit, plain_logit, atol=EVAL_F32_TOL,
                         rtol=EVAL_F32_TOL), "deep-sup eval logits differ "
          "from the plain path's by {} (|logit| up to {})".format(
              max_abs, scale))
    agree = (plain_pred == pred).float().mean().item()
    check(agree >= 0.995, "deep-sup eval argmax agreement {} < 0.995 with "
          "the plain path".format(agree))
    del plain_pred, plain_logit, diff
    # the f32 policy's cost at eval: the main output under PyTorch's TF32
    # defaults (cudnn_tf32; the matmul flag is off in both)
    with cudnn_tf32():
        main_call()  # warm-up: cuDNN's TF32 algorithms
        (tf32_pred, tf32_logit), tf32_ms = host_ms(main_call, reps=5,
                                                   sync=True)
    tf32 = {"ms": tf32_ms,
            "max_abs_vs_policy": (tf32_logit - logit).abs().max().item(),
            "argmax_agreement_vs_policy": (
                tf32_pred == pred).float().mean().item()}
    del pred, logit, tf32_pred, tf32_logit
    cols = {}
    for tag, call in (("main", main_call), ("four_outputs", four)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, ms = host_ms(call, reps=5, sync=True)
        cols[tag] = {"ms": ms, "peak_gb": (
            torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    del model, vol
    torch.cuda.empty_cache()
    return {"volume": [1] + list(SPINE_VOLUME) + [1],
            "launches": {k: v for k, v in launches.items() if v},
            "main_equals_four_outputs_first_cudnn_deterministic": same,
            "main_repeat_max_abs_cudnn_default": repeat_err,
            "logits_vs_plain": {"max_abs": max_abs,
                                "plain_max_abs_logit": scale,
                                "tol": EVAL_F32_TOL},
            "argmax_agreement_vs_plain": agree,
            "main_ms": cols["main"]["ms"],
            "four_outputs_ms": cols["four_outputs"]["ms"],
            "saved_ms": cols["four_outputs"]["ms"] - cols["main"]["ms"],
            "main_peak_gb": cols["main"]["peak_gb"],
            "four_outputs_peak_gb": cols["four_outputs"]["peak_gb"],
            "saved_peak_gb": (cols["four_outputs"]["peak_gb"] -
                              cols["main"]["peak_gb"]),
            "main_pytorch_tf32_defaults": tf32}


def deepsup_cli_part(mc):
    """The CLI of :func:`phase_train_deepsup_spine_f32`: its line's
    fields."""
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        # the upstream layout, [D, H, W] = [512, 512, 12], in [0, 1) (the
        # range the recipe's prep's intensity normalization leaves)
        write_spine_phase0(wd, SPINE_VOLUME, 1.0)
        cfg = Config(SPINE_DS_F32).dic
        cfg["data_root"] = wd
        for key in ("train_dataset", "val_dataset"):
            cfg[key]["dataset_root"] = "phase0"
            cfg[key]["result_dir"] = "phase1"
        cfg["val_dataset"]["dataset_json_path"] = ""
        yml = os.path.join(wd, "spine_deepsup.yml")
        import yaml
        with open(yml, "w") as f:
            yaml.safe_dump(cfg, f)
        out = os.path.join(wd, "out")
        reset_counts()
        flags = {}
        with EvalHeads() as heads, CachedSteps() as built:
            torch_tf32_defaults()
            flags["before"] = tf32_flags()
            with TrainLog("[TRAIN]", "[EVAL]", "TrainLoader mode") as log:
                t0 = time.perf_counter()
                first = train_cli.main(train_cli.parse_args([
                    "--config", yml, "--iters", "3", "--save_interval", "3",
                    "--log_iters", "1", "--save_dir", out, "--seed",
                    str(TRAIN_SEED), "--do_eval"]))
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            flags["after_train"] = tf32_flags()
            check(first.step == 3 and os.path.isdir(os.path.join(
                out, "iter_3")), "the deep-sup CLI left step {}".format(
                    first.step))
            del first
            torch.cuda.empty_cache()
            train_eval_heads, train_heads = heads.eval, heads.train
            torch_tf32_defaults()
            with TrainLog("[EVAL]") as vlog:
                t0 = time.perf_counter()
                result = val_cli.main(val_cli.parse_args([
                    "--config", yml, "--model_path", os.path.join(
                        out, "iter_3", ckpt.MODEL_FILE), "--save_dir",
                    os.path.join(wd, "val")]))
                torch.cuda.synchronize()
                val_s = time.perf_counter() - t0
            flags["after_val"] = tf32_flags()
        torch.cuda.empty_cache()
    check(flags["before"] == (True, False) and
          flags["after_train"] == flags["after_val"] == (False, False),
          "TF32 flags (cuDNN, matmul) {}: the CLIs did not set the f32 "
          "policy".format(flags))
    check(heads.eval == 0, "the CLIs' evaluations ran {} deep-supervision "
          "head(s)".format(heads.eval))
    launches = dict(c5.LAUNCHES)
    replays = [step.graphed.replays for step in built.steps]
    for step in built.steps:
        for k, v in step.graphed.launches.items():
            launches[k] += (step.graphed.replays - 1) * v
    forwards = 2 * SPINE_CLI_VOLUMES  # --do_eval at 3, then the val CLI
    at_eval = f32_forward_counts(forwards)
    want = {k: v + at_eval[k] for k, v in spine_f32_step_counts(3).items()}
    got = {k: launches[k] for k in want}
    check(got == want, "deep-sup CLI launch counts {} != expected {} (three "
          "steps, {} eval forwards)".format(got, want, forwards))
    check(launches["pin"] >= 3 * 8 + 8 * forwards, "deep-sup CLI pin "
          "launches {} < {}".format(launches["pin"], 3 * 8 + 8 * forwards))
    train_lines = [ln for ln in log.lines if "[TRAIN]" in ln]
    losses = [TrainLog.field(ln, "loss") for ln in train_lines]
    check(len(losses) == 3 and all(np.isfinite(losses)), "deep-sup CLI "
          "losses: {}".format(train_lines))
    evals = [ln for ln in log.lines + vlog.lines if "#Images" in ln]
    check(len(evals) == 2 and np.isfinite(result["mdice"]),
          "deep-sup CLI evaluations: {}".format(evals))
    return {"tf32_flags_cudnn_matmul": flags, "losses": losses,
            "loader": [ln for ln in log.lines if "TrainLoader mode" in ln],
            "graph_replays": replays, "train_heads_forwards": train_heads,
            "eval_heads_forwards": heads.eval,
            "eval_heads_forwards_in_train_cli": train_eval_heads,
            "evals": evals, "val_result": result,
            "train_s": train_s, "val_s": val_s,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_train_deepsup_spine_f32(vnet):
    """The upstream f32 VNetDeepSup spine recipe (``SPINE_DS_F32``:
    VNetDeepSup, 20 classes, float32, no remat, four MixedLoss heads,
    VALID down convs over W, so W runs 12 -> 9 -> 8 -> 4 -> 2 and the
    heads sit at W = 4, 8, 9) built by ``Config`` at its batch of 3 on a
    seeded [3, 512, 512, 12, 1] batch with labels in [0, 20): step 1
    against the plain path from the same state and masks (loss within 1e-5
    relative, every leaf within ``GRAD_REL_L2_F32``, the heads'
    ``Conv_0..2`` finite and non-zero); then one untimed and three timed
    steps, each restarted from step 1's start (the recipe's LR of 0.1
    diverges), with the counts set to 0 just before the timed ones
    (exactly :func:`spine_f32_step_counts`: the heads add no hand kernel;
    at least 8 pins a step), their losses finite and equal, and one
    profiled step whose window holds every counted launch (device ms,
    idle share, ``trace_ops`` categories); beside ``vnet``, the f32 VNet
    spine step of :func:`phase_train_spine_f32` in this process; the same
    step under PyTorch's TF32 defaults (:func:`tf32_default_steps`). Then
    the eval (:func:`deepsup_eval_part`: the recipe's model seeded with
    non-trivial BN statistics on a seeded [1, 512, 512, 12, 1] volume
    through ``core.infer.inference``: exact eval counts, no head run, the
    main output equal to the four-output forward's first entry, the logits
    within ``EVAL_F32_TOL`` of the plain path's and argmax agreement with
    it >= 99.5%, the main output under TF32 defaults, ms and peak of both
    calls) and
    the CLI (:func:`deepsup_cli_part`: from PyTorch's TF32 defaults the
    train CLI, three iterations with ``--do_eval``, and the val CLI on
    ``iter_3``, over four seeded [512, 512, 12] volumes: the flags off
    after each, exact counts, finite losses, no head run at eval)."""
    cfg = Config(SPINE_DS_F32)
    mc = cfg.dic["model"]
    check(mc["type"] == "VNetDeepSup" and "dtype" not in mc and
          not mc.get("remat") and mc["num_classes"] == 20 and
          cfg.batch_size == 3 and mc["kernel_size"][0] == [2, 2, 4] and
          mc["stride_size"][0] == [2, 2, 1] and
          len(cfg.loss["types"]) == 4, "deep-sup f32 spine recipe changed")
    fields, launches = deepsup_step_part(cfg, vnet)
    line = {"phase": "train_deepsup_spine_f32",
            "config": os.path.relpath(SPINE_DS_F32, ROOT),
            "batch": cfg.batch_size, "shape": list(SPINE_VOLUME),
            "classes": mc["num_classes"], "dtype": "float32",
            "remat": False, "lr": cfg.lr_scheduler(0)}
    line.update(fields)
    line["eval"] = deepsup_eval_part(mc)
    line["cli"] = deepsup_cli_part(mc)
    line["nvidia_smi"] = smi_line()
    emit(line)
    return launches


def check_flagship_launches(launches, steps):
    """The flagship step's launch counts over ``steps`` steps: per step,
    remat running each block's forward twice, 15 head convs and the stem
    forward, 15 dgrads, the stem's weight gradient and 15 square / wide
    ones (out_tr's 32 -> 20 among them); 8 pins a forward at least (the
    backward pins a cotangent that arrives in another layout)."""
    fwd = 2
    expect = {"conv5_head": steps * fwd * 15, "conv5_stem": 0,
              "conv5_stem_tc": steps * fwd, "conv5_fused_epilogue": 0,
              "conv5_dgrad": steps * 15, "conv5_wgrad_stem": 0,
              "conv5_wgrad_stem_tc": steps, "conv5_wgrad_head": 0,
              "conv5_wgrad_head_tma": 0, "conv5_wgrad_mid": 0,
              "conv5_wgrad_tma": steps * 15}
    got = {k: launches[k] for k in expect}
    check(got == expect, "flagship launch counts {} != expected {}".format(
        got, expect))
    check(launches["pin"] >= steps * fwd * 8, "pin launches {} < {}".format(
        launches["pin"], steps * fwd * 8))


def recipe_transforms(path):
    """The train transforms a YAML names, built without its dataset."""
    out = []
    for item in Config(path).dic["train_dataset"]["transforms"]:
        item = dict(item)
        out.append(manager.TRANSFORMS[item.pop("type")](**item))
    return out


def phase_augment():
    """Device augmentation (``transforms.DeviceAugmentor``) of the
    flagship recipe (RandomRotation3D(30) + RandomFlip3D, seeded 3 x 12 x
    512 x 512 volumes and labels in [0, 20)), the lung recipe
    (RandomResizedCrop3D(128) + RandomRotation3D(90) + RandomFlip3D on 2 x
    128^3, labels in {0, 1, 2}) and a label-bounded crop (pre_crop with
    nonzero_mask, 2 x 96^3): one sample on the card against the port's CPU
    path at the same parameters (image within ``AUG_TOL``, labels equal
    except at .5 ties of the CPU value before rounding), a batch already on
    the card under ``torch.cuda.set_sync_debug_mode('error')`` (any host
    sync raises), and the time of a batch (CUDA events, median of 5, the
    host's draws included) beside one profiled batch's device time and
    the bound by bytes (inputs and outputs moved once)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    bounded = [RandomResizedCrop3D(size=64, pre_crop=True,
                                   nonzero_mask=True), RandomFlip3D()]
    cases = [("flagship", recipe_transforms(SPINE), (3,) + FLAGSHIP_STEM[1:],
              20),
             ("lung", recipe_transforms(LUNG_TPU), (2, EDGE, EDGE, EDGE), 3),
             ("nonzero_crop", bounded, (2, 96, 96, 96), 3)]
    line = {"phase": "augment"}
    for name, transforms, shape, classes in cases:
        aug = DeviceAugmentor(transforms, seed=TRAIN_SEED)
        images = torch.rand(shape, generator=gen, device=dev) * 255
        labels = torch.randint(0, classes, shape, generator=gen, device=dev)
        if name == "nonzero_crop":  # labels inside a box only
            mask = torch.zeros(shape, dtype=torch.bool, device=dev)
            mask[:, 20:70, 10:50, 30:90] = True
            labels = labels * mask
        # one sample: the card against the CPU at the same parameters
        t0 = time.perf_counter()
        draws = aug.draw(shape[0], 0)
        params = aug.params(draws[0], shape[1:], labels[0])
        host_ms = (time.perf_counter() - t0) * 1e3
        img, lab = aug.apply_one(images[0], labels[0], params)
        cpu_params = aug.params(draws[0], shape[1:], labels[0].cpu())
        if name == "nonzero_crop":  # the window was drawn on the card
            card, host = ([[int(v) for v in g] for g in p[0]]
                          for p in (params, cpu_params))
            check(card == host, "the window on the card {} differs from the "
                  "CPU's {}".format(card, host))
        img_c, lab_c = aug.apply_one(images[0].cpu(), labels[0].cpu(),
                                     cpu_params)
        _, pre = aug.apply_one(images[0].cpu(), labels[0].cpu().float(),
                               cpu_params)
        err = (img.cpu() - img_c).abs().max().item()
        check(err <= AUG_TOL, "{}: augmented image on the card differs from "
              "the CPU's by {}".format(name, err))
        tie = ((pre - pre.floor()) - 0.5).abs() < 1e-4
        wrong = ((lab.cpu() != lab_c) & ~tie).sum().item()
        check(wrong == 0, "{}: {} augmented label voxels differ from the "
              "CPU's away from .5 ties".format(name, wrong))
        # the batch, with any host sync an error; the generator a step
        # hands the augmentor
        step_gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out_img, out_lab = aug(images, labels, step_gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        size = tuple(out_img.shape[1:4])
        check(out_img.shape == (shape[0],) + size + (1,) and
              out_lab.shape == (shape[0],) + size and
              out_lab.dtype == torch.int64, "{}: augmented shapes {} {}".format(
                  name, tuple(out_img.shape), tuple(out_lab.shape)))
        check(bool(torch.isfinite(out_img).all()) and
              0 <= out_img.min().item() and out_img.max().item() <= 1 and
              0 <= out_lab.min().item() and out_lab.max().item() < classes,
              name + ": augmented values out of range")
        ms = time_ms(lambda: aug(images, labels, step_gen))
        prof = profile_call(lambda: aug(images, labels, step_gen))
        # the least time: each input and output read or written once
        moved = sum(t.numel() * t.element_size()
                    for t in (images, labels, out_img, out_lab))
        line[name] = {"shape": list(shape), "out_shape": list(size),
                      "ms_per_batch": ms, "host_draw_ms_per_sample": host_ms,
                      "bound_ms": moved / PEAK_BYTES * 1e3,
                      "device_ms": prof["device_busy_ms"],
                      "idle_share": prof["idle_share"],
                      "device_ms_by_op": prof["device_ms_by_op"][:5],
                      "max_abs_err_vs_cpu": err,
                      "label_ties": int(tie.sum().item()),
                      "sync_free": True, "params_sample0": repr(cpu_params)}
        del images, labels, out_img, out_lab
        torch.cuda.empty_cache()
    emit(line)


class IterationProfile:
    """Wraps ``core.train``'s step builder so that the iteration ending in
    step call ``at`` is profiled: the profiler starts when call ``at - 1``
    has returned and its work is done, and stops when call ``at``'s is.
    The window holds one whole loop iteration: the batch from the
    prefetcher, the draws, the step."""

    def __init__(self, at):
        self.at, self.calls, self.stats = at, 0, None
        self._prof = self._t0 = None
        self._real = _core_train_module().make_train_step

    def __enter__(self):
        real = self._real

        def make(*args, **kwargs):
            inner = real(*args, **kwargs)

            def step(state, images, labels):
                out = inner(state, images, labels)
                self.calls += 1
                if self.calls == self.at - 1:
                    from torch.profiler import ProfilerActivity, profile
                    torch.cuda.synchronize()
                    self._prof = profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA])
                    self._prof.__enter__()
                    self._t0 = time.perf_counter()
                elif self.calls == self.at:
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - self._t0) * 1e3
                    self._prof.__exit__(None, None, None)
                    self.stats = profile_stats(self._prof, wall_ms)
                return out
            return step

        _core_train_module().make_train_step = make
        return self

    def __exit__(self, *exc):
        _core_train_module().make_train_step = self._real


def _core_train_module():
    return sys.modules["medicalseg_torch.core.train"]


class TrainLog(logging.Handler):
    """Collects the lines of the port's logger that hold one of ``tags``
    (``[TRAIN]`` by default), and sends the logger's own output and the
    eval progress bar to stderr meanwhile (stdout carries this script's
    JSON lines)."""

    def __init__(self, *tags):
        super().__init__()
        self.tags = tags or ("[TRAIN]",)
        self.lines = []
        self._logger = logging.getLogger("medicalseg_torch")
        self._stdout = contextlib.redirect_stdout(sys.stderr)

    def emit(self, record):
        msg = record.getMessage()
        if any(tag in msg for tag in self.tags):
            self.lines.append(msg)

    def __enter__(self):
        self._streams = [(h, h.stream) for h in self._logger.handlers
                         if isinstance(h, logging.StreamHandler)]
        for h, _ in self._streams:
            h.setStream(sys.stderr)
        self._logger.addHandler(self)
        self._stdout.__enter__()
        return self

    def __exit__(self, *exc):
        self._stdout.__exit__(*exc)
        self._logger.removeHandler(self)
        for h, stream in self._streams:
            h.setStream(stream)

    @staticmethod
    def field(line, name):
        return float(line.split(name + ": ")[1].split(",")[0].split()[0])


class SaveCalls:
    """Wraps the train loop's two checkpoint writers as ``core.train``
    calls them (``save_checkpoint``, ``save_checkpoint_async``) and keeps
    the host ms each call held the loop."""

    NAMES = ("save_checkpoint", "save_checkpoint_async")

    def __init__(self):
        self.ms = []
        self._real = {n: getattr(_core_train_module(), n) for n in self.NAMES}

    def __enter__(self):
        for name, real in self._real.items():
            def timed(*args, _real=real, **kwargs):
                t0 = time.perf_counter()
                out = _real(*args, **kwargs)
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return out
            setattr(_core_train_module(), name, timed)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(_core_train_module(), name, real)


def _digests(out, iters):
    """{"iter_N/file": sha256} of the checkpoints under ``out``."""
    import hashlib
    found = {}
    for it in iters:
        for name in (ckpt.MODEL_FILE, ckpt.OPT_FILE):
            with open(os.path.join(out, "iter_{}".format(it), name),
                      "rb") as f:
                found["iter_{}/{}".format(it, name)] = hashlib.sha256(
                    f.read()).hexdigest()
    return found


def sync_checkpoint_run(yml, out):
    """``core.train`` as the CLI calls it for the phase's first run (same
    YAML, seed and loader mode, six iterations, saves at 3 and 6), with
    ``async_checkpoint=False``: (the save calls' host ms, the logged
    windows' batch cost in ms)."""
    from medicalseg_torch.utils import seed_all
    seed_all(TRAIN_SEED)
    cfg = Config(yml, iters=6)
    with TrainLog() as log, SaveCalls() as saves:
        state = _core_train_module().train(
            cfg.model, cfg.train_dataset, optimizer=cfg.build_optimizer,
            lr_scheduler=cfg.lr_scheduler, save_dir=out, iters=6,
            batch_size=cfg.batch_size, save_interval=3, log_iters=3,
            losses=cfg.loss, seed=TRAIN_SEED, data_loader_mode="device",
            async_checkpoint=False, device="cuda")
        torch.cuda.synchronize()
    check(state.step == 6 and len(log.lines) == 2 and len(saves.ms) == 2,
          "the synchronous run: step {}, {} windows, {} saves".format(
              state.step, len(log.lines), len(saves.ms)))
    del state
    torch.cuda.empty_cache()
    return saves.ms, [TrainLog.field(ln, "batch_cost") * 1e3
                      for ln in log.lines]


def phase_train_cli():
    """The port's train CLI (``python -m medicalseg_torch.train``, called
    in this process through ``medicalseg_torch.train.main``) on the
    flagship YAML pointed at four seeded 12 x 512 x 512 volumes written
    under ``build/``: six iterations with checkpoints at 3 and 6, then a
    run resumed from ``iter_3`` to 6. The counts are set to 0 before the
    first run and read after the second: every flagship kernel launched,
    exactly as nine steps imply. Both checkpoints load into a new model
    (steps 3 and 6, finite values), every logged loss is finite, and the
    resumed run logs iteration 6 only. The first run's checkpoints,
    written asynchronously, have the bytes of :func:`sync_checkpoint_run`'s,
    and its ``Model forward cost`` line the port's count. Prints the logged
    losses, batch cost (ms per iteration over each window of three) and
    reader cost, one profiled iteration (the second) of the first run:
    device time and idle share, the save calls' host ms both ways beside
    the next window's ms per iteration, and the forward's GFLOPs."""
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        write_spine_phase0(wd)
        cfg = Config(SPINE).dic
        cfg["data_root"] = wd
        for key in ("train_dataset", "val_dataset"):
            cfg[key]["dataset_root"] = "phase0"
            cfg[key]["result_dir"] = "phase1"
        yml = os.path.join(wd, "spine.yml")
        import yaml
        with open(yml, "w") as f:
            yaml.safe_dump(cfg, f)
        out = os.path.join(wd, "out")
        argv = ["--config", yml, "--iters", "6", "--save_interval", "3",
                "--log_iters", "3", "--save_dir", out, "--seed",
                str(TRAIN_SEED), "--loader_mode", "device"]

        reset_counts()
        with TrainLog("[TRAIN]", "TrainLoader mode",
                      "Model forward cost") as log, \
                IterationProfile(at=2) as prof, SaveCalls() as saves:
            t0 = time.perf_counter()
            first = train_cli.main(train_cli.parse_args(argv))
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        reader = [ln for ln in log.lines if "TrainLoader mode" in ln]
        check(len(reader) == 1 and "mode: device " in reader[0] and
              "reader=native" in reader[0], "the CLI's loader did not read "
              "through the native reader: {}".format(reader))
        first_lines = [ln for ln in log.lines if "[TRAIN]" in ln]
        check(first.step == 6 and sorted(os.listdir(out)) ==
              ["iter_3", "iter_6"], "the CLI left {} at step {}".format(
                  sorted(os.listdir(out)), first.step))
        # the forward's cost as the loop logged it, against the count
        gflops = forward_flops(first.model, FLAGSHIP_STEM[1:],
                               FLAGSHIP_STEM[0]) / 1e9
        cost = [ln for ln in log.lines if "Model forward cost" in ln]
        want = "Model forward cost: {:.3f} GFLOPs (batch {})".format(
            gflops, FLAGSHIP_STEM[0])
        check(cost == [want], "forward cost logged {}, counted {}".format(
            cost, want))
        del first
        async_files = _digests(out, (3, 6))  # before the resume rewrites 6
        check(len(saves.ms) == 2, "{} save calls".format(len(saves.ms)))
        with TrainLog() as log:
            t0 = time.perf_counter()
            resumed = train_cli.main(train_cli.parse_args(
                argv + ["--resume_model", os.path.join(out, "iter_3")]))
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
        resumed_lines = log.lines
        launches = dict(c5.LAUNCHES)
        check(resumed.step == 6, "the resumed run ended at step {}".format(
            resumed.step))
        del resumed
        torch.cuda.empty_cache()
        check_flagship_launches(launches, 6 + 3)
        check(len(first_lines) == 2 and len(resumed_lines) == 1 and
              "iter: 6/6" in resumed_lines[0], "logged iterations: {} / "
              "{}".format(first_lines, resumed_lines))
        losses = [TrainLog.field(ln, "loss")
                  for ln in first_lines + resumed_lines]
        check(all(np.isfinite(losses)), "non-finite CLI loss: {}".format(
            losses))
        for it in (3, 6):
            model = build_model(cfg["model"])
            optimizer = torch.optim.SGD(model.parameters(), lr=0.0,
                                        momentum=0.9)
            step = ckpt.load_checkpoint(os.path.join(out, "iter_{}".format(
                it)), model, optimizer)
            check(step == it and all(bool(torch.isfinite(v).all()) for v in
                                     model.state_dict().values()),
                  "iter_{} did not load (step {})".format(it, step))
        sync_out = os.path.join(wd, "out_sync")
        sync_ms, sync_windows = sync_checkpoint_run(yml, sync_out)
        sync_files = _digests(sync_out, (3, 6))
        check(async_files == sync_files, "asynchronous and synchronous "
              "checkpoints differ: {} / {}".format(async_files, sync_files))
        cached = cli_cached(wd, yml)
    windows = [{k: TrainLog.field(ln, k) for k in ("loss", "batch_cost",
                                                    "reader_cost", "ips")}
               for ln in first_lines + resumed_lines]
    checkpoints = {
        "bytes_equal_async_sync": True,
        "save_call_ms": {"async": saves.ms, "sync": sync_ms},
        "next_3_iters_ms_per_iter": {"async": windows[1]["batch_cost"] * 1e3,
                                     "sync": sync_windows[1]}}
    emit({"phase": "train_cli", "config": os.path.relpath(SPINE, ROOT),
          "volumes": 4, "shape": list(FLAGSHIP_STEM[1:]),
          "iters": [6, "resumed 3 -> 6"],
          "windows_iters": ["1-3", "4-6", "4-6 resumed"],
          "windows": windows,
          "ms_per_iter_steady": windows[1]["batch_cost"] * 1e3,
          "reader_cost_ms_steady": windows[1]["reader_cost"] * 1e3,
          "run_s": first_s, "resumed_run_s": resumed_s,
          "loader": reader[0],
          "profiled_iteration": 2,
          "iteration_profile": prof.stats,
          "launches_per_step": {k: v / 9 for k, v in launches.items()},
          "checkpoints": checkpoints,
          "forward_gflops": {"batch": FLAGSHIP_STEM[0], "gflops": gflops,
                             "logged": cost[0]},
          "cached": cached})
    return launches


class CachedSteps:
    """Keeps each cached train step that ``core.train`` builds, so that its
    graph's replays and launches a replay can be read after the run."""

    def __init__(self):
        self.steps = []
        self._real = _core_train_module().make_cached_train_step

    def __enter__(self):
        def make(*args, **kwargs):
            step = self._real(*args, **kwargs)
            self.steps.append(step)
            return step

        _core_train_module().make_cached_train_step = make
        return self

    def __exit__(self, *exc):
        _core_train_module().make_cached_train_step = self._real


class KeptProfilers:
    """Keeps every ``torch.profiler.profile`` made while it is entered (the
    one ``utils/train_profiler.py`` makes for a trace window), so that its
    events can be read after the trace is written."""

    def __enter__(self):
        self.kept, self._real = [], torch.profiler.profile
        kept = self.kept

        class Kept(self._real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                kept.append(self)

        torch.profiler.profile = Kept
        return self

    def __exit__(self, *exc):
        torch.profiler.profile = self._real


TRACE_STEPS = 3  # the cached run's trace window: iterations 4-6, a dispatch
TRACE_BUSY_REL = 5e-2  # the reader's busy ms against key_averages'


def cli_cached(wd, yml):
    """The train CLI on the same data with the dataset held on the card,
    three steps a dispatch and a trace of iterations 2-4: six iterations,
    then a run resumed from ``iter_3``. The counts are set to 0 before the
    first run; a replay does not tick them, so the kernels launched are
    the counts, less each capture's, plus each graph's replays times its
    launches a replay: every flagship kernel, exactly as nine steps imply.
    Losses finite, both checkpoints load, the resumed run logs iteration 6
    only, and the trace exists."""
    out = os.path.join(wd, "out_cached")
    trace_dir = os.path.join(wd, "profile")
    args = ["--config", yml, "--iters", "6", "--save_interval", "3",
            "--log_iters", "3", "--save_dir", out, "--seed", str(TRAIN_SEED),
            "--loader_mode", "device_cache", "--steps_per_dispatch", "3"]
    profiled = args + ["--profiler_options", "batch_range=[2,4];"
                       "profile_path={};exit_on_finished=false".format(
                           trace_dir)]
    reset_counts()
    train_profiler.reset()
    with TrainLog("[TRAIN]", "TrainLoader mode") as log, \
            CachedSteps() as built:
        t0 = time.perf_counter()
        with KeptProfilers() as profilers:
            first = train_cli.main(train_cli.parse_args(profiled))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check(first.step == 6, "the cached CLI run ended at step {}".format(
            first.step))
        del first
        resumed = train_cli.main(train_cli.parse_args(
            args + ["--resume_model", os.path.join(out, "iter_3")]))
        torch.cuda.synchronize()
        check(resumed.step == 6, "the resumed cached run ended at step "
              "{}".format(resumed.step))
        del resumed
    train_profiler.reset()
    torch.cuda.empty_cache()
    lines = log.lines
    check(sum("mode: device_cache" in ln and "reader=native" in ln
              for ln in lines) == 2,
          "the cached CLI runs did not hold the data on the card, read "
          "through the native reader: {}".format(lines))
    lines = [ln for ln in lines if "[TRAIN]" in ln]
    launches = dict(c5.LAUNCHES)
    replays = [step.graphed.replays for step in built.steps]
    for step in built.steps:
        for k, v in step.graphed.launches.items():
            launches[k] += (step.graphed.replays - 1) * v
    check(replays == [5, 2], "graph replays {} (a capture and 5 replays, "
          "then 1 and 2)".format(replays))
    check_flagship_launches(launches, 6 + 3)
    check(len(lines) == 3 and "iter: 6/6" in lines[-1],
          "logged iterations: {}".format(lines))
    losses = [TrainLog.field(ln, "loss") for ln in lines]
    check(all(np.isfinite(losses)), "non-finite cached CLI loss: "
          "{}".format(losses))
    cfg = Config(yml)
    for it in (3, 6):
        model = build_model(cfg.dic["model"])
        optimizer = torch.optim.SGD(model.parameters(), lr=0.0,
                                    momentum=0.9)
        step = ckpt.load_checkpoint(os.path.join(out, "iter_{}".format(it)),
                                    model, optimizer)
        check(step == it and all(bool(torch.isfinite(v).all()) for v in
                                 model.state_dict().values()),
              "cached iter_{} did not load (step {})".format(it, step))
    trace = train_profiler.trace_path({"profile_path": trace_dir})
    check(os.path.isfile(trace) and os.path.getsize(trace) > 0,
          "no trace at " + trace)
    # the port's trace reader on that trace, against the graph's launches
    # and the profiler's own device time of the window
    with contextlib.redirect_stdout(sys.stderr):
        rc = trace_ops.main([trace, str(TRACE_STEPS), "15"])
    read = trace_ops.summarize(trace, TRACE_STEPS)
    per_replay = built.steps[0].graphed.launches
    hand = sum(v for k, v in per_replay.items()
               if k != "conv5_fused_epilogue")
    check(rc == 0 and read["hand_launches"] == hand, "trace_ops: exit {}, "
          "{} hand-kernel launches a step against {} a replay".format(
              rc, read["hand_launches"], hand))
    check(len(profilers.kept) == 1, "{} profilers in the cached run".format(
        len(profilers.kept)))
    groups, _ = device_groups(profilers.kept[0])
    own_ms = sum(groups.values()) / TRACE_STEPS
    check(abs(read["busy_ms"] - own_ms) <= TRACE_BUSY_REL * own_ms,
          "trace_ops busy {:.3f} ms a step against the profiler's {:.3f}"
          .format(read["busy_ms"], own_ms))
    return {"losses": losses, "windows_ms_per_iter": [
        TrainLog.field(ln, "batch_cost") * 1e3 for ln in lines],
        "run_s": first_s, "replays": replays,
        "launches_per_replay": per_replay,
        "trace_mb": os.path.getsize(trace) / 1e6,
        "trace_ops": {"steps": TRACE_STEPS, "busy_ms": read["busy_ms"],
                      "profiler_busy_ms": own_ms,
                      "nccl_ms": read["nccl_ms"],
                      "hand_launches": read["hand_launches"],
                      "categories": read["categories"],
                      "top_kernels": [[k[:80]] + v for k, v in list(
                          read["kernels"].items())[:10]]}}


class EvalCalls:
    """Wraps ``core.val.evaluate`` as the val CLI calls it: keeps each
    call's arguments and result, and its host wall time (synchronized)."""

    def __init__(self):
        self.calls = []
        self._real = core_val.evaluate

    def __enter__(self):
        def evaluate(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._real(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append({"args": args, "kwargs": kwargs, "result": out,
                               "s": time.perf_counter() - t0})
            return out
        core_val.evaluate = evaluate
        return self

    def __exit__(self, *exc):
        core_val.evaluate = self._real


def write_eval_data(wd):
    """Three seeded 128^3 volumes with labels in [0, 3) (a lesion-like
    ball of class 2 inside a box of class 1, as the lung task has), their
    list files and a dataset.json with :data:`EVAL_GEOMETRY`; returns the
    dataset.json path."""
    phase0 = os.path.join(wd, "phase0")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(phase0, sub))
    rng = np.random.RandomState(TRAIN_SEED)
    grid = np.indices((EDGE,) * 3).astype(np.float32)
    lines, training = [], {}
    for i in range(EVAL_VOLUMES):
        name = "lung{}".format(i)
        lo = rng.randint(16, 40, 3)
        hi = lo + rng.randint(48, 72, 3)
        label = np.zeros((EDGE,) * 3, np.uint8)
        label[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1
        centre = (lo + hi) / 2.0
        ball = sum((g - c) ** 2 for g, c in zip(grid, centre)) < 12.0 ** 2
        label[ball] = 2
        image = (0.3 * label + 0.2 * rng.rand(*label.shape)).astype(
            np.float32)
        np.save(os.path.join(phase0, "images", name + ".npy"), image)
        np.save(os.path.join(phase0, "labels", name + ".npy"), label)
        lines.append("images/{0}.npy labels/{0}.npy\n".format(name))
        training[name] = dict(EVAL_GEOMETRY)
    for split in ("train", "val"):
        with open(os.path.join(phase0, split + "_list.txt"), "w") as f:
            f.writelines(lines)
    path = os.path.join(wd, "dataset.json")
    with open(path, "w") as f:
        json.dump({"training": training}, f)
    return path


def check_dump(out, volumes):
    """The first volumes' dump: pred, label and img as .npy and readable
    .nii.gz of 128^3 with the dataset.json spacing."""
    for i in range(min(volumes, core_val.DUMPED)):
        for name in ("pred", "label", "img"):
            path = os.path.join(out, str(i), name + ".nii.gz")
            check(os.path.exists(os.path.join(out, str(i), name + ".npy")),
                  "no {}.npy in the dump of volume {}".format(name, i))
            data, meta = medio.read_image(path)
            check(data.shape == (EDGE,) * 3 and np.allclose(
                meta["spacing"], EVAL_GEOMETRY["spacing_resample"]),
                "{}: shape {} spacing {}".format(path, data.shape,
                                                 meta["spacing"]))


def phase_eval():
    """Evaluation on the card: the cube config (VNet, bf16) pointed at
    three seeded 128^3 volumes with a dataset.json, seeded weights saved
    as ``model.msgpack``; the val CLI (``medicalseg_torch.val.main``) run
    in this process whole-volume, with ``--sw_num 2`` and with
    ``--auc_roc true --weights_precision int8``, the counts set to 0 just
    before each run and read just after (exactly the eval forwards the
    mode implies: fused-epilogue convs and pins, no train kernels). Each
    run's predictions held to the same evaluation with the kernels forced
    to their plain versions (argmax agreement >= 99.5% of voxels, mDice
    within :data:`EVAL_MDICE_TOL`), its dump readable. Then the train CLI
    on the same data with ``--do_eval`` (four iterations, an eval at 2 and
    4): ``best_model/best.json`` is written, and a run resumed from
    ``iter_2`` restores the tracker and keeps a best mDice no lower.
    Prints ms per evaluated volume (host clock, synchronized), the device
    time of one evaluated volume (profiled whole-volume evaluation over
    three), the three mDice values and the AUC."""
    runs = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        json_path = write_eval_data(wd)
        cfg = Config(LUNG_TPU).dic
        cfg["data_root"] = wd
        for key in ("train_dataset", "val_dataset"):
            cfg[key]["dataset_root"] = "phase0"
            cfg[key]["result_dir"] = "phase1"
        cfg["val_dataset"]["dataset_json_path"] = json_path
        yml = os.path.join(wd, "lung.yml")
        import yaml
        with open(yml, "w") as f:
            yaml.safe_dump(cfg, f)
        weights = os.path.join(wd, "weights")
        ckpt.save_checkpoint(weights, seeded_model(cfg["model"]))
        model_path = os.path.join(weights, ckpt.MODEL_FILE)

        for mode, extra in EVAL_RUNS:
            out = os.path.join(wd, "eval_" + mode)
            argv = ["--config", yml, "--model_path", model_path,
                    "--save_dir", out, *extra]
            reset_counts()
            with TrainLog("[EVAL]") as log, EvalCalls() as calls:
                result = val_cli.main(val_cli.parse_args(argv))
            launches = dict(c5.LAUNCHES)
            call = calls.calls[0]
            state, dataset, losses = call["args"]
            forwards = (EVAL_VOLUMES if mode != "sw2" else
                        EVAL_VOLUMES * -(-27 // 4))  # 3^3 windows, 4 a batch
            expect = forward_counts(forwards)
            check(launches == expect, "eval {}: launch counts {} != "
                  "expected {}".format(mode, launches, expect))
            check(all(np.isfinite(list(result.values()))),
                  "eval {}: {}".format(mode, result))
            check_dump(out, EVAL_VOLUMES)
            kw = {k: call["kwargs"][k] for k in ("auc_roc", "sw_num")}
            with plain_ops(), TrainLog("[EVAL]"):
                plain = core_val.evaluate(state, dataset, losses,
                                          save_dir=out + "_plain", **kw)
            agree = float(np.mean([np.mean(
                np.load(os.path.join(out, str(i), "pred.npy")) ==
                np.load(os.path.join(out + "_plain", str(i), "pred.npy")))
                for i in range(EVAL_VOLUMES)]))
            check(agree >= 0.995, "eval {}: argmax agreement {} < 0.995 "
                  "with the plain path".format(mode, agree))
            check(abs(result["mdice"] - plain["mdice"]) <= EVAL_MDICE_TOL,
                  "eval {}: mDice {} vs plain path {}".format(
                      mode, result["mdice"], plain["mdice"]))
            runs[mode] = {"result": result, "plain_result": plain,
                          "argmax_agreement_vs_plain": agree,
                          "ms_per_volume": call["s"] * 1e3 / EVAL_VOLUMES,
                          "launches": {k: v for k, v in launches.items()
                                       if v},
                          "eval_line": log.lines[0] if log.lines else None}
            if mode == "whole":
                with TrainLog("[EVAL]"):
                    profile = profile_call(lambda: core_val.evaluate(
                        state, dataset, losses, print_detail=False))
                runs[mode]["device_ms_per_volume"] = (
                    profile["device_busy_ms"] / EVAL_VOLUMES)
                runs[mode]["profile_idle_share"] = profile["idle_share"]
                runs[mode]["profile_device_ms_by_op"] = profile[
                    "device_ms_by_op"][:5]
            del state, call, calls
            torch.cuda.empty_cache()

        # the train CLI with --do_eval, then resumed
        out = os.path.join(wd, "train")
        best_json = os.path.join(out, "best_model", "best.json")
        argv = ["--config", yml, "--iters", "4", "--save_interval", "2",
                "--log_iters", "2", "--batch_size", "2", "--save_dir", out,
                "--seed", str(TRAIN_SEED), "--do_eval"]
        with TrainLog("[EVAL]", "[TRAIN]") as log:
            first = train_cli.main(train_cli.parse_args(argv))
        check(first.step == 4 and os.path.exists(best_json),
              "the train CLI with --do_eval left no best.json")
        del first
        with open(best_json) as f:
            best = json.load(f)
        evals = [ln for ln in log.lines if "#Images" in ln]
        check(best["iter"] in (2, 4) and len(evals) == 2,
              "best {} after evals {}".format(best, evals))
        model = build_model(cfg["model"])
        ckpt.load_checkpoint(os.path.join(out, "best_model"), model)
        check(all(bool(torch.isfinite(v).all())
                  for v in model.state_dict().values()),
              "best_model holds non-finite values")
        with TrainLog("Restored best-model tracker", "#Images") as log:
            resumed = train_cli.main(train_cli.parse_args(
                argv + ["--resume_model", os.path.join(out, "iter_2")]))
        check(resumed.step == 4, "the resumed run ended at step {}".format(
            resumed.step))
        del resumed
        with open(best_json) as f:
            best_resumed = json.load(f)
        check(any("Restored" in ln for ln in log.lines) and
              best_resumed["mdice"] >= best["mdice"],
              "the resumed run lost the tracker: {} -> {} ({})".format(
                  best, best_resumed, log.lines))
        torch.cuda.empty_cache()
    emit({"phase": "eval", "config": os.path.relpath(LUNG_TPU, ROOT),
          "volumes": EVAL_VOLUMES, "shape": [EDGE] * 3,
          "runs": runs,
          "mdice": {m: r["result"]["mdice"] for m, r in runs.items()},
          "mdice_hard": {m: r["result"]["mdice_hard"]
                         for m, r in runs.items()},
          "auc_roc": runs["auc_int8"]["result"]["auc_roc"],
          "ms_per_volume": {m: r["ms_per_volume"] for m, r in runs.items()},
          "device_ms_per_volume": runs["whole"]["device_ms_per_volume"],
          "train_do_eval": {"best": best, "best_after_resume": best_resumed,
                            "evals": evals}})


def phase_train_flagship():
    """The flagship step: the spine config's VNetDeepSup (bf16, per-block
    remat, 20 classes), its four MixedLoss heads, SGD with momentum and
    poly LR, all built by ``Config``, at the YAML's batch of 3 on seeded
    12 x 512 x 512 volumes and labels in [0, 20), made on the card. First
    one step at batch 1 of the same volumes through the kernels and
    through the plain versions from the same state and masks (loss and
    per-leaf gradients held as in the cube phase); then at batch 3 two
    warm-up steps, three timed ones with the counts set to 0 just before
    them (every kernel of the path launched, the conv counts exactly
    what the model implies), one profiled step."""
    cfg = Config(SPINE)
    mc = cfg.dic["model"]
    check(mc["type"] == "VNetDeepSup" and mc["remat"] is True and
          mc["dtype"] == "bfloat16" and mc["num_classes"] == 20 and
          cfg.batch_size == 3, "spine config changed")
    classes, batch = mc["num_classes"], cfg.batch_size
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    images = torch.rand((batch,) + FLAGSHIP_STEM[1:] + (1,), generator=gen,
                        device=dev)
    labels = torch.randint(0, classes, (batch,) + FLAGSHIP_STEM[1:],
                           generator=gen, device=dev, dtype=torch.uint8)
    step = make_train_step(cfg.loss)

    def new_state(weights=None):
        model = build_model(mc, generator=torch.Generator().manual_seed(
            TRAIN_SEED))
        if weights is not None:
            model.load_state_dict(weights)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED)

    def run(state, n=batch):
        """One step on the first ``n`` volumes with the same dropout masks
        every time: (loss, ms on the host clock, synchronized)."""
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, images[:n], labels[:n])
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    state = new_state()
    model = state.model
    check(type(model).__name__ == "VNetDeepSup" and
          model.dtype == torch.bfloat16 and model.remat,
          "model is not the bf16 remat VNetDeepSup of the config")
    start = copy.deepcopy(model.state_dict())

    # batch 1: the kernel path against the plain versions, same start
    one = new_state(start)
    loss_k, _ = run(one, 1)
    grads = {}
    for name, p in one.model.named_parameters():
        check(p.grad is not None, name + " has no gradient")
        check(bool(torch.isfinite(p.grad).all()), name + ": non-finite "
              "gradient")
        check(p.grad.abs().sum().item() > 0, name + ": zero gradient")
        grads[name] = p.grad.float().clone()
    del one
    ref = new_state(start)
    with plain_ops():
        c5.reset_launches()
        loss_p, plain_ms = run(ref, 1)
        check(not any(c5.LAUNCHES.values()), "the plain path launched a "
              "kernel: {}".format(c5.LAUNCHES))
    ref_grads = {n: p.grad.float() for n, p in ref.model.named_parameters()}
    del ref
    rels = grad_rel_l2(grads, ref_grads)
    worst = max(rels.items(), key=lambda kv: kv[1])
    rel_sorted = sorted(rels.values())
    check(abs(loss_k - loss_p) <= LOSS_REL * abs(loss_p),
          "flagship step-1 loss {} vs plain path {}".format(loss_k, loss_p))
    check(worst[1] <= GRAD_REL_L2, "flagship gradient of {} differs from "
          "the plain path's by {} relative L2".format(*worst))
    heads_rel = {n: rels[n] for n in rels if n.startswith("Conv_")}
    del grads, ref_grads
    torch.cuda.empty_cache()

    # batch 3: warm-up, then the timed steps
    torch.cuda.reset_peak_memory_stats()
    loss1, warm_ms = run(state)
    for name, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and
              p.grad.abs().sum().item() > 0, name + ": no finite, non-zero "
              "gradient at batch {}".format(batch))
    loss2, _ = run(state)
    c5.reset_launches()
    timed = [run(state) for _ in range(3)]
    launches = dict(c5.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [loss1, loss2] + [l for l, _ in timed]
    step_ms = [ms for _, ms in timed]
    check(all(np.isfinite(losses)), "non-finite loss: {}".format(losses))
    check(losses[-1] < losses[0], "the loss did not fall: {}".format(losses))
    check_flagship_launches(launches, 3)

    profile = profile_call(lambda: run(state))

    # the same step with the recipe's device augmentation at its head
    # (RandomRotation3D(30) + RandomFlip3D on the raw volumes); the
    # dropout masks as above, the draws of one step
    step_aug = make_train_step(cfg.loss, augment_fn=DeviceAugmentor(
        recipe_transforms(SPINE), seed=TRAIN_SEED))
    raw = images[..., 0]

    def run_aug(state):
        state.generator.manual_seed(TRAIN_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step_aug(state, raw, labels)
        torch.cuda.synchronize()
        return metrics["loss"].item(), (time.perf_counter() - t0) * 1e3

    run_aug(state)
    torch.cuda.reset_peak_memory_stats()
    c5.reset_launches()
    timed_aug = [run_aug(state) for _ in range(3)]
    aug_launches = dict(c5.LAUNCHES)
    aug_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(np.isfinite([l for l, _ in timed_aug])), "non-finite loss "
          "with augmentation: {}".format(timed_aug))
    check_flagship_launches(aug_launches, 3)
    aug_profile = profile_call(lambda: run_aug(state))

    # the four heads' losses alone, forward and backward, on f32 logits of
    # the step's shape (seeded): their share of the step
    del state, model
    torch.cuda.empty_cache()
    logits = [torch.randn((batch,) + FLAGSHIP_STEM[1:] + (classes,),
                          generator=gen, device=dev).requires_grad_(True)
              for _ in range(4)]
    labels_long = labels.long()

    def losses_step():
        for t in logits:
            t.grad = None
        loss_list, _ = loss_computation(logits, labels_long, cfg.loss)
        sum(loss_list).backward()

    losses_ms = time_ms(losses_step, reps=3)
    losses_profile = profile_call(losses_step)
    del logits, labels_long
    mean_ms = float(np.median(step_ms))
    emit({"phase": "train_flagship", "config": os.path.relpath(SPINE, ROOT),
          "batch": batch, "shape": list(FLAGSHIP_STEM[1:]),
          "classes": classes, "dtype": "bfloat16", "remat": True,
          "steps": len(losses), "losses": losses,
          "batch1_loss": loss_k, "batch1_loss_plain_path": loss_p,
          "batch1_plain_path_step_ms": plain_ms,
          "worst_grad_rel_l2_vs_plain": list(worst),
          "median_grad_rel_l2_vs_plain": rel_sorted[len(rel_sorted) // 2],
          "heads_grad_rel_l2_vs_plain": heads_rel,
          "ms_per_step": mean_ms, "ms_per_step_each": step_ms,
          "patches_per_s": batch / mean_ms * 1e3, "warmup_step_ms": warm_ms,
          "peak_mem_gb": peak,
          "launches_per_step": {k: v / 3 for k, v in launches.items()},
          "profile": profile,
          "aug_losses": [l for l, _ in timed_aug],
          "aug_ms_per_step": float(np.median([ms for _, ms in timed_aug])),
          "aug_ms_per_step_each": [ms for _, ms in timed_aug],
          "aug_peak_mem_gb": aug_peak,
          "aug_profile_device_busy_ms": aug_profile["device_busy_ms"],
          "aug_profile_idle_share": aug_profile["idle_share"],
          "losses_ms": losses_ms,
          "losses_device_ms": losses_profile["device_busy_ms"],
          "losses_device_ms_by_op": losses_profile["device_ms_by_op"]})
    return launches


# train_graph: steps of each config run eagerly and as CUDA-graph replays
GRAPH_STEPS = {"cube": 6, "flagship": 4}
GRAPH_VOLUMES = 4  # volumes in the device cache of each config


def _dropout_mask(model):
    """The mask the first ChannelDropout of ``model`` drew last, or None."""
    for m in model.modules():
        if isinstance(m, ChannelDropout):
            return None if m._keep is None else m._keep.clone()
    return None


def _graph_inputs(path, shape, classes, batch, steps, device, rows=None,
                  start=None):
    """What the graphed cases start from: the config; a seeded device
    cache of ``GRAPH_VOLUMES`` volumes of ``shape`` as
    TrainLoader.build_device_cache holds it (raw volumes in the bf16 /
    uint8 wire dtypes); the seeded stream of ``steps`` batches of
    ``batch`` cache indices (``rows`` = (lo, hi) keeps a rank's rows of
    each); the recipe's device augmentation; and ``new_state()``, a fresh
    capturable TrainState from the ``start`` weights (the seeded
    initialisation by default)."""
    cfg = Config(path)
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    cache = ((torch.rand((GRAPH_VOLUMES,) + shape, generator=gen,
                         device=device) * 255).to(torch.bfloat16),
             torch.randint(0, classes, (GRAPH_VOLUMES,) + shape,
                           generator=gen, device=device, dtype=torch.uint8))
    rng = np.random.RandomState(TRAIN_SEED)
    order = np.concatenate([rng.permutation(GRAPH_VOLUMES) for _ in range(
        -(-steps * batch // GRAPH_VOLUMES))])
    stream = order[:steps * batch].reshape(steps, batch)
    if rows is not None:
        stream = stream[:, rows[0]:rows[1]]
    stream = stream.astype(np.int32)
    if start is None:
        start = build_model(cfg.dic["model"], generator=torch.Generator(
        ).manual_seed(TRAIN_SEED)).state_dict()
    augment = DeviceAugmentor(recipe_transforms(path), seed=TRAIN_SEED + 1)

    def new_state():
        model = build_model(cfg.dic["model"], generator=torch.Generator(
        ).manual_seed(TRAIN_SEED))
        model.load_state_dict(start)
        return TrainState.create(model, cfg.build_optimizer,
                                 cfg.lr_scheduler, seed=TRAIN_SEED,
                                 device=device, capturable_optimizer=True)

    return cfg, cache, stream, augment, new_state


def _eager_call(step, state, cache, idx, syncs_error=False):
    """One eager step on the cached volumes ``idx``, the generator
    re-seeded from (seed, step) as the train loop does; with
    ``syncs_error`` a host sync inside the step raises (a sync would break
    a capture). Returns its metrics."""
    state.generator.manual_seed(step_seed(TRAIN_SEED, state.step))
    idx = torch.from_numpy(idx).long().to(cache[0].device)
    if syncs_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        return step(state, cache[0].index_select(0, idx),
                    cache[1].index_select(0, idx))[1]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _timed_steps(call, dispatches, after):
    """``call(i, d)`` for each dispatch ``d`` (one step's indices, or
    several steps'), synchronized on both sides: the losses in step order,
    the host ms a step of each dispatch, and ``after()`` after each."""
    out = {"loss": [], "ms": [], "after": []}
    for i, d in enumerate(dispatches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = call(i, d)
        torch.cuda.synchronize()
        loss = metrics["loss"].reshape(-1)
        out["ms"].append((time.perf_counter() - t0) * 1e3 / loss.numel())
        out["loss"].extend(loss.tolist())
        out["after"].append(after())
    return out


def _graph_case(name, path, shape, classes, batch):
    """One config through the eager step and the graphed cached step from
    one state and one stream of cached batches (module docstring,
    ``train_graph``). Returns its JSON entry."""
    steps = GRAPH_STEPS[name]
    cfg, cache, stream, augment, new_state = _graph_inputs(
        path, shape, classes, batch, steps, torch.device("cuda"))
    cache_images, cache_labels = cache

    def probe(state, counts):
        """Eval-mode logits of the first cached volume, raw and unaugmented
        (scaled to [0, 1]), as an evaluation between steps takes them:
        they move with the parameters. Its launches are taken off the
        counts again, into ``counts``."""
        before = dict(c5.LAUNCHES)
        x = cache_images[:1].float()[..., None] / 255.0
        with torch.no_grad():
            out = state.model.eval()(x)[0].float()
        state.model.train()
        for k in before:
            counts[k] = counts.get(k, 0) + c5.LAUNCHES[k] - before[k]
        return out

    # eager: the loop's rule (generator re-seeded from (seed, step)), the
    # batch gathered from the cache; the first step with host syncs as
    # errors (a sync would break the capture)
    eager_step = make_train_step(cfg.loss, augment_fn=augment)
    state = new_state()
    torch.cuda.reset_peak_memory_stats()
    c5.reset_launches()
    eager_probed = {}
    eager = _timed_steps(
        lambda i, idx: _eager_call(eager_step, state, cache, idx, i == 0),
        stream, lambda: (_dropout_mask(state.model),
                         probe(state, eager_probed)))
    eager["mask"], eager["probe"] = map(list, zip(*eager.pop("after")))
    eager_launches = {k: (v - eager_probed[k]) / steps
                      for k, v in c5.LAUNCHES.items()}
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eager_params = {k: v.float().clone()
                    for k, v in state.model.state_dict().items()}
    eager_profile = profile_call(
        lambda: _eager_call(eager_step, state, cache, stream[0]))
    del state, eager_step
    torch.cuda.empty_cache()

    # graphed: the cached step (step 1 the eager warm-up and the capture,
    # then replays); the counts set to 0 just before
    cached = make_cached_train_step(cfg.loss, 1, augment_fn=augment)
    state = new_state()
    torch.cuda.reset_peak_memory_stats()
    c5.reset_launches()
    probed = {}
    # the capture leaves the graph's (unrun) buffers in the modules: the
    # masks a replay drew are read from the replays on
    graphed = _timed_steps(
        lambda i, idx: cached(state, *cache, idx, seed=TRAIN_SEED)[1],
        stream, lambda: (_dropout_mask(state.model)
                         if cached.graphed.replays else None,
                         probe(state, probed)))
    graphed["mask"], graphed["probe"] = map(list, zip(*graphed.pop("after")))
    graph = cached.graphed
    # the probe's eval forwards are not the step's
    launches = {k: v - probed[k] for k, v in c5.LAUNCHES.items()}
    graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(graph.replays == steps - 1, "{}: {} replays of {} steps".format(
        name, graph.replays, steps))
    # a replay does not tick the counters: the warm-up's launches plus the
    # capture's recorded ones are on them; the device ran the warm-up and
    # each replay
    per_replay = graph.launches
    ran = {k: launches[k] - per_replay[k] + graph.replays * per_replay[k]
           for k in launches}
    for k in launches:
        check(per_replay[k] == eager_launches[k], "{}: {} launches a replay "
              "{} != eager {}".format(name, k, per_replay[k],
                                      eager_launches[k]))
    check(sum(per_replay.values()) > 0, name + ": the graph holds no hand "
          "kernel")
    check(all(ran[k] == steps * eager_launches[k] for k in ran),
          "{}: launches of {} graphed steps {} != the eager step's {} "
          "each".format(name, steps, ran, eager_launches))
    if name == "flagship":
        check_flagship_launches(ran, steps)

    # the graph against the eager step
    loss_rel = [abs(g - e) / abs(e) for g, e in zip(graphed["loss"],
                                                    eager["loss"])]
    params = {k: v.float() for k, v in state.model.state_dict().items()}
    param_rel = {k: float((params[k] - eager_params[k]).norm() /
                          eager_params[k].norm().clamp_min(1e-12))
                 for k in params if eager_params[k].is_floating_point()}
    bitwise = {"losses": graphed["loss"] == eager["loss"],
               "leaves": sum(torch.equal(params[k], eager_params[k])
                             for k in params),
               "of_leaves": len(params)}
    check(all(np.isfinite(graphed["loss"])), name + ": non-finite graphed "
          "loss {}".format(graphed["loss"]))
    check(max(loss_rel) <= GRAPH_LOSS_REL, "{}: graphed losses {} vs eager "
          "{}".format(name, graphed["loss"], eager["loss"]))
    worst = max(param_rel.items(), key=lambda kv: kv[1])
    check(worst[1] <= GRAPH_PARAM_REL, "{}: after {} steps {} differs from "
          "the eager step's by {} relative L2".format(name, steps, *worst))
    # the parameters moved across replays, and so did the logits
    check(all(not torch.equal(a, b) for a, b in
              zip(graphed["probe"][1:], graphed["probe"][:-1])),
          name + ": the logits did not change across replays")
    probe_rel = [float((g - e).norm() / e.norm()) for g, e in
                 zip(graphed["probe"], eager["probe"])]
    check(max(probe_rel) <= GRAPH_PARAM_REL, "{}: eval logits after each "
          "graphed step {} relative L2 from the eager step's".format(
              name, probe_rel))
    # dropout masks: new at every replay, the eager step's at each (seed,
    # step); then one more replay re-seeded as the last step was repeats
    # its mask
    masks_differ = [not torch.equal(a, b) for a, b in
                    zip(graphed["mask"][2:], graphed["mask"][1:-1])]
    masks_as_eager = [torch.equal(a, b) for a, b in
                      zip(graphed["mask"][1:], eager["mask"][1:])]
    check(all(masks_differ), "{}: a dropout mask repeated across replays "
          "({})".format(name, masks_differ))
    check(all(masks_as_eager), "{}: the graphed dropout masks are not the "
          "eager step's at the same (seed, step) ({}; losses {} vs {})"
          .format(name, masks_as_eager, graphed["loss"], eager["loss"]))
    state.step -= 1
    cached(state, cache_images, cache_labels, stream[-1], seed=TRAIN_SEED)
    check(torch.equal(_dropout_mask(state.model), graphed["mask"][-1]),
          name + ": the same (seed, step) drew another mask")

    def replay_call():
        cached(state, cache_images, cache_labels, stream[0],
               seed=TRAIN_SEED)

    graph_profile = profile_call(replay_call)
    # device time of the replay alone (CUDA events around it)
    graph_replay_ms = time_ms(graph.graph.replay, reps=3)
    del state, cached, graph
    torch.cuda.empty_cache()

    # two steps a dispatch ([2, B] index rows): the same updates
    cached2 = make_cached_train_step(cfg.loss, 2, augment_fn=augment)
    state = new_state()
    torch.cuda.reset_peak_memory_stats()
    two = _timed_steps(
        lambda i, rows: cached2(state, *cache, rows, seed=TRAIN_SEED)[1],
        stream.reshape(steps // 2, 2, batch), lambda: None)
    two_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(cached2.graphed.replays == steps - 1 and state.step == steps,
          "{}: two steps a dispatch took {} replays".format(
              name, cached2.graphed.replays))
    check(two["loss"] == eager["loss"] and all(
        torch.equal(v.float(), eager_params[k])
        for k, v in state.model.state_dict().items()),
          "{}: two steps a dispatch {} differ from the eager steps {}"
          .format(name, two["loss"], eager["loss"]))
    del state, cached2
    torch.cuda.empty_cache()
    eager_ms = float(np.median(eager["ms"][1:]))
    graph_ms_ = float(np.median(graphed["ms"][1:]))
    return {"config": os.path.relpath(path, ROOT), "batch": batch,
            "shape": list(shape), "cached_volumes": GRAPH_VOLUMES,
            "steps": steps, "replays": steps - 1,
            "eager_losses": eager["loss"], "graphed_losses": graphed["loss"],
            "max_loss_rel": max(loss_rel),
            "worst_param_rel_l2": list(worst),
            "bitwise": bitwise, "probe_rel_vs_eager": probe_rel,
            "eager_ms_per_step": eager_ms, "eager_ms_each": eager["ms"],
            "graphed_ms_per_step": graph_ms_,
            "graphed_ms_each": graphed["ms"],
            "replay_device_ms": graph_replay_ms,
            "eager_device_ms": eager_profile["device_busy_ms"],
            "eager_idle_share": eager_profile["idle_share"],
            "graphed_device_ms": graph_profile["device_busy_ms"],
            "graphed_idle_share": graph_profile["idle_share"],
            "graphed_profile_wall_ms": graph_profile["wall_ms"],
            "eager_peak_gb": eager_peak, "graphed_peak_gb": graph_peak,
            "launches_per_replay": per_replay,
            "launches_run": ran,
            "two_per_dispatch_ms_per_step": float(np.median(two["ms"][1:])),
            "two_per_dispatch_ms_each": two["ms"],
            "two_per_dispatch_peak_gb": two_peak}


def phase_train_graph():
    """The cube and flagship configs through the graphed cached step
    against the eager step (module docstring, ``train_graph``)."""
    line = {"phase": "train_graph", "gpu": smi_line()}
    line["cube"] = _graph_case("cube", LUNG_TPU, (EDGE, EDGE, EDGE), 3,
                               BATCH)
    line["flagship"] = _graph_case("flagship", SPINE, FLAGSHIP_STEM[1:], 20,
                                   FLAGSHIP_STEM[0])
    emit(line)
    return line


# ----------------------------------------------------------------------
# parallel: the data x space process mesh
# ----------------------------------------------------------------------
PAR_WORLD, PAR_SPACE = 4, 2  # data 2 x space 2
PAR_TIMEOUT = 480  # s: the four ranks together, from their start
PAR_STAT_TOL = 2e-2  # BN statistics after the step, scaled_err, bf16
PAR_AGREE = 0.995  # eval argmax agreement with one process
PAR_MDICE_TOL = 5e-5  # torchrun val against one process (4-decimal log)
# (name, config, batch per data index): the cube's 2 x 128^3 and the
# flagship's 3 x 12 x 512 x 512 a data index
PAR_CASES = (("cube", LUNG_TPU, 1), ("flagship", SPINE, 3))
# the cube config at H = 80: H 80 -> 40 -> 20 -> 10 -> 5, the deepest
# level's five rows replicated over space 2 (parallel.h_levels)
PAR_H80 = ("cube_h80", LUNG_TPU, 1)
PAR_SHAPES = {"cube": (EDGE, EDGE, EDGE), "cube_h80": (EDGE, 80, EDGE),
              "flagship": FLAGSHIP_STEM[1:]}
# host-mode loading over the mesh: seeded volumes, the global batch, the
# batches compared, and the recipe (drawn on the host)
PAR_HOST = {"shape": (24, 40, 32), "volumes": 5, "batch": 4, "batches": 3}
# the graphed cached step over NCCL: the capture's eager warm-up, then
# three replays, each bit for bit the eager sharded step
PAR_GRAPH_STEPS = 4


def _par_batch(name, batch, device):
    """The seeded global batch of a sharded case, made alike in every
    process: (images NDHWC f32, labels uint8)."""
    if name != "flagship":
        shape = (batch,) + PAR_SHAPES[name]
        rng = np.random.RandomState(TRAIN_SEED)
        images = torch.from_numpy(rng.rand(*shape, 1).astype(
            np.float32)).to(device)
        labels = torch.from_numpy(rng.randint(0, 3, shape).astype(
            np.uint8)).to(device)
        return images, labels
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
    images = torch.rand((batch,) + FLAGSHIP_STEM[1:] + (1,), generator=gen,
                        device=device)
    labels = torch.randint(0, 20, (batch,) + FLAGSHIP_STEM[1:],
                           generator=gen, device=device, dtype=torch.uint8)
    return images, labels


def _par_state(path, device, weights=None):
    cfg = Config(path)
    model = build_model(cfg.dic["model"], generator=torch.Generator(
    ).manual_seed(TRAIN_SEED))
    if weights is not None:
        model.load_state_dict(weights)
    return cfg, TrainState.create(model, cfg.build_optimizer,
                                  cfg.lr_scheduler, seed=TRAIN_SEED,
                                  device=device)


def _par_reference(name, path, batch, wd):
    """One process: the start weights, then one eager step at the global
    batch (its loss, gradients and BatchNorm statistics), the stepped
    weights and their eval argmax on the same batch, saved under
    ``wd``."""
    cfg, state = _par_state(path, "cuda")
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(wd, name + "_start.pt"))
    images, labels = _par_batch(name, batch, "cuda")
    state.generator.manual_seed(TRAIN_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = make_train_step(cfg.loss)(state, images, labels)
    loss = metrics["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    ref = {"loss": loss, "ms": ms,
           "grads": {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()},
           "stats": {k: v.cpu() for k, v in state.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
               os.path.join(wd, name + "_stepped.pt"))
    state.model.eval()
    with torch.no_grad():
        ref["pred"] = torch.argmax(state.model(images)[0], -1).to(
            torch.uint8).cpu()
    torch.save(ref, os.path.join(wd, name + "_ref.pt"))
    del state, images, labels, metrics
    torch.cuda.empty_cache()
    return {"loss": loss, "ms": ms}


@contextlib.contextmanager
def _record_shapes(seen):
    """Record, meanwhile, the operand shapes of every conv5 forward,
    dgrad, weight-gradient and pin launch: {key: launches}."""
    fwd, wgrad, pin = c5._conv5_cuda, c5._conv5_wgrad_cuda, c5._pin_cuda

    def conv(xk, w, b, kind, ep, dgrad=False, form=None):
        key = ("dgrad" if dgrad else "fwd", tuple(xk.shape), tuple(w.shape),
               str(xk.dtype), kind, ep is not None)
        seen[key] = seen.get(key, 0) + 1
        return fwd(xk, w, b, kind, ep, dgrad, form)

    def wg(xk, gk, kind, form=None):
        key = ("wgrad", tuple(xk.shape), tuple(gk.shape), str(xk.dtype),
               kind, False)
        seen[key] = seen.get(key, 0) + 1
        return wgrad(xk, gk, kind, form)

    def pn(xk):
        key = ("pin", tuple(xk.shape), tuple(xk.stride()), str(xk.dtype),
               None, False)
        seen[key] = seen.get(key, 0) + 1
        return pin(xk)

    c5._conv5_cuda, c5._conv5_wgrad_cuda, c5._pin_cuda = conv, wg, pn
    try:
        yield seen
    finally:
        c5._conv5_cuda, c5._conv5_wgrad_cuda, c5._pin_cuda = fwd, wgrad, pin


def _check_at_shape(key, seed):
    """Launch the kernel of a recorded ``key`` on seeded operands of its
    shapes and hold it to its plain version: the error (scaled for the
    weight gradient, as kernels_bwd holds it; exact for the pin)."""
    op, shape, other, dtype, kind, fused = key
    dtype = getattr(torch, dtype.split(".")[-1])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def rand(*shp, scale=1.0):
        return (torch.randn(shp, generator=gen, device=dev) * scale).to(dtype)

    if op == "pin":
        base = torch.randn(sum((s - 1) * t for s, t in zip(shape, other)) +
                           1, generator=gen, device=dev).to(dtype)
        view = base.as_strided(shape, other)
        check(torch.equal(c5._pin_cuda(view), view.contiguous()),
              "pin differs from contiguous() at {}".format(shape))
        return 0.0
    if op == "wgrad":
        x, g = rand(*shape), rand(*other, scale=0.1)
        got = c5._conv5_wgrad_cuda(x, g, kind).to(dtype).float()
        err = scaled_err(got, c5.conv5_wgrad_kl_plain(x, g))
        check(err <= TOL[dtype], "wgrad at {} {}: scaled error {}".format(
            shape, other, err))
        return err
    ci, co = (other[3], other[4]) if op == "fwd" else (other[4], other[3])
    w = (torch.randn(other, generator=gen, device=dev) /
         float(np.sqrt(125 * ci))).float()
    x = rand(*shape)
    if op == "dgrad":
        got = c5._conv5_cuda(x, w, None, "head", None, dgrad=True)
        ref = c5.conv5_dgrad_kl_plain(x, w)
    else:
        b = torch.randn(co, generator=gen, device=dev)
        ep = (tuple(torch.rand(co, generator=gen, device=dev) + 0.5
                    for _ in range(3)) if fused else None)
        got = c5._conv5_cuda(x, w, b, kind, ep)
        ref = c5.conv5_kl_plain(x, w, b, ep)
    tol = TOL[dtype]
    check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
          "{} at {}: kernel and plain version differ".format(op, shape))
    return (got.float() - ref.float()).abs().max().item()


def parallel_rank(wd):
    """One rank of the parallel phase (``chip_smoke.py --parallel-rank
    <dir>``, started by :func:`phase_parallel` with the process group in
    its environment): each case's sharded step and eval forward held to
    the one-process reference, the launch counts, then its share of the
    recorded kernel shapes held to the plain versions. Writes
    ``rank<r>.json``; a failed check raises."""
    from medicalseg_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device, backend = parallel.init_from_env("cuda")
    mesh = parallel.build_mesh(space=PAR_SPACE)
    out = {"rank": mesh.rank, "coords": [mesh.d, mesh.s],
           "device": str(device), "card": torch.cuda.get_device_name(device),
           "backend": backend, "cases": {}}
    seen, seen_h80 = {}, {}
    for name, path, batch in PAR_CASES + (PAR_H80,):
        start = torch.load(os.path.join(wd, name + "_start.pt"))
        cfg, state = _par_state(path, device, start)
        images, labels = parallel.shard_batch(
            mesh, *_par_batch(name, batch * mesh.data, device),
            spatial_axis=None)  # the rank's rows, whole samples
        step = make_train_step(cfg.loss, mesh=mesh)
        ref = torch.load(os.path.join(wd, name + "_ref.pt"))
        state.generator.manual_seed(TRAIN_SEED)
        reset_counts()
        with _record_shapes(seen_h80 if name == PAR_H80[0] else seen):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            _, metrics = step(state, images, labels)
            loss = metrics["loss"].item()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in c5.LAUNCHES.items() if v}
            check(abs(loss - ref["loss"]) <= LOSS_REL * abs(ref["loss"]),
                  "{} rank {}: loss {} vs one process {}".format(
                      name, mesh.rank, loss, ref["loss"]))
            rels = grad_rel_l2({n: p.grad.float().cpu() for n, p in
                                state.model.named_parameters()},
                               ref["grads"])
            worst = max(rels.items(), key=lambda kv: kv[1])
            check(worst[1] <= GRAD_REL_L2, "{} rank {}: gradient of {} off "
                  "by {} relative L2".format(name, mesh.rank, *worst))
            stats = state.model.state_dict()
            stat_err = max(scaled_err(stats[k].cpu(), v)
                           for k, v in ref["stats"].items())
            check(stat_err <= PAR_STAT_TOL, "{} rank {}: BN statistics off "
                  "by {}".format(name, mesh.rank, stat_err))
            # the eval forward through the fused op, on the one process's
            # stepped weights: only the sharding differs
            state.model.load_state_dict(torch.load(
                os.path.join(wd, name + "_stepped.pt")))
            state.model.eval()
            reset_counts()
            lo, hi = mesh.rows(batch)
            with torch.no_grad(), parallel.use_mesh(mesh):
                logits = state.model(mesh.keep_h(images))[0]
            eval_launches = {k: v for k, v in c5.LAUNCHES.items() if v}
        full = parallel.gather_h(logits, mesh, axis=2)
        agree = (torch.argmax(full, -1).to(torch.uint8).cpu() ==
                 ref["pred"][lo:hi]).float().mean().item()
        check(agree >= PAR_AGREE, "{} rank {}: eval argmax agreement {} "
              "with one process".format(name, mesh.rank, agree))
        check(eval_launches.get("conv5_fused_epilogue", 0) > 0,
              "{} rank {}: the eval forward launched no fused conv: "
              "{}".format(name, mesh.rank, eval_launches))
        out["cases"][name] = {
            "loss": loss, "loss_one_process": ref["loss"], "ms": ms,
            "worst_grad_rel_l2": list(worst), "bn_stat_scaled_err": stat_err,
            "eval_argmax_agreement": agree, "launches": launches,
            "eval_launches": eval_launches,
            "local_shape": list(mesh.keep_h(images).shape[:4]),
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 2 ** 30}
        del state, images, labels, logits, full, metrics, ref, start
        torch.cuda.empty_cache()
    out["host_loader"] = _par_host_rows(wd, mesh)
    out["graphed"] = {}
    if backend == "nccl":
        for name, path, batch in PAR_CASES:
            out["graphed"][name] = _par_graphed(name, path, batch, mesh,
                                                device, wd)
    # this rank's share of the distinct kernel shapes, against the plain
    # versions (every rank launched every one of them: the same shapes)
    keys = sorted(set(seen) | set(seen_h80), key=str)
    errs = {}
    for i, key in enumerate(keys):
        if i % mesh.world == mesh.rank:
            errs["{}:{}:{}:{}".format(i, key[0], list(key[1]), key[3])] = \
                _check_at_shape(key, TRAIN_SEED + i)
    out["shapes"] = [[k[0], list(k[1]), list(k[2]), k[3], n]
                     for k, n in ((k, seen[k]) for k in sorted(seen,
                                                              key=str))]
    out["h80_shapes"] = [[k[0], list(k[1]), list(k[2]), k[3], n]
                         for k, n in ((k, seen_h80[k])
                                      for k in sorted(seen_h80, key=str))]
    out["checked"] = errs
    out["distinct_shapes"] = len(keys)
    with open(os.path.join(wd, "rank{}.json".format(mesh.rank)), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _host_loader(wd, rows):
    """The host-mode loader over the parallel phase's seeded volumes
    (``PAR_HOST``) at the global batch, keeping ``rows``: a crop, a
    rotation and a flip drawn on the host, two worker threads."""
    from medicalseg_torch.core.loader import TrainLoader
    from medicalseg_torch.datasets import MedicalDataset
    from medicalseg_torch.transforms import RandomRotation3D
    phase0 = os.path.join(wd, "host")
    transforms = [RandomResizedCrop3D((16, 32, 24), scale=(0.8, 1.2)),
                  RandomRotation3D(20), RandomFlip3D()]
    dataset = MedicalDataset(phase0, phase0, transforms, 3)
    return TrainLoader(dataset, PAR_HOST["batch"], num_workers=2,
                       seed=TRAIN_SEED, mode="host", rows=rows)


def _write_host_data(wd):
    """``PAR_HOST``'s seeded volumes and labels with their list files, and
    the one-process host loader's first batches (``host_ref.pt``)."""
    phase0 = os.path.join(wd, "host")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(phase0, sub))
    rng = np.random.RandomState(TRAIN_SEED)
    lines = []
    for i in range(PAR_HOST["volumes"]):
        np.save(os.path.join(phase0, "images", "v{}.npy".format(i)),
                rng.rand(*PAR_HOST["shape"]).astype(np.float32))
        np.save(os.path.join(phase0, "labels", "v{}.npy".format(i)),
                rng.randint(0, 3, PAR_HOST["shape"]).astype(np.uint8))
        lines.append("images/v{0}.npy labels/v{0}.npy\n".format(i))
    with open(os.path.join(phase0, "train_list.txt"), "w") as f:
        f.writelines(lines)
    loader = _host_loader(wd, None)
    try:
        torch.save([next(loader) for _ in range(PAR_HOST["batches"])],
                   os.path.join(wd, "host_ref.pt"))
    finally:
        loader.stop()


def _par_host_rows(wd, mesh):
    """This rank's host-mode batches against its rows of the one-process
    loader's: bit for bit (fatal)."""
    ref = torch.load(os.path.join(wd, "host_ref.pt"))
    lo, hi = mesh.rows(PAR_HOST["batch"] // mesh.data)
    loader = _host_loader(wd, (lo, hi))
    try:
        got = [next(loader) for _ in range(PAR_HOST["batches"])]
    finally:
        loader.stop()
    same = [torch.equal(g[0], r[0][lo:hi]) and torch.equal(g[1], r[1][lo:hi])
            for g, r in zip(got, ref)]
    check(all(same), "rank {}: host-mode rows {} differ from the one "
          "process's ({})".format(mesh.rank, (lo, hi), same))
    return {"rows": [lo, hi], "batches": len(same), "bitwise": all(same)}


def _state_tensors(state):
    """Every tensor a step writes: parameters, BatchNorm statistics and the
    optimizer's slots, as copies."""
    out = {k: v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, slots in enumerate(state.optimizer.state.values()):
        for k, v in slots.items():
            if torch.is_tensor(v):
                out["opt{}.{}".format(i, k)] = v.detach().clone()
    return out


def _par_graphed(name, path, batch, mesh, device, wd):
    """The sharded step over the mesh (NCCL: a card a rank) from one start
    and one stream of cached batches, eager against its graphed forms:
    the cached step one step a dispatch, the cached step with [n, B]
    index rows (a dispatch of three, then a remainder of one) and the
    multi-step form (super-batches of two). Each rank's losses and every
    parameter, BatchNorm statistic and optimizer slot after each dispatch
    bit for bit the eager steps' (fatal), each form in
    ``PAR_GRAPH_STEPS - 1`` replays. For the first form also the host ms
    of a step both ways, one profiled step's device, NCCL and idle shares
    both ways (:func:`profile_call`), the replay's device ms (CUDA events)
    and the hand-kernel launches of a replay, which every form's graph
    holds alike."""
    steps = PAR_GRAPH_STEPS
    cfg, cache, stream, augment, new_state = _graph_inputs(
        path, PAR_SHAPES[name], 20 if name == "flagship" else 3,
        batch * mesh.data, steps, device, rows=mesh.rows(batch),
        start=torch.load(os.path.join(wd, name + "_start.pt")))
    eager_step = make_train_step(cfg.loss, augment_fn=augment, mesh=mesh)
    state = new_state()
    eager = _timed_steps(
        lambda i, idx: _eager_call(eager_step, state, cache, idx), stream,
        lambda: _state_tensors(state))
    eager_profile = profile_call(
        lambda: _eager_call(eager_step, state, cache, stream[0]))
    del state
    torch.cuda.empty_cache()

    def cached_call(run, rows):
        return run(state, *cache, rows, seed=TRAIN_SEED)

    def multi_call(run, rows):
        idx = torch.from_numpy(rows).long().to(device)
        return run(state, cache[0][idx], cache[1][idx], seed=TRAIN_SEED)

    # (form, its step, its dispatches, how a dispatch calls it); each step
    # made when its form runs, so that one graph is alive at a time
    forms = (("cached", lambda: make_cached_train_step(
                 cfg.loss, 1, augment_fn=augment, mesh=mesh),
              list(stream), cached_call),
             ("cached_3", lambda: make_cached_train_step(
                 cfg.loss, 3, augment_fn=augment, mesh=mesh),
              [stream[:3], stream[3:]], cached_call),
             ("multi_2", lambda: make_multi_step(
                 cfg.loss, 2, augment_fn=augment, mesh=mesh),
              [stream[:2], stream[2:]], multi_call))
    out = {"steps": steps, "local_batch": stream.shape[1],
           "local_shape": [stream.shape[1], PAR_SHAPES[name][0],
                           PAR_SHAPES[name][1] // mesh.space,
                           PAR_SHAPES[name][2]],
           "eager_losses": eager["loss"], "eager_ms_each": eager["ms"],
           "eager_ms_per_step": float(np.median(eager["ms"][1:])),
           "eager_profile": _profile_line(eager_profile)}
    for form, make, dispatches, call in forms:
        run, state = make(), new_state()
        got = _timed_steps(
            lambda i, rows: call(run, rows)[1], dispatches,
            lambda: all(torch.equal(v, eager["after"][state.step - 1][k])
                        for k, v in _state_tensors(state).items()))
        graph = run.graphed
        bitwise = got["after"] + [got["loss"] == eager["loss"]]
        check(graph.replays == steps - 1 and state.step == steps,
              "{} {} rank {}: {} replays in {} steps".format(
                  name, form, mesh.rank, graph.replays, state.step))
        check(all(bitwise), "{} {} rank {}: the graphed sharded step is not "
              "the eager one bit for bit (after each dispatch, losses: {}; "
              "losses {} vs {})".format(name, form, mesh.rank, bitwise,
                                        got["loss"], eager["loss"]))
        launches = {k: v for k, v in graph.launches.items() if v}
        if form == "cached":
            check(sum(launches.values()) > 0, name + ": the graph holds no "
                  "hand kernel")
            out.update({
                "graphed_losses": got["loss"], "bitwise": bitwise,
                "graphed_ms_each": got["ms"],
                "graphed_ms_per_step": float(np.median(got["ms"][1:])),
                "graphed_profile": _profile_line(profile_call(
                    lambda: call(run, stream[0]))),
                "replay_device_ms": time_ms(graph.graph.replay, reps=3),
                "launches_per_replay": launches})
        else:
            check(launches == out["launches_per_replay"], "{} {}: {} "
                  "launches a replay, the cached step's {}".format(
                      name, form, launches, out["launches_per_replay"]))
            out[form] = {"losses": got["loss"], "bitwise": bitwise,
                         "ms_each": got["ms"]}
        del state, run, graph
        torch.cuda.empty_cache()
    return out


def _profile_line(prof):
    """The parallel line's share of :func:`profile_call`'s figures."""
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "nccl_ms",
                                 "idle_share")}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(wd):
    """Start the :data:`PAR_WORLD` ranks of :func:`parallel_rank`, wait for
    all, and return their JSON; any rank's failure (or the time limit)
    kills the others and raises with the ranks' output."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(PAR_WORLD),
               LOCAL_WORLD_SIZE=str(PAR_WORLD))
    logs = [open(os.path.join(wd, "rank{}.log".format(r)), "w+")
            for r in range(PAR_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank", wd],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(PAR_WORLD)]
    deadline = time.time() + PAR_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for r, f in enumerate(logs):
        f.seek(0)
        tails.append("--- rank {} rc {} ---\n{}".format(
            r, procs[r].returncode, f.read()[-3000:]))
        f.close()
    check(all(p.returncode == 0 for p in procs),
          "parallel ranks failed:\n" + "\n".join(tails))
    out = []
    for r in range(PAR_WORLD):
        with open(os.path.join(wd, "rank{}.json".format(r))) as f:
            out.append(json.load(f))
    return out


def _torchrun(args, nproc=2, timeout=600):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> <args>``: its output, after a fatal check of its exit code."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc)] + args
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    # the first traceback of any rank, beside the end of the output (where
    # the launcher's report of the ranks it ended stands)
    first = proc.stderr.find("Traceback")
    check(proc.returncode == 0, "{} exited {}:\n{}\n{}\n...\n{}".format(
        " ".join(args[:2]), proc.returncode, proc.stdout[-3000:],
        proc.stderr[first:first + 4000] if first >= 0 else "",
        proc.stderr[-3000:]))
    return proc.stdout + proc.stderr, time.time() - t0


def _logged_dice(text):
    lines = [ln for ln in text.splitlines() if "[EVAL] #Images" in ln]
    check(len(lines) >= 1, "no [EVAL] line in:\n" + text[-3000:])
    return float(lines[-1].split("Dice: ")[1].split(",")[0]), lines


def phase_parallel():
    """The data x space process mesh (module docstring, ``parallel``)."""
    line = {"phase": "parallel", "gpu": smi_line(),
            "device_count": torch.cuda.device_count(), "world": PAR_WORLD,
            "data": PAR_WORLD // PAR_SPACE, "space": PAR_SPACE}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        line["one_process"] = {
            name: _par_reference(name, path, batch * PAR_WORLD // PAR_SPACE,
                                 wd)
            for name, path, batch in PAR_CASES + (PAR_H80,)}
        _write_host_data(wd)
        t0 = time.time()
        ranks = _run_ranks(wd)
        line["ranks_seconds"] = time.time() - t0
    line["backend"] = ranks[0]["backend"]
    line["rank_devices"] = [r["device"] for r in ranks]
    for name, _, _ in PAR_CASES:
        kernels = set(ranks[0]["cases"][name]["launches"])
        for key in ("conv5_head", "conv5_stem_tc", "pin", "conv5_dgrad",
                    "conv5_wgrad_stem_tc"):
            check(key in kernels, "{}: {} never launched on rank 0".format(
                name, key))
        check(any(k.startswith("conv5_wgrad_") and k != "conv5_wgrad_stem_tc"
                  for k in kernels), name + ": no square weight gradient")
        for r in ranks:  # every rank launched the same kernels as often
            check(r["cases"][name]["launches"] ==
                  ranks[0]["cases"][name]["launches"],
                  "{}: rank {} launched {} where rank 0 launched {}".format(
                      name, r["rank"], r["cases"][name]["launches"],
                      ranks[0]["cases"][name]["launches"]))
        line[name] = {k: [r["cases"][name][k] for r in ranks]
                      for k in ranks[0]["cases"][name]}
    shapes = ranks[0]["shapes"]
    check(all(r["shapes"] == shapes for r in ranks),
          "the ranks launched the kernels at different shapes")
    # every conv launch of the mesh ran on an H block plus its 2 x 2 halo
    # rows: H - 4 is the block, a power of two at every level of both cases
    convs = [s for s in shapes if s[0] != "pin"]
    check(all((s[1][3] - 4) & (s[1][3] - 5) == 0 for s in convs),
          "conv launches off the halo'd shapes: {}".format(convs))
    check({s[0] for s in convs} == {"fwd", "dgrad", "wgrad"} and
          any(s[1][3] == EDGE // PAR_SPACE + 4 for s in convs),
          "no conv kernel ran at the halo'd cube shape")
    checked = {}
    for r in ranks:
        checked.update(r["checked"])
    check(len(checked) == ranks[0]["distinct_shapes"], "{} of {} shapes "
          "held to the plain versions".format(len(checked),
                                               ranks[0]["distinct_shapes"]))
    line["kernel_shapes"] = shapes
    line["kernel_shape_errors"] = checked
    line["cube_h80"] = _par_h80_line(ranks)
    check(all(r["host_loader"]["bitwise"] for r in ranks),
          "host-mode rows differ from the one process's")
    line["host_loader"] = [r["host_loader"] for r in ranks]
    line["graphed"] = _par_graphed_line(ranks)
    line["torchrun"] = _phase_parallel_cli()
    emit(line)
    return line


def _par_h80_line(ranks):
    """The H = 80 case across the ranks: the same launches on every rank,
    the fused eval conv among them, and its own kernel shapes: the
    H-sharded levels' blocks with their 2 x 2 halo rows (44, 24, 14 and 9
    rows) and the replicated deepest level's whole 5 rows (no halo), each
    held to its plain version in the ranks (``kernel_shape_errors``)."""
    name = PAR_H80[0]
    for r in ranks:
        check(r["cases"][name]["launches"] ==
              ranks[0]["cases"][name]["launches"],
              "{}: rank {} launched {} where rank 0 launched {}".format(
                  name, r["rank"], r["cases"][name]["launches"],
                  ranks[0]["cases"][name]["launches"]))
    shapes = ranks[0]["h80_shapes"]
    check(all(r["h80_shapes"] == shapes for r in ranks),
          name + ": the ranks launched the kernels at different shapes")
    rows = {s[1][3] for s in shapes if s[0] != "pin"}
    check(rows == {44, 24, 14, 9, 5}, "{}: conv launches at H rows {}, not "
          "the halo'd blocks 44, 24, 14, 9 and the replicated 5".format(
              name, sorted(rows)))
    out = {k: [r["cases"][name][k] for r in ranks]
           for k in ranks[0]["cases"][name]}
    out["kernel_shapes"] = shapes
    return out


def _par_graphed_line(ranks):
    """The graphed cached step's results across the ranks (NCCL), or why
    it did not run."""
    if ranks[0]["backend"] != "nccl":
        count = torch.cuda.device_count()
        return "not run: {}, {}".format(ranks[0]["backend"], "one card" if
                                        count == 1 else "{} cards".format(
                                            count))
    out = {}
    for name, _, _ in PAR_CASES:
        per = [r["graphed"][name] for r in ranks]
        check(all(p["launches_per_replay"] == per[0]["launches_per_replay"]
                  for p in per), name + ": the ranks' replays launch "
              "different kernels")
        check(all(all(b) for p in per for b in (
            p["bitwise"], p["cached_3"]["bitwise"], p["multi_2"]["bitwise"])),
              name + ": a replay is not the eager sharded step bit for bit")
        out[name] = {k: [p[k] for p in per] for k in per[0]}
    return out


def _phase_parallel_cli():
    """``torchrun`` with two ranks: the train CLI at ``--space 2`` on the
    cube config for three iterations with ``--do_eval``, then the val CLI
    over the two ranks against the one-process val CLI."""
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        json_path = write_eval_data(wd)
        cfg = Config(LUNG_TPU).dic
        cfg["data_root"] = wd
        for key in ("train_dataset", "val_dataset"):
            cfg[key]["dataset_root"] = "phase0"
            cfg[key]["result_dir"] = "phase1"
        cfg["val_dataset"]["dataset_json_path"] = json_path
        yml = os.path.join(wd, "lung.yml")
        import yaml
        with open(yml, "w") as f:
            yaml.safe_dump(cfg, f)
        run = os.path.join(wd, "train")
        text, secs = _torchrun([
            "-m", "medicalseg_torch.train", "--config", yml, "--space", "2",
            "--iters", "3", "--save_interval", "3", "--log_iters", "1",
            "--batch_size", "1", "--do_eval", "--seed", str(TRAIN_SEED),
            "--save_dir", run])
        train_lines = [ln for ln in text.splitlines() if "[TRAIN]" in ln]
        check(len(train_lines) == 3 and "iter: 3/3" in train_lines[-1],
              "torchrun train logged {}".format(train_lines))
        backend = [ln.split("[INFO]")[-1].strip()
                   for ln in text.splitlines() if "process group:" in ln]
        check(len(backend) == 1, "torchrun train: {}".format(backend))
        model_path = os.path.join(run, "iter_3", ckpt.MODEL_FILE)
        check(os.path.exists(model_path) and os.path.exists(
            os.path.join(run, "best_model", "best.json")),
            "torchrun train wrote no iter_3 / best_model")
        train_dice, _ = _logged_dice(text)
        out["train"] = {"seconds": secs, "process_group": backend[0],
                        "train_lines": train_lines,
                        "eval_mdice": train_dice}
        text, secs = _torchrun([
            "-m", "medicalseg_torch.val", "--config", yml, "--model_path",
            model_path, "--save_dir", os.path.join(wd, "val2")])
        dice2, lines = _logged_dice(text)
        with TrainLog("[EVAL]"):
            one = val_cli.main(val_cli.parse_args([
                "--config", yml, "--model_path", model_path, "--save_dir",
                os.path.join(wd, "val1")]))
        check(abs(dice2 - one["mdice"]) <= PAR_MDICE_TOL,
              "torchrun val mDice {} vs one process {}".format(
                  dice2, one["mdice"]))
        check_dump(os.path.join(wd, "val2"), 2)  # rank 0's share
        out["val"] = {"seconds": secs, "eval_line": lines[-1],
                      "mdice_two_ranks": dice2,
                      "mdice_one_process": one["mdice"]}
        torch.cuda.empty_cache()
        # host-mode loading: the recipe's crop, rotation and flip drawn on
        # the host by two loader threads a rank
        run = os.path.join(wd, "host")
        text, secs = _torchrun([
            "-m", "medicalseg_torch.train", "--config", yml, "--space", "2",
            "--iters", "2", "--save_interval", "2", "--log_iters", "1",
            "--batch_size", "1", "--loader_mode", "host", "--num_workers",
            "2", "--seed", str(TRAIN_SEED), "--save_dir", run])
        train_lines = [ln for ln in text.splitlines() if "[TRAIN]" in ln]
        check(len(train_lines) == 2 and "iter: 2/2" in train_lines[-1],
              "torchrun host-mode train logged {}".format(train_lines))
        check("TrainLoader mode: host" in text and os.path.exists(
            os.path.join(run, "iter_2", ckpt.MODEL_FILE)),
            "torchrun host-mode train: no host loader or no iter_2")
        out["train_host"] = {"seconds": secs, "train_lines": train_lines}
    return out


def main():
    phase_device()
    phase_build()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    phase_native()
    stats = phase_kernels()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        write_deploy(wd)
        launches = phase_serve(wd)
        phase_export(wd)
        stats.update(phase_kernels_ingest())
        raw_launches, scan = phase_serve_raw(wd)
        launches["hu_resize"] = raw_launches["hu_resize"]
        phase_serve_swl(wd, scan)
        phase_prep(wd)
    stats.update(phase_kernels_bwd())
    train_launches = phase_train()
    launches.update({k: train_launches[k] for k in BWD_KERNELS})
    f32_launches = phase_train_f32()
    launches.update({k: f32_launches[k] for k in F32_KERNELS})
    spine_launches = phase_train_spine()
    launches.update({k: spine_launches[k] for k in SPINE_KERNELS})
    spine_f32, vnet_step = phase_train_spine_f32()
    torch.cuda.empty_cache()  # its 25-30 GB, kept by the allocator
    for key in F32_KERNELS:
        check(spine_f32[key] > 0, key + " never launched on the f32 spine "
              "recipe's path")
    deepsup_f32 = phase_train_deepsup_spine_f32(vnet_step)
    torch.cuda.empty_cache()
    for key in F32_KERNELS:
        check(deepsup_f32[key] > 0, key + " never launched on the f32 "
              "deep-sup spine recipe's path")
    phase_augment()
    flagship = phase_train_flagship()
    phase_train_graph()
    cli = phase_train_cli()
    phase_eval()
    phase_parallel()
    for key in FLAGSHIP_KERNELS:
        check(flagship[key] > 0 and cli[key] > 0, key + " never launched "
              "on the flagship's path")
    kernels = []
    for key, s in stats.items():
        check(launches[key] > 0, key + " never launched on the main path")
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": launches[key],
            "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": max(s["bound_by"], key=s["bound_by"].get),
            "library_ms": s["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-rank":
        parallel_rank(sys.argv[2])
    else:
        main()
