#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``evam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result line:

1. device   — a CUDA device of compute capability 9.0; prints its name
              and power limit as ``nvidia-smi`` gives them.
2. build    — compiles every kernel under ``evam_tpu_torch/csrc`` with
              nvcc (one process per source, in parallel) into
              ``build/kernels/``, and the host library
              (``csrc/evam_media.cpp``) with g++ into ``build/native/``,
              and prints the seconds it took.
3. qgemm    — the int8 GEMM kernel against its plain version at the ten
              shapes one SSD-512 forward gives it (8 images, bf16), the
              three of one classifier forward on 8 × 8 and on 8 crops
              (72², width 32: the largest and smallest engine bucket,
              aligned and masked), the packed classifier's three at
              U = 512 and U = 32 crops (its buckets 128 and 8), the
              ragged shapes (bf16 and float32:
              every edge of the tiling, K = 2048 whole and in chunks)
              and M = 0: identical int8 codes and row scales, identical
              outputs; the ten SSD shapes must take the aligned variant. Kernel,
              plain-version and library times — wall: median of
              CUDA-event timings of 20 back-to-back calls; device:
              kernel time from torch.profiler, back to back and with
              the L2 flushed before every call — the bound, and
              ``bound_share`` = bound / flushed device time.
              The library yardstick is torch's cheapest correct
              quantize (float32 division by a tensor), ``torch._int_mm``
              and the dequantize; ``_int_mm`` on its own is timed too.
              One JSON line per shape, then the sums over one SSD
              forward, one classifier forward (each bucket) and one
              fused forward (SSD + classifier at 8 × 8 crops).
4. reference — the INT8 detector at a small size (64×64, width 8) and
              the INT8 classifier (width 8) on the card with the kernel
              against the same weights on the CPU through the plain
              version: outputs within 1e-2 of the reference's max
              magnitude.
5. weights  — the models-dir layout on the card: the INT8 SSD (512²,
              width 32) and the action decoder saved with the port's
              ``save_weights``, then loaded through
              ``ModelRegistry(models_dir=..., allow_random_weights=False)``
              with the ``msgpack`` package blocked (the port's
              standard-library codec); every tensor and the forward
              outputs on one input equal.

Every serving phase runs the reference's default engine (the
``Settings`` defaults; the engines warm themselves: each waits until
every bucket is captured before it counts), and prints the device
memory the allocator holds once it has stopped its engines.

6. slice    — the port's main path at full width: EVAM_PRECISION=int8,
              EVAM_QGEMM=pallas, person_vehicle_bike at 512×512, width
              32, seeded random weights. STREAMS (8) synthetic 512×512
              streams × FRAMES (32) frames go StreamRunner →
              DetectStage → EngineHub's shared BatchEngine →
              metaconvert → publish. Every frame
              must be published once, in order; the kernel must have
              launched exactly 10 times per forward, all of them on the
              aligned variant; one batch's packed
              output and loc/conf must agree with the same step run with
              the plain qgemm on the card. Prints fps, occupancy, p50/p99
              frame latency and the engine's stage times.
7. classify — the detect+classify pipeline (pipelines/
              object_classification/vehicle_attributes, built as the
              server builds it) at full width: SSD 512² width 32, the
              classifier 72² width 32 with heads color 7 and type 4,
              INT8, pallas. First one batch of 8 frames through the fused
              step with the kernel and with the plain qgemm on the card:
              detections matched (≥ 95 % at IoU ≥ 0.9), the same rows
              unclassified, probabilities within 1e-2. Then STREAMS ×
              FRAMES frames fused (13 launches per forward: the SSD's 10
              and the classifier's 3) and unfused (reclassify-interval
              3: 10 per detect and 3 per classify forward); every frame
              published in order, stream 0's objects carrying color and
              type; masked launches only where the classifier's M is
              ragged. Prints fps, p50/p99, occupancy and unit occupancy.
8. engine   — the reference's default engine against today's eager
              one, on one registry: hub A (the ``Settings`` defaults:
              slot staging in page-locked memory, pipelined transfer,
              every bucket warmed and captured as a CUDA graph,
              supervised; watchdog budget 5 s) and hub B (legacy
              assembly, inline transfer, no warmup: every batch eager)
              each serve detect (person_vehicle_bike) and fused
              detect+classify (vehicle_attributes) to STREAMS × FRAMES
              frames twice: "cold" (hub A's streams start while its
              buckets are captured) and "warm". Every published object
              bit-equal to hub B's cold run; one bucket's replay
              bit-equal to its eager step, with 10 / 13 launches; every
              bucket captured; 10 launches per detect and 13 per fused
              forward counted through the replays (a warm run counts as
              a forward). Prints each run's stage clock (all eight
              stages), fps, p50 / p99, capture seconds and graph-pool
              bytes; each hub's device busy share over a profiled run
              of each cell, and one thread's host cost per frame
              (source, encode). Then a stub wedge on hub A's detect
              engine (its launches block on a host event): the stranded
              frame fails with TimeoutError, /healthz walks 503
              ``stalled`` → ``restarting`` → 200 ``ok``, and the rebuilt
              engine, its graphs captured again, answers the same frame
              with the same bits. Per bucket, the seconds of its first
              eager step and of its graph capture (the slice phase's
              engine, the first of the process; hub A's; and a second
              detect engine built after them): the input of the AOT
              cache's design. Last, a capture's cuBLAS workspaces: a
              GEMM step captured by ``StepGraphs``, then run eagerly on
              the capture's thread and stream, allocates workspaces of
              its own (it shares none with the graph's replays), and a
              replay agrees with it within 1e-5 × its largest value.
9. track    — the tracking pipeline (pipelines/object_tracking/
              person_vehicle_bike: detect+classify fused into one
              engine, then the IoU tracker) at the same full width, INT8,
              pallas: STREAMS × FRAMES frames served; 13 launches per
              fused forward; every published object carries an id, some
              id persists across frames, some objects carry color and
              type. Then the same traffic one frame at a time (every
              forward a batch of one), with the kernel and with the
              plain qgemm on the card: the same objects, labels, ids and
              attribute labels on every frame, boxes within 1e-3 and
              confidences within 1e-2. Prints fps and p50/p99.
10. gate    — pipelines/object_detection/person_vehicle_bike with
              ``inference-interval: "adaptive"``, the same traffic: per
              stream ran + skipped = FRAMES, the run/skip sequence equal
              to a host-only replay of the port's MotionGate over the
              same frames, the detect engine's forwards carrying exactly
              the ran frames (10 launches per forward), and the gate
              registry's totals (the /healthz ``gate`` block) equal to
              the stages'. Prints the skip rate and fps beside the
              slice phase's ungated fps.
11. ragged  — vehicle_attributes unfused (reclassify-interval 3: a
              detect and a classify engine) at full width, INT8, pallas,
              STREAMS × FRAMES frames on hub "dense" (EVAM_RAGGED off)
              and hub "packed" (one registry; the detection threshold
              the highest at which most frames carry 1–8 vehicles).
              Every frame published in order on both; the packed hub's
              engines on the ladder [1, 2, 8, 32, 128], every bucket
              captured; 10 launches per detect and 3 per classify
              forward; published detections equal on ≥ 95 % of frames
              and their attributes' confidences within 2e-2; the packed
              step against the dense one on the card (float32 within
              1e-5, INT8 within 2e-2, the same argmax wherever the dense
              top-2 margin exceeds the tolerance, pad rows exactly 0);
              a packed bucket's replay bit-equal to its eager step.
              Prints, per hub and engine, fps, p50/p99, occupancy, unit
              occupancy, graph-pool bytes and the eight stage ms. Then
              two oversize batches on the card: a legacy-assembly
              engine whose ladder is shrunk to [2, 4] under max_batch
              16 (10 items), and a packed scheduler engine whose class
              pick (8 items of 8 units) overflows the top unit block
              (32 rows): every result equal to the step run once on the
              unsplit batch, oversize_splits >= 1 in the engine's stats
              and its /engines row, the dispatch thread alive.
12. sched   — the detect path on the default engine with EVAM_SCHED=1,
              4 realtime and 4 batch streams: every frame published in
              order; then a batch staleness budget of SHED_BATCH_MS:
              every frame published once, in order, or counted as shed,
              the per-class sheds of /healthz and /scheduler equal to
              the streams'; then the scheduler off on the same traffic.
              No engine stalled or restarted. Prints per-class p50/p99,
              the stage clock and admission's capacity for each run.
13. tune    — EVAM_TUNE=1 (EVAM_TUNE_INTERVAL_S=0.25,
              EVAM_TRANSFER_DEPTH pinned) over the packed unfused
              vehicle_attributes path: at least 3 ticks, every applied
              action with its reason on /scheduler, the pinned knob
              neutral. Prints the operating point tick by tick.
14. native  — the host encode in the native library
              (``evam_tpu_torch/native.py``: ``csrc/evam_media.cpp``
              built with g++ -fopenmp in the build phase): byte-equal to the numpy copies for
              ``resize_bgr_to_i420`` 1080×1920 → 512² and → 432×768,
              ``resize_bgr``, ``bgr_to_i420`` and ``luma_grid``, at odd
              sizes and without a resize; ms per frame of the 1080p →
              512² encode, native against numpy, on one thread and on 8
              threads at once. Then the detect and the fused cell served
              from STREAMS synthetic 1080p streams × FRAMES frames
              (every frame resized on its stream's thread) with the
              policy on (this host's cores) and with EVAM_NO_NATIVE=1:
              equal objects (bit-equal, or within the track phase's
              tolerance where batches formed otherwise, and reported),
              10 / 13 launches per forward; fps, p50 / p99, the eight
              stage ms and the device busy share of a profiled run, for
              both.
15. fleet   — EVAM_FLEET=sharded through ``PipelineRegistry`` on this
              machine's devices (one card: degraded to off, printed);
              then a FleetEngine of two shards on cuda:0 through the
              hub's device list (``max_batch`` FLEET_MAX_BATCH, each
              shard's ladder to half of it) against a single engine:
              each stream's objects bit-equal one frame at a time (both
              bucket 1), each stream pinned where the placer says, all
              streams at once within the track phase's tolerance (the
              largest difference printed) with 10 launches per forward
              split by shard; IMAGES batch-class frames on the mesh
              twin (its bucket split over the two devices' replicas and
              gathered) matching the single engine's detections; the
              controller (EVAM_FLEET_MAX_SHARDS 2) draining a shard at
              low utilization and growing it back, captured before it
              joins, at high; then a shard wedged past its restart
              budget (0) with the engine phase's stub: degraded, retired,
              its stream re-placed, the rebalances printed.
16. action  — action_recognition/general at full width (encoder 224²,
              width 32, embed 512; decoder dim 512, depth 4, 8 heads,
              400 classes). First the card against the CPU on the same
              seeded float32 weights (TF32 off): embeddings, logits and
              probabilities within 1e-4 × the CPU's max magnitude, top-1
              equal wherever the CPU's top-2 margin exceeds twice that.
              Then 4 synthetic 512² streams × 48 frames served INT8
              (the float modules in bfloat16, as the reference runs
              them) through the pipeline's stages → StreamRunner: no
              tensors before frame 16 of a stream, then one 400-long
              ``action`` tensor a frame; zero qgemm launches. Prints
              fps, p50/p99 and both engines' occupancy, launch and
              readback ms.
17. audio   — audio_detection/environment: AclNet at 16000 samples,
              width 32, 53 classes, card against CPU the same way; then
              4 ``synthetic-audio://seconds=5`` streams served INT8 at
              sliding-window 0.2, threshold 0: a ``detection`` tensor on
              exactly the chunks a host replay of the stride rule gives,
              the engine's items equal to the windows; zero qgemm
              launches. Prints windows/s and the windows' p50/p99.
18. ir      — real-model import: ``python -m evam_tpu_torch.cli.main
              fetch-models --synthesize-omz omz --topology manifest``
              (a subprocess) writes the nine manifest IRs, and the
              script a YOLOv3-tiny-shaped IR (416², two RegionYolo
              heads, 80 classes). Every IR at float32 on the card and on
              the CPU (TF32 off): raw outputs within FP32_RTOL × max;
              the YOLO IR's detect step on both, ≥ 90 % of the CPU's
              detections matched. One IR SSD forward (512², width 32) at
              bucket IR_BUCKET: EVAM_IR_LAYOUT nhwc / nchw and
              EVAM_DWCONV lax / shift agree at float32, then each timed
              in bfloat16. Served from the IR models dir at the slice's
              INT8 configuration (the IRs serve bfloat16 float
              weights): person_vehicle_bike (the IR SSD at full width)
              and vehicle_attributes fused (both models IR), STREAMS ×
              FRAMES frames each, twice, on hub A (defaults, every
              bucket captured first) and hub B (eager): every frame
              published in order, every run's objects bit-equal to hub
              B's first (else held to the track phase's tolerance and
              the difference printed), fps, p50/p99, the eight stage ms
              and hub A's profiled busy share; action_recognition/general (the
              encoder and TensorIterator decoder IRs, 4 × 24 frames)
              and audio_detection/environment (AclNet IR, 2 × 3 s) on
              hub A, every bucket captured. Zero qgemm launches on
              every IR engine.
19. rest    — the same path through the port's REST server
              (``evam_tpu_torch.server.app``) on a free 127.0.0.1 port, in
              a thread: STREAMS POSTs to
              /pipelines/object_detection/person_vehicle_bike, each a
              synthetic 512×512 stream of FRAMES frames into a file
              destination, polled on /pipelines/status until COMPLETED.
              Every file must hold FRAMES lines in timestamp order, each
              of the shape of tests/golden/message_eva_metadata.json;
              /engines must show one shared detect engine; the kernel
              must have launched 10 times per forward, all aligned; stream
              0's objects must match the slice phase's (≥ 95 % at IoU ≥
              0.9); one vehicle_attributes stream of FRAMES frames must
              complete on a fused engine with 13 launches per forward and
              objects carrying color and type; one object_zone_count
              stream (a whole-frame zone) must publish, on every frame
              with objects, one zone-count event counting them all, and
              one object_line_crossing stream (two lines) objects that
              all carry an id, its line-crossing UDF holding their
              anchors, both on the shared detect engine at 10 launches
              per forward; one action_recognition/general stream (24
              frames) and one audio_detection/environment stream (3 s)
              must complete with lines of the golden's shape, action
              tensors from frame 16 and detections on the replayed
              windows, and no qgemm launch; DELETE on a long stream
              must give ABORTED; an unknown pipeline and a body without
              a source must answer 404 and 400; a stream with a
              ``webrtc`` frame destination and ENABLE_WEBRTC off must
              be served, the destination ignored, as in the reference.
              The engine is built (``PipelineRegistry.preload``, the
              EVAM_PRELOAD path) and warmed before the clock starts.
20. serve   — the real entry point, ``python3 -m
              evam_tpu_torch.cli.main serve``, as a subprocess on a free
              REST_PORT with EVAM_PRELOAD=object_detection/
              person_vehicle_bike, EVAM_RAGGED=packed, EVAM_SCHED=1,
              EVAM_TUNE=1 and EVAM_SCHED_CAPACITY_FPS=SERVE_CAPACITY_FPS:
              /healthz answers 200 ``ok`` (the preloaded engine built
              and its 5 buckets captured), one realtime 8-frame
              person_vehicle_bike stream completes with 10 aligned
              launches per forward (the child's counts, read from its
              /metrics), then batch 8-frame vehicle_attributes streams,
              fused (13 per forward) and unfused (3 per forward of the
              packed classify engine), on engines their POSTs build, and
              a realtime unfused one once they are warm, objects carrying
              color and type; /scheduler holds the route golden; a
              1000 fps start answers 503 with Retry-After; GET /traces
              answers 200 in the shape of tests/golden/route_traces.json;
              SIGTERM ends the process with 0 in 30 s.
21. eii     — EII mode at the slice's configuration, on the default
              settings (the scheduler on, as in the reference): a
              registry's detect engine warmed, then the EVA path's
              objects for EII_FRAMES (64) synthetic 768×432 frames;
              (a) an ``EiiManager`` with a decoder source and a zmq_tcp
              publisher (PNG level 3): the port's ``MsgBusSubscriber``
              receives all 64 messages in order, each in the shape of
              tests/golden/message_eii_msgbus.json, its PNG decoded by
              ``decode_frame`` pixel-equal to the source's frame, its
              ``gva_meta`` and objects bit-equal to the EVA path's;
              (b) 64 raw 1080p BGR frames at 30 fps over zmq_ipc
              through the port's ``MsgBusPublisher`` into a manager with
              ``source: msgbus``: one result per frame, in order, no
              ingest drop; 10 aligned launches per forward in both;
              (c) ``python -m evam_tpu_torch.cli.main serve --mode EII``
              as a child (``EVAM_EII_CONFIG``): time to its first
              message, then SIGTERM → exit 0 in 30 s. Each manager's
              start is held until a probe on its publisher reaches the
              subscriber (a PUB drops what it sends before a
              subscription arrives). Prints messages/s of (a) and (b),
              the first-message seconds of (c) and the drops.
22. trace   — person_vehicle_bike on hub A (the default engine), STREAMS
              × TRACE_FRAMES (128) frames at 512², INT8, EVAM_QGEMM=pallas,
              served six times in one process with EVAM_TRACE on, off,
              on, off, on, off (set explicitly; the same seeds): objects
              bit-equal; every
              bucket captured with tracing on; 10 launches a forward;
              the ring's ``traces_payload()`` in the shape of
              tests/golden/route_traces.json, every retained frame with
              ``stage.*``, ``sched.queue_wait`` and ``engine.dispatch``
              spans, every batch record naming its engine, ``cuda:0``,
              the eight stages and ``"launch": "host_issue"``; then with
              PROFILING_MODE's ranges on, a torch.profiler capture
              (every thread) of two served streams shows
              ``evam.<stage>`` for the eight stages and ``evam.step``.
              Prints each run's fps, p50/p99 and stage ms, the medians'
              ratio and differences on against off, and the batch
              records' mean launch and readback ms.
23. chaos   — object_tracking/person_vehicle_bike (fused, 13 launches a
              forward) through a ``PipelineRegistry`` built from
              ``Settings`` with EVAM_CKPT=1, EVAM_CKPT_INTERVAL=4 and
              EVAM_STALL_TIMEOUT_S=3: 4 streams at 30 fps; once each has
              published 8 frames, EVAM_FAULT_INJECT=wedge=1,wedge_n=1,
              wedge_s=8 with EVAM_FAULT_SEED=7 is armed and the next
              batch wedges (its launcher asleep under the engine's
              device lock). The watchdog trips; the supervisor writes
              one flight artifact whose pending row for the wedged
              batch names ``h2d_wait`` as its last stage (the wedge
              sits in the launch), captures every stream at the
              ``pre_rebuild`` barrier, rebuilds the engine and captures
              its buckets again. The streams go down with the engine
              and restart from their ``pre_rebuild`` checkpoints: every
              id a restarted stream issues that was not a live track of
              its checkpoint is above every id it published before.
              Then ``serve`` as a child with EVAM_STATE_DIR and
              EVAM_CKPT=1: one tracking stream, SIGTERM after 16
              published frames, the child started again: ``resume()``
              restarts the stream, its status carries
              ``checkpoint.restored_from`` with barrier ``drain``, and
              every new id is above the highest before. Prints the
              rebuild and restore seconds and the phase's wall time.

24. ingest  — person_vehicle_bike (hub A, INT8, pallas, 512², width 32)
              fed by RTSP cameras and files, with no cv2 on the path:
              (a) the JPEG codec's and the I_PCM reader's ms a frame
              (1080p q80 encode and decode, 720p I_PCM, on one thread),
              the codec deterministic and its round trip above a PSNR
              floor (JPEG_PSNR_FLOOR, IPCM_PSNR_FLOOR), one annotate +
              encode of a relay frame; (b) 8 emulated cameras on the
              port's RtspServer (INGEST_CAMS: 6 MJPEG 1920×1080 q80, 2
              I_PCM H.264 1280×720; 30 fps, INGEST_FRAMES each, encoded
              before the clock) served through a PipelineRegistry with
              EVAM_RTSP_DEMUX_WORKERS=4: fps, p50/p99 and drops by stage
              per codec, the demux's threads (1 + workers), the stage
              clock, 10 launches a forward, and the first INGEST_KEEP
              decoded frames of every camera pushed again through
              AppSources: the same objects (equal, else ≥ 0.99 matched
              at IoU 0.9); with ``--profile`` the device-busy share;
              (c) ``serve`` as a child with ENABLE_RTSP=1 and the shared
              demux and pool (2 workers each): two camera streams, the
              first re-streamed annotated at ``cam0-out`` and read back
              with the port's RtspDemux (RESTREAM_FRAMES frames), lines
              in the golden's shape, an ``.h264`` and an ``.mjpeg`` file
              COMPLETED through the pool, SIGTERM → exit 0.
25. webrtc  — person_vehicle_bike (hub A, INT8, pallas, 512², width 32)
              published to WebRTC viewers, with no cv2, cryptography or
              websockets on the path: (a) the port's VP8 encoder's ms a
              frame (keyframe, and an inter frame of the same scene) at
              640×360 and 1280×720 on one thread, bytes a frame, the
              reconstruction's PSNR above VP8_PSNR_FLOOR, SRTP protect µs
              a packet, one DTLS handshake's ms, and which libssl and
              libcrypto were loaded (and whether ``openssl`` is on
              PATH); (b) a PipelineRegistry with ENABLE_WEBRTC and the
              port's signalling server on 127.0.0.1, one stream with
              ``frame: {type: webrtc, peer-id: cam0}``: two key-mode
              viewers (the port's primitives in the client role) and one
              ``play`` viewer join through the relay; each media viewer
              completes ICE and DTLS, verifies every SRTP tag and gets
              WEBRTC_FRAMES 640×360 keyframes, each byte-equal to the
              port's encoder run again on a relay frame; the shared
              encoder encodes at most once per relay frame; the play
              viewer's JPEGs decode with the port's codec; bye and stop
              return the relay's clients to 0; lines in the golden's
              shape; then EVAM_WEBRTC_VIDEO_MODE=delta with one viewer:
              inter frames after the keyframe, a PLI answered by a
              forced keyframe; 10 launches a forward over both; (c)
              ``serve`` as a child with ENABLE_WEBRTC and the relay: one
              viewer receives frames, 10 launches a forward, SIGTERM →
              exit 0. Prints frames/s per viewer, bytes a frame and the
              seconds from offer to first frame.

26. train   — the parallel training path (``evam_tpu_torch/parallel``)
              on cuda:0 at one rank: ``ActionTrainConfig()`` at full width
              (400 classes, embed 512, depth 4, heads 8, encoder width
              32, 224×224, 16-frame clips, the encoder rematerialized),
              TRAIN_STEPS AdamW steps on one seeded batch of
              TRAIN_CLIPS clips, once with the ring strategy (a seq axis
              of one: plain attention) and once with MoE (4 experts):
              finite losses that fall; ms a step (median of the steps
              after the first), clips/s and peak allocated memory, with
              the card's name and power limit. Then the small config
              (embed 32, depth 1, heads 4, 32×32, 4-frame clips) from
              one seed on the card and on the CPU: the loss within
              TRAIN_LOSS_ATOL, every gradient within TRAIN_GRAD_RTOL of
              its tensor's largest magnitude plus TRAIN_GRAD_ATOL (the
              key biases' exact gradient is zero). K1 is not on this path:
              0 qgemm launches, asserted. No collective runs on the
              card: NCCL takes one GPU a rank, and the machine has one.
27. dryrun  — ``dryrun_multichip(8)``: 8 gloo ranks on the CPU (the
              trainer dp × sp (ring) × tp with 4 MoE experts, Ulysses
              against plain attention, one SGD step through 8 pipeline
              stages), then the fused detect+classify BatchEngine over
              an 8-entry data mesh on the CPU. A CPU run, labelled so.
28. accuracy — ground truth on the card (``evam_tpu_torch/models/
              accuracy.py``): (a) the reference's recipe
              (tests/test_accuracy.py, tools/accuracy_device.py): the
              SSD at 96², width 16, fitted on the card (``fit_detector``:
              1200 Adam steps over 128 synthetic scenes, float32, TF32
              off) to a last loss below 0.5, written by ``save_fitted``
              and loaded by a fresh registry; the 8 held-out 1080p scenes
              (seed 99) as i420 wire frames through ``build_detect_step``
              (16 detections, score 0.3): float32 recall ≥ 0.75 and
              precision ≥ 0.7, the U/V planes swapped recall < 0.5,
              over all boxes and over the vehicles and bikes (the
              classes whose colour the swap changes), INT8
              through K1 (10 launches) recall ≥ 0.7 and precision ≥ 0.6;
              each beside the largest difference from the plain CPU
              path's rows on the same weights; (b) the first 6 held-out
              scenes in an ``.mjpeg`` file (the port's JPEG codec) served
              at INT8 through ``PipelineRegistry.start_instance`` (file
              destination, threshold 0.3, an EngineHub of max_batch 8):
              one line a frame, recall ≥ 0.65 by the reference test's
              ``_recovered`` rule, 10 launches a forward; (c) the same
              fit at the served configuration (512², width 32,
              ACC_FULL_STEPS steps), served at float32 and at INT8
              through K1 on the held-out scenes: INT8 recall at least
              float32's less 0.05. Prints each fit's ms a step, seconds,
              loss history and peak memory, and the phase's seconds.
29. attrs   — the classifier's ground truth on the card (the reference's
              TestFusedClassifyAccuracy, tests/test_accuracy.py:213):
              (a) the SSD at 96², width 16 fitted on ``color_attr``
              scenes (1200 steps, 128 scenes) to a last loss below 0.6
              and the classifier at 48², width 16 (``fit_classifier``:
              900 steps, 768 crops) below 0.2, both written by
              ``save_fitted`` and loaded by fresh registries; 16 held-out
              1080p ``color_attr`` scenes (seed 123; 10 more when they
              hold fewer than 4 vehicles) as i420 wire frames through
              ``build_detect_classify_step`` (16 detections, ROI budget
              8, score 0.3, vehicles only): attribute recall ≥ 0.6 over
              ≥ 4 vehicles at float32 and at INT8 through K1 (13
              launches a forward), each beside the largest difference
              from the plain CPU path's rows on the same weights; (b) the
              negative control: 8 scenes (seed 321), the ground-truth
              vehicle boxes through ``build_classify_step`` at INT8 (3
              launches a forward): ≥ 0.7 of the colours unshifted,
              ≤ 0.5 with every box shifted by 0.6 of its width, over ≥ 3
              vehicles; (c) (a)'s held-out scenes in an ``.mjpeg`` file
              served at INT8 as object_classification/vehicle_attributes
              (the fused engine, detection-threshold 0.3): one line a
              frame, a vehicle recovered when a published vehicle object
              matches it at IoU ≥ 0.5 with its colour, recall ≥ 0.5, 13
              launches a forward; (d) both fits at the served
              configuration (SSD 512², classifier 72², width 32), the
              crops of (b) and the fused step of (a) at float32 and at
              INT8: INT8 at most one vehicle below float32 in each.
30. temporal — the action and audio ground truth on the card (the
              reference's TestTemporalAccuracy, tests/test_accuracy.py:
              372): (a) the encoder at 48², width 8 (embed 512), the
              decoder at width 8 (dim 128, depth 4, 8 heads) and AclNet
              at width 8, float32, fitted on the card (``fit_action``:
              600 steps over 128 clips, half rendered at 64×96 and
              shrunk; ``fit_audio``: 400 steps over 512 tone windows) to
              last losses below 0.6 and 0.3, written by ``save_fitted``
              and loaded by fresh registries; then on hubs of max_batch
              16 and a 4 ms deadline: one 16-frame 64×96 clip of each of
              the 4 TEMPORAL_CLASSES (seed 42) through
              action_recognition/general, exactly its 16th frame
              carrying a 400-long tensor whose argmax is the class for
              ≥ 3 of 4, and 2 s of each of the 4 tones in 100 ms chunks
              through audio_detection/environment (threshold 0,
              sliding-window 0.5), the windows' majority label the
              class for ≥ 3 of 4; both at float32 and at INT8 (bfloat16
              weights, float32 arithmetic), INT8 at most one class below
              float32; the order control: a class-0 clip's 16 embeddings
              (seed 11, 48², the BGR encode step) into the decoder, as
              they come and in 8 seeded permutations, at least one
              answer changed; the same files on the CPU, the card's
              embeddings, decoder and AclNet probabilities within
              FP32_RTOL of its; (b) both fits at the registry's own
              sizes (encoder 224², width 32; decoder dim 512; AclNet
              width 32; the action clips' odd half rendered at 256×384),
              their losses falling, the clip and window paths at
              float32 and INT8: INT8 at most one class below float32.
              Prints each fit's ms a step, seconds, data seconds, loss
              history and peak memory, the classes recovered, and the
              phase's seconds. 0 qgemm launches in the phase, asserted.
31. aot     — the AOT cache (``evam_tpu_torch/aot/``): the hand kernels'
              libraries from a CRC-guarded, version-checked store. (a)
              a ``serve`` child (person_vehicle_bike preloaded, INT8,
              K1) with EVAM_AOT off and an empty EVAM_COMPILE_CACHE_DIR,
              its nvcc behind a recorder: seconds to /healthz 200 and to
              the first published line of an 8-frame stream, nvcc
              seconds per library, each engine's eager and capture
              seconds per bucket; (b) the same with EVAM_AOT=1 and a
              fresh shared EVAM_AOT_DIR: one ``absent`` miss per
              library, the entries the libraries it built, nvcc ran;
              (c) a second child on the same store with another empty
              compile directory: a hit per library, no miss, no nvcc run
              and no library built, /engines ``aot.hits`` ==
              ``compiled_programs``, the objects (b) published bit for
              bit; /healthz in the golden's shape in each. Then a fresh
              process on the same store: (f) K1 from the stored library
              at the ten SSD shapes, codes and outputs equal to the
              plain version's; (g) a supervisor rebuild (the engine
              phase's stub wedge) and a fleet ``scale_up`` on this card,
              every bucket a hit; (d) the fallback ladder on the
              engines' library: a flipped payload byte (``crc``), a
              header from another driver (``version``, kept), a payload
              that will not load (``deserialize``) and a library whose
              self-test fails (``execute``), each counted in
              ``summary()`` and the metric, rebuilt by nvcc and served;
              (e) eviction under a small EVAM_AOT_MAX_BYTES: the oldest
              entry goes, the newest survives.

The engine phase also checks ``own_streams``: OWN_STREAM_ENGINES CUDA
engines alive at once (3 streams each, past torch's pool of 32 a
device) hold pairwise distinct stream handles, all alive; two of them
replay their captured graphs from two threads at once, every result
equal to its step run eagerly; ``stop()`` destroys every stream.

The rest phase runs the scheduler as the default has it (on), with a
declared capacity (``EVAM_SCHED_CAPACITY_FPS``): the capacity model
reads the first batches' stage clock and can refuse streams the card
serves (PERF.md §7). The phases before it build their hubs without a
scheduler, as before it was ported.

Tracing is on in every phase, as by default (the trace phase turns it
off for its second run only).

Then the ``{"kernels": [...]}`` line (times: one fused forward's 13
calls; ``launches`` sums the slice, classify, engine, track, gate,
ragged, sched, tune, native, fleet, rest, serve, eii, trace, chaos,
ingest, webrtc and aot phases' served runs (ingest: the demux run, its
AppSource replay and the serve child's streams and files; webrtc: the
key and delta streams and the serve child's stream; aot: its three
serve children and (g)'s engines, (f)'s comparison launches left out)
and their engines' warm runs, the accuracy phase's INT8 forwards ((a) and (c) one each,
(b) its served file) and the attrs phase's (13 a fused forward in (a),
(c) and (d), 3 a classify forward in (b) and (d)), split by
variant in ``launches_by_variant``; the track phase's
kernel-against-plain runs (on an engine without warmup: a replay would
run the kernel whichever qgemm is bound) are not counted; the action,
audio, ir, train and temporal phases launch it zero times), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

``--phases`` runs a subset (for a quick first check of a new kernel);
``--profile`` adds a shorter profiled run (device busy share, kernel
time by name).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import itertools
import json
import math
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("device", "build", "qgemm", "reference", "weights", "slice",
          "classify", "engine", "track", "gate", "ragged", "sched", "tune",
          "native", "fleet", "action", "audio", "ir", "rest", "serve",
          "eii", "trace", "chaos", "ingest", "webrtc", "train", "dryrun",
          "accuracy", "attrs", "temporal", "aot")
KEY = "object_detection/person_vehicle_bike"
CLS_KEY = "object_classification/vehicle_attributes"
#: the detect+classify pipeline (pipelines/<name>/<version>)
CLS_PIPELINE = ("object_classification", "vehicle_attributes")
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense int8 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
#: (M per image, K, N) of the 10 qgemm calls of one SSD-512 forward
MAIN_SHAPES = [
    (16384, 32, 64), (16384, 64, 64), (4096, 64, 128), (4096, 128, 128),
    (1024, 128, 256), (1024, 256, 256), (256, 256, 512), (256, 512, 512),
    (256, 512, 256), (64, 512, 256),
]
IMAGES = 8
#: ROIs a frame's classifier forward takes (the classify stages' budget)
ROI_BUDGET = 8
#: (M per ROI, K, N) of the 3 qgemm calls of one classifier forward
#: (72×72 crops, width 32: the three pointwise convs at 18², 9², 5²)
CLS_SHAPES = [(324, 32, 64), (81, 64, 128), (25, 128, 256)]
#: unit rows U of the packed classify engine's buckets 128 and 8
#: (``RaggedSpec.unit_rows``: max(8, 4 × bucket)); its 3 calls take U
#: crops each
PACKED_UNITS = (512, 32)
#: per-forward sums the qgemm phase prints: the SSD's 10 calls on IMAGES
#: frames, the classifier's 3 on IMAGES × ROI_BUDGET and on ROI_BUDGET
#: crops (the largest and the smallest engine bucket), and the packed
#: classifier's 3 on each U of PACKED_UNITS
FORWARD_GROUPS = ("ssd", f"classifier_b{IMAGES}", "classifier_b1",
                  *(f"classifier_packed_u{u}" for u in PACKED_UNITS))
#: (M, K, N, x dtype) off the main path: ragged edges, float32 x, M = 0,
#: K = 2048 (the zoo's largest) held whole and in chunks, and a ragged M
#: large enough that each block walks several row tiles
RAGGED_SHAPES = [(130, 32, 130, "bfloat16"), (130, 32, 130, "float32"),
                 (1, 32, 64, "bfloat16"), (77, 40, 3, "bfloat16"),
                 (0, 64, 64, "bfloat16"), (200, 100, 600, "bfloat16"),
                 (5, 2048, 520, "float32"), (1000, 64, 64, "bfloat16"),
                 (3000, 64, 200, "bfloat16"), (512, 2048, 256, "bfloat16"),
                 (2048, 2048, 256, "bfloat16"), (96, 2048, 64, "float32"),
                 (64, 2048, 64, "bfloat16"), (100000, 32, 64, "float32")]
#: bytes read between flushed calls (clean lines, no write-back left
#: for the timed call): five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
#: the slice phase's traffic: synthetic 512×512 streams × frames each
STREAMS = 8
FRAMES = 32
#: the sched phase's shed run: the batch class's staleness budget (ms),
#: under its 25 ms formation deadline, so batch frames are shed
SHED_BATCH_MS = 10.0
#: the tune phase: the controller's tick, a knob pinned at its default,
#: and frames per stream (the run outlasts a dozen ticks)
TUNE_ENV = {"EVAM_TUNE": "1", "EVAM_TUNE_INTERVAL_S": "0.25",
            "EVAM_TRANSFER_DEPTH": "2"}
TUNE_FRAMES = 64
#: the serve phase's declared capacity (frames/s): two 30 fps starts
#: fit under the realtime ceiling, a 1000 fps start does not
SERVE_CAPACITY_FPS = 100.0
#: the rest phase's declared capacity (frames/s): its STREAMS 30 fps
#: starts fit under the standard ceiling
REST_CAPACITY_FPS = 1000.0


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _import_port():
    """The port's modules this script drives (imports nothing of JAX)."""
    from evam_tpu_torch.engine import streams
    from evam_tpu_torch.engine.batcher import BatchEngine
    from evam_tpu_torch.engine.graphs import StepGraphs
    from evam_tpu_torch.parallel import dryrun, train
    from evam_tpu_torch.parallel.mesh import build_train_mesh
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.engine.ragged import RaggedSpec
    from evam_tpu_torch.engine.ringbuf import STAGES
    from evam_tpu_torch.engine.steps import (
        build_action_decode_step,
        build_action_encode_step,
        build_audio_step,
        build_classify_step,
        build_classify_step_ragged,
        build_detect_classify_step,
        build_detect_step,
    )
    from evam_tpu_torch.sched import SchedConfig
    from evam_tpu_torch.media.audio import SyntheticAudioSource
    from evam_tpu_torch.media.source import SyntheticSource
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.ops import kernels, qgemm, qlinear
    from evam_tpu_torch.ops.preprocess import preprocess_wire
    from evam_tpu_torch.stages.infer import (
        ENGINE_SCORE_FLOOR,
        DetectStage,
        _wire_frame,
    )
    from evam_tpu_torch.config.settings import Settings, reset_settings
    from evam_tpu_torch.control import state as control_state
    from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
    from evam_tpu_torch.server.app import App, make_server
    from evam_tpu_torch.server.registry import PipelineRegistry
    from evam_tpu_torch.stages.build import build_stages
    from evam_tpu_torch.stages import gate
    from evam_tpu_torch.stages.meta import MetaconvertStage, PublishStage
    from evam_tpu_torch.stages.runner import StreamRunner
    from evam_tpu_torch import native
    from evam_tpu_torch.config.settings import TuneSettings
    from evam_tpu_torch.control import TuneController
    from evam_tpu_torch.control.state import TuneState
    from evam_tpu_torch.fleet import ConsistentHashPlacer, FleetEngine
    from evam_tpu_torch.media.luma import luma_grid
    from evam_tpu_torch.models.ir import load_ir
    from evam_tpu_torch.models.ir_build import IRBuilder, conv_bias_relu
    from evam_tpu_torch.ops import color
    from evam_tpu_torch.eii import (
        ConfigMgr,
        EiiManager,
        MsgBusPublisher,
        MsgBusSubscriber,
    )
    from evam_tpu_torch.eii.manager import _gva_meta
    from evam_tpu_torch.obs.metrics import metrics
    from evam_tpu_torch.publish.encode import decode_frame
    from evam_tpu_torch import state
    from evam_tpu_torch.obs import faults, trace
    from evam_tpu_torch.media import h264, jpeg
    from evam_tpu_torch.media.demux import RtspDemux
    from evam_tpu_torch.media.source import AppSource, FrameEvent
    from evam_tpu_torch.publish.annotate import annotate_frame
    from evam_tpu_torch.publish.rtsp import FrameRelay, RtspServer
    from evam_tpu_torch.stages.context import FrameContext, Region
    from evam_tpu_torch.models import accuracy

    return dict(
        Settings=Settings, App=App, make_server=make_server,
        reset_settings=reset_settings, control_state=control_state,
        PipelineRegistry=PipelineRegistry, PipelineLoader=PipelineLoader,
        resolve_parameters=resolve_parameters, build_stages=build_stages,
        EngineHub=EngineHub, BatchEngine=BatchEngine, RaggedSpec=RaggedSpec,
        StepGraphs=StepGraphs, STAGES=STAGES,
        build_detect_step=build_detect_step,
        build_classify_step=build_classify_step,
        build_classify_step_ragged=build_classify_step_ragged,
        build_detect_classify_step=build_detect_classify_step,
        SchedConfig=SchedConfig,
        SyntheticSource=SyntheticSource, ModelRegistry=ModelRegistry,
        SyntheticAudioSource=SyntheticAudioSource,
        build_action_encode_step=build_action_encode_step,
        build_action_decode_step=build_action_decode_step,
        build_audio_step=build_audio_step,
        kernels=kernels, qgemm=qgemm, qlinear=qlinear,
        DetectStage=DetectStage, wire_frame=_wire_frame,
        ENGINE_SCORE_FLOOR=ENGINE_SCORE_FLOOR,
        MetaconvertStage=MetaconvertStage, PublishStage=PublishStage,
        StreamRunner=StreamRunner, preprocess_wire=preprocess_wire,
        gate=gate, MotionGate=gate.MotionGate, GateConfig=gate.GateConfig,
        native=native, color=color, luma_grid=luma_grid,
        ConsistentHashPlacer=ConsistentHashPlacer, FleetEngine=FleetEngine,
        TuneController=TuneController, TuneState=TuneState,
        TuneSettings=TuneSettings, load_ir=load_ir, IRBuilder=IRBuilder,
        conv_bias_relu=conv_bias_relu, ConfigMgr=ConfigMgr,
        EiiManager=EiiManager, MsgBusPublisher=MsgBusPublisher,
        MsgBusSubscriber=MsgBusSubscriber, eii_gva_meta=_gva_meta,
        metrics=metrics, decode_frame=decode_frame, trace=trace,
        faults=faults, state=state, h264=h264, jpeg=jpeg,
        RtspDemux=RtspDemux, AppSource=AppSource, FrameEvent=FrameEvent,
        annotate_frame=annotate_frame, FrameRelay=FrameRelay,
        RtspServer=RtspServer, FrameContext=FrameContext, Region=Region,
        streams=streams, train=train, dryrun=dryrun,
        build_train_mesh=build_train_mesh, accuracy=accuracy)


def _memory(torch, phase: str, t_start: float) -> None:
    """Device memory the caching allocator holds once a phase has
    stopped its engines (their graphs and pools freed), and the script's
    seconds so far."""
    _print({"phase": f"{phase}-memory",
            "script_s": time.perf_counter() - t_start,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30})


def _time_ms(torch, fn, calls: int = 20, rounds: int = 7) -> tuple[float, float]:
    """(wall ms, device ms) per call of ``fn``.

    Wall: the median over ``rounds`` of CUDA-event time around
    ``calls`` back-to-back calls, divided by ``calls`` — what a caller
    issuing them in a row gets, host launch cost included. Device: the
    summed time of the kernels the calls ran (torch.profiler), per call
    — the card's own work, without the gaps the host leaves."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    device_us = 0.0
    for _ in range(8):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if device_us > 0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    return statistics.median(times), device_us / 1e3 / calls


def _flushed_device_ms(torch, fn, flush, calls: int = 20) -> float:
    """Device time per call of the qgemm kernel alone when every call
    finds the L2 cache cold: ``flush`` reads FLUSH_BYTES before each
    call, and only kernels named ``qgemm`` are summed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        flush()
        fn()
    for _ in range(8):  # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "qgemm" in e.key]
        if sum(e.count for e in events) == calls:
            return sum(e.self_device_time_total for e in events) / 1e3 / calls
    raise RuntimeError("torch.profiler did not record every qgemm launch")


def phase_qgemm(torch, port) -> dict:
    """Kernel vs plain version at the main-path and ragged shapes."""
    qg, ql = port["qgemm"], port["qlinear"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sums = {g: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "device_ms": 0.0, "device_ms_flushed": 0.0,
                "plain_device_ms": 0.0, "library_device_ms": 0.0,
                "int_mm_ms": 0.0, "int_mm_device_ms": 0.0, "calls": 0,
                "variants": {"aligned": 0, "masked": 0}}
            for g in FORWARD_GROUPS}
    max_err = 0.0
    scratch = torch.ones(FLUSH_BYTES // 4, device="cuda")
    flush = lambda: scratch.sum()
    shapes = [(m * IMAGES, k, n, "ssd", "bfloat16") for m, k, n in MAIN_SHAPES]
    shapes += [(m * b * ROI_BUDGET, k, n, f"classifier_b{b}", "bfloat16")
               for b in (IMAGES, 1) for m, k, n in CLS_SHAPES]
    shapes += [(m * u, k, n, f"classifier_packed_u{u}", "bfloat16")
               for u in PACKED_UNITS for m, k, n in CLS_SHAPES]
    shapes += [(m, k, n, None, dt) for m, k, n, dt in RAGGED_SHAPES]
    for m, k, n, group, dtype in shapes:
        main = group == "ssd"
        x = torch.randn((m, k), generator=gen, device="cuda").mul_(2.0)
        x = x.to(getattr(torch, dtype))
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.2
        wq, w_scale = ql.quantize_weight(w)
        wq = wq.T.contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        before = dict(qg.variant_launches)
        out, codes, scales = qg.qgemm(x, wq, w_scale, bias, return_codes=True)
        variant = [v for v, c in qg.variant_launches.items() if c != before[v]]
        if main and variant != ["aligned"]:
            raise AssertionError(
                f"qgemm {m}x{k}x{n}: main-path shape ran {variant}, not the "
                "aligned tensor-core variant")
        ref = qg.qgemm_reference(x, wq, w_scale, bias)
        torch.cuda.synchronize()
        if m:
            ref_codes, ref_scales = qg.quantize_rows(x)
            if not torch.equal(scales, ref_scales):
                raise AssertionError(f"qgemm {m}x{k}x{n}: row scales differ")
            if not torch.equal(codes, ref_codes):
                bad = (codes != ref_codes).nonzero()[:5].tolist()
                examples = [{
                    "x": x[i, j].item(), "scale": scales[i].item(),
                    "kernel": codes[i, j].item(), "plain": ref_codes[i, j].item(),
                    "quotient_f64": x[i, j].double().item() / scales[i].double().item(),
                } for i, j in bad]
                raise AssertionError(
                    f"qgemm {m}x{k}x{n}: int8 codes differ in "
                    f"{(codes != ref_codes).sum().item()} places: {examples}")
        err = (out - ref).abs().max().item() if m else 0.0
        scale = ref.abs().max().item() if m else 0.0
        if not m and tuple(out.shape) != (0, n):
            raise AssertionError(f"qgemm M = 0: output {tuple(out.shape)}")
        if m and not torch.equal(out, ref):
            raise AssertionError(
                f"qgemm {m}x{k}x{n}: outputs differ, max abs err {err} "
                f"(max |ref| {scale})")
        max_err = max(max_err, err)
        row = {"phase": "qgemm", "m": m, "k": k, "n": n, "dtype": dtype,
               "group": group, "max_abs_err": err, "codes_equal": True,
               "variant": variant[0] if variant else None}
        if m:
            p = qg.plan(m, n, k, x.dtype)
            row["plan"] = {"bm": p.bm, "bn": p.bn, "kc": p.kc,
                           "blocks": p.blocks, "smem": p.smem}
            row["ms"], row["device_ms"] = _time_ms(
                torch, lambda: qg.qgemm(x, wq, w_scale, bias))
            row["device_ms_flushed"] = _flushed_device_ms(
                torch, lambda: qg.qgemm(x, wq, w_scale, bias), flush)
            row["plain_ms"], row["plain_device_ms"] = _time_ms(
                torch, lambda: qg.qgemm_reference(x, wq, w_scale, bias))
            nbytes = x.numel() * x.element_size() + wq.numel() + 4 * n * 2 + 4 * m * n
            bytes_ms = 1e3 * nbytes / HBM_BYTES_S
            ops_ms = 1e3 * 2.0 * m * n * k / INT8_OPS_S
            row.update(bytes=nbytes, ops=2 * m * n * k,
                       bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            # set against the flushed time: back-to-back calls on a
            # working set under 50 MB can be served from L2
            row["bound_share"] = row["bound_ms"] / row["device_ms_flushed"]
            row["library_ms"] = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                wq_t = wq.T  # [K, N] column-major view of the [N, K] codes

                def quantize():
                    # the row scale rounded exactly (M divisions), then
                    # x / scale as float32 division by a CUDA tensor
                    xf = x.float()
                    sc = torch.clamp(qg.div_rn(
                        xf.abs().amax(1, keepdim=True), 127.0), min=1e-8)
                    return torch.round(xf / sc).clamp_(-127, 127).to(torch.int8), sc

                def library():
                    xc, sc = quantize()
                    acc = torch._int_mm(xc, wq_t)
                    return acc.float() * sc * w_scale + bias

                lib_codes, _ = quantize()
                row["library_codes_equal"] = bool(torch.equal(lib_codes, codes))
                lib_err = (library() - ref).abs().max().item()
                if not row["library_codes_equal"] or lib_err > 1e-6 * max(scale, 1e-30):
                    raise AssertionError(
                        f"library yardstick disagrees at {m}x{k}x{n}: codes "
                        f"{(lib_codes != codes).sum().item()} differ, err {lib_err}")
                row["library_ms"], row["library_device_ms"] = _time_ms(
                    torch, library)
                row["int_mm_ms"], row["int_mm_device_ms"] = _time_ms(
                    torch, lambda: torch._int_mm(lib_codes, wq_t))
                # torch divides by a CPU scalar as a product with its
                # reciprocal: the rows whose scale that rounds otherwise
                amax = x.float().abs().amax(1)
                row["scalar_div_scale_rows_off"] = int(
                    (amax / 127.0 != qg.div_rn(amax, 127.0)).sum())
            if group is not None:
                tot = sums[group]
                for key in ("ms", "plain_ms", "device_ms", "device_ms_flushed",
                            "plain_device_ms", "bound_ms"):
                    tot[key] += row[key]
                tot["bytes_ms"] += bytes_ms
                tot["ops_ms"] += ops_ms
                tot["calls"] += 1
                tot["variants"][row["variant"]] += 1
                lib_keys = ("library_ms", "library_device_ms", "int_mm_ms",
                            "int_mm_device_ms")
                if row["library_ms"] is None:
                    tot.update(dict.fromkeys(lib_keys))
                elif tot["library_ms"] is not None:
                    for key in lib_keys:
                        tot[key] += row[key]
        _print(row)
    del scratch
    # one fused detect+classify forward of IMAGES frames: the SSD's
    # calls and the classifier's on IMAGES × ROI_BUDGET crops
    sums["fused"] = {
        key: (None if sums["ssd"][key] is None
              or sums[f"classifier_b{IMAGES}"][key] is None
              else sums["ssd"][key] + sums[f"classifier_b{IMAGES}"][key])
        for key in sums["ssd"] if key != "variants"}
    for group, tot in sums.items():
        tot["max_abs_err"] = max_err
        tot["bound_share"] = tot["bound_ms"] / tot["device_ms_flushed"]
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        _print({"phase": "qgemm-forward", "forward": group, **tot})
    return sums


def phase_reference(torch, port) -> None:
    """Small INT8 detector: card (kernel) against CPU (plain version)."""
    kw = dict(dtype="int8", allow_random_weights=True,
              input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8})
    cpu = port["ModelRegistry"](device="cpu", **kw).get(KEY)
    gpu = port["ModelRegistry"](device="cuda", **kw).get(KEY)
    gen = torch.Generator().manual_seed(1)
    x = (torch.rand((4, 64, 64, 3), generator=gen) * 255).to(torch.bfloat16)
    with torch.inference_mode():
        ref = cpu.forward(x)
        got = gpu.forward(x.cuda())
    for name in ("loc", "conf"):
        r = ref[name].float()
        g = got[name].float().cpu()
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"reference phase: bad {name} {tuple(g.shape)}")
        diff = (g - r).abs().max().item()
        scale = r.abs().max().item()
        _print({"phase": "reference", "output": name, "max_abs_diff": diff,
                "max_abs_ref": scale})
        if diff > 1e-2 * scale:
            raise AssertionError(
                f"reference phase: {name} differs by {diff} > 1e-2 x {scale}")
    # the INT8 classifier (width 8) on 72×72 crops, the same way
    kw["width_overrides"] = {CLS_KEY: 8}
    cpu = port["ModelRegistry"](device="cpu", **kw).get(CLS_KEY)
    gpu = port["ModelRegistry"](device="cuda", **kw).get(CLS_KEY)
    x = (torch.rand((16, 72, 72, 3), generator=gen) * 255).to(torch.bfloat16)
    with torch.inference_mode():
        ref = cpu.forward(x)
        got = gpu.forward(x.cuda())
    for name in ("color", "type"):
        r, g = ref[name].float(), got[name].float().cpu()
        diff = (g - r).abs().max().item()
        scale = r.abs().max().item()
        _print({"phase": "reference", "output": name, "max_abs_diff": diff,
                "max_abs_ref": scale})
        if g.shape != r.shape or not torch.isfinite(g).all() \
                or diff > 1e-2 * scale:
            raise AssertionError(
                f"reference phase: {name} differs by {diff} > 1e-2 x {scale}")


def _match_rate(ref, got, iou_min=0.9) -> float:
    """Share of ref's valid detections matched by a got detection of the
    same label with IoU ≥ iou_min (packed rows, one frame)."""
    import numpy as np

    r = ref[ref[:, 6] > 0.5]
    g = got[got[:, 6] > 0.5]
    if len(r) == 0:
        return 1.0
    hit = 0
    for row in r:
        same = g[g[:, 5] == row[5]]
        if len(same) == 0:
            continue
        lt = np.maximum(row[:2], same[:, :2])
        rb = np.minimum(row[2:4], same[:, 2:4])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda b: np.prod(np.clip(b[..., 2:4] - b[..., :2], 0, None), axis=-1)
        iou = inter / np.maximum(area(row) + area(same) - inter, 1e-9)
        hit += bool((iou >= iou_min).any())
    return hit / len(r)


def _detect_stages(port, hub):
    """Stage factory of the slice phase: detect → metaconvert → publish."""
    def make(uri, publish):
        return [port["DetectStage"]("detect", KEY, {"threshold": 0.2}, hub),
                port["MetaconvertStage"]("meta", source_uri=uri),
                port["PublishStage"]("publish", publish)]
    return make


def _serve(port, make_stages, streams: int, frames: int, h: int, w: int,
           objects: dict | None = None, metas: dict | None = None,
           source=None, priorities: list[str] | None = None):
    """Serve ``streams`` synthetic streams of ``frames`` frames each,
    one thread per stream, through the stages ``make_stages(uri,
    publish)`` builds for each (their engines shared). Returns
    (runners, published seqs per stream, wall seconds, threads); each
    stream's published objects land in ``objects`` (stream id → seq →
    list), and its whole metadata with the frame's ingest-to-publish
    seconds in ``metas`` (stream id → seq → (metadata, seconds)), if
    given. ``source(s)`` gives stream ``s``'s (uri, source) in place of
    the synthetic ``w``×``h`` video; ``priorities[s]`` is stream ``s``'s
    QoS class (default standard)."""
    published: dict[str, list[int]] = {}
    lock = threading.Lock()

    def publish(ctx):
        latency = time.perf_counter() - ctx.ingest_t
        with lock:
            published.setdefault(ctx.stream_id, []).append(ctx.seq)
            if objects is not None:
                objects.setdefault(ctx.stream_id, {})[ctx.seq] = \
                    ctx.metadata["objects"]
            if metas is not None:
                metas.setdefault(ctx.stream_id, {})[ctx.seq] = (
                    ctx.metadata, latency)

    runners = []
    for s in range(streams):
        if source is None:
            uri = f"synthetic://{w}x{h}@30?count={frames}&seed={s}"
            src = port["SyntheticSource"].from_uri(uri)
        else:
            uri, src = source(s)
        stages = make_stages(uri, publish)
        prio = priorities[s] if priorities else "standard"
        runners.append((port["StreamRunner"](f"s{s}", stages, uri,
                                             priority=prio), src))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=r.run, args=(src.frames(),))
               for r, src in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return [r for r, _ in runners], published, time.perf_counter() - t0, threads


def _reset_launches(qg) -> None:
    qg.launches = 0
    qg.variant_launches.update(aligned=0, masked=0)


def _latency_row(runners, wall: float) -> dict:
    lat = sorted(x for r in runners for x in r.latencies)
    q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
    return {"frames": len(lat), "wall_s": wall, "fps": len(lat) / wall,
            "p50_ms": 1e3 * q(0.50), "p99_ms": 1e3 * q(0.99)}


def _check_served(where: str, runners, published, threads,
                  frames: int = FRAMES) -> None:
    """Every stream finished without frame errors and published each of
    its ``frames`` frames once, in order."""
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{where}: a stream did not finish")
    errors = sum(r.errors for r in runners)
    if errors:
        raise AssertionError(f"{where}: {errors} frame errors")
    for s in range(len(runners)):
        seqs = published.get(f"s{s}", [])
        if seqs != list(range(frames)):
            raise AssertionError(f"{where}: stream s{s} published "
                                 f"{len(seqs)} of {frames} frames")


def _profile_serve(torch, port, hub, streams, frames, h, w,
                   make=None) -> dict:
    """Device busy share and kernel time by name over a served run
    (torch.profiler; a second, shorter run — the profiler slows the
    host that issues the launches). ``make``: the stages (default: the
    slice phase's detect stages)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = _serve(port, make or _detect_stages(port, hub),
                               streams, frames, h, w)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:  # names cut to 80 characters can collide: sum them
        name = e.key[:80]
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"phase": "slice-profile", "wall_s": wall,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": dict(top)}


def _host_frame_ms(port, n: int = 64) -> dict:
    """One thread's host cost per frame of what each stream thread does
    before a submit: make the synthetic 512² frame, and resize and
    encode it to the I420 wire (ms, wall)."""
    src = port["SyntheticSource"](512, 512, count=n, seed=9)
    t0 = time.perf_counter()
    frames = [ev.frame for ev in src.frames()]
    t1 = time.perf_counter()
    for f in frames:
        port["wire_frame"](f, (512, 512), "i420")
    t2 = time.perf_counter()
    return {"source_ms": 1e3 * (t1 - t0) / n, "encode_ms": 1e3 * (t2 - t1) / n}


def _default_hub(port, registry, **overrides):
    """An EngineHub with the serving defaults of ``Settings`` — warmup
    on (every bucket captured as a CUDA graph), supervised, slot
    staging, pipelined transfer — as the server builds it."""
    e = port["Settings"].from_env(env={}).engine
    kw = dict(max_batch=e.max_batch, deadline_ms=e.batch_deadline_ms,
              warmup=e.warmup, stall_timeout_s=e.stall_timeout_s,
              supervise=e.supervise, max_restarts=e.max_restarts,
              restart_window_s=e.restart_window_s,
              restart_backoff_s=e.restart_backoff_s,
              first_batch_grace=e.first_batch_grace, transfer=e.transfer,
              transfer_depth=e.transfer_depth, assembly=e.batch_assembly,
              staging_depth=e.staging_depth)
    kw.update(overrides)
    return port["EngineHub"](registry, device=registry.device, **kw)


def _warm_split(engine) -> dict:
    """Per bucket, the seconds of its first eager step and of its
    CUDA graph capture at warmup (``StepGraphs.timings``)."""
    live = getattr(engine, "_engine", engine)
    return {str(b): {"eager_s": e, "capture_s": c}
            for b, (e, c) in sorted(live._graphs.timings.items())}


def _fwd(row: dict) -> int:
    """Forwards an engine ran: its batches and its warm runs (one per
    bucket warmed; each launches the kernel as a batch does)."""
    return row["batches"] + row["warm_forwards"]


def _stage_engines(stages) -> list:
    return [e for st in stages for e in (
        getattr(st, "engine", None), getattr(st, "enc_engine", None),
        getattr(st, "dec_engine", None)) if e is not None]


def _await_warm(where: str, engines, timeout: float = 300.0) -> list[dict]:
    """Wait for each engine's background warmup; every bucket must have
    been captured as a CUDA graph. Returns their /engines rows."""
    rows = []
    for e in engines:
        if not e.warmed.wait(timeout):
            raise AssertionError(f"{where}: {e.name} did not warm in "
                                 f"{timeout:.0f} s")
        row = e.stats_row()
        if row["capture_failures"] or row["graphs"] != len(row["buckets"]):
            raise AssertionError(
                f"{where}: {e.name} captured {row['graphs']} of "
                f"{len(row['buckets'])} buckets "
                f"({row['capture_failures']} failed)")
        rows.append(row)
    return rows


def phase_slice(torch, port, profile: bool = False) -> dict:
    """The main path at full width, served to STREAMS streams."""
    import numpy as np

    qg, ql = port["qgemm"], port["qlinear"]
    if ql.QGEMM_BACKEND != "pallas":
        raise AssertionError("EVAM_QGEMM=pallas did not reach ops/qlinear.py")
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    if registry.precision != "INT8":
        raise AssertionError("EVAM_PRECISION=int8 did not select INT8")
    hub = _default_hub(port, registry)
    try:
        model = hub.model(KEY)
        h, w = model.preprocess.height, model.preprocess.width
        # the stage warms its engine (every bucket captured); then
        # count from zero
        engine = _detect_stages(port, hub)("warm", None)[0].engine
        (warm,) = _await_warm("slice", [engine])

        _reset_launches(qg)
        fwd0 = _fwd(engine.stats_row())
        objects: dict[str, dict[int, list]] = {}
        runners, published, wall, threads = _serve(
            port, _detect_stages(port, hub), STREAMS, FRAMES, h, w, objects)
        launches = qg.launches
        masked = qg.variant_launches["masked"]
        stats = engine.stats_row()
        forwards = _fwd(stats) - fwd0

        _check_served("slice phase", runners, published, threads)
        if launches != 10 * forwards or forwards == 0:
            raise AssertionError(
                f"slice phase: {launches} qgemm launches for {forwards} "
                "forwards, expected 10 per forward")
        if masked:
            raise AssertionError(
                f"slice phase: {masked} qgemm launches took the masked variant")

        # one batch again, kernel against plain qgemm on the card
        batch = torch.from_numpy(np.stack([
            port["wire_frame"](ev.frame, (h, w), "i420")
            for s in range(IMAGES)
            for ev in port["SyntheticSource"](w, h, count=1, seed=s).frames()
        ])).cuda()
        step = engine.step_fn
        with torch.inference_mode():
            x = port["preprocess_wire"](batch, dataclasses.replace(
                model.preprocess, wire_format="i420"))
            packed_k = step(batch).cpu().numpy()
            raw_k = {k: v.float().cpu() for k, v in model.forward(x).items()}
            ql.qgemm = qg.qgemm_reference
            try:
                packed_p = step(batch).cpu().numpy()
                raw_p = {k: v.float().cpu() for k, v in model.forward(x).items()}
            finally:
                ql.qgemm = qg.qgemm
        check = {"phase": "slice-check"}
        for name in ("loc", "conf"):
            d = (raw_k[name] - raw_p[name]).abs().max().item()
            scale = raw_p[name].abs().max().item()
            check[f"{name}_max_abs_diff"] = d
            check[f"{name}_max_abs_ref"] = scale
            if not torch.isfinite(raw_k[name]).all() or d > 1e-2 * scale:
                raise AssertionError(f"slice check: {name} differs by {d}")
        rates = [_match_rate(packed_p[i], packed_k[i]) for i in range(IMAGES)]
        check["packed_equal"] = bool((packed_k == packed_p).all())
        check["detections_matched"] = min(rates)
        check["valid_per_frame"] = float((packed_p[..., 6] > 0.5).sum(-1).mean())
        if packed_k.shape != (IMAGES, 32, 7) or min(rates) < 0.95:
            raise AssertionError(f"slice check failed: {check}")
        _print(check)

        row = {"phase": "slice", "streams": STREAMS, "frames_per_stream": FRAMES,
               **_latency_row(runners, wall),
               "forwards": forwards, "qgemm_launches": launches,
               "mean_occupancy": stats["mean_occupancy"],
               "bucket_batches": stats["bucket_batches"],
               "stage_ms": stats["stage_ms"],
               "graphs": warm["graphs"], "capture_s": warm["compile_s"],
               "graph_pool_bytes": warm["graph_pool_bytes"],
               "warm_split_s": _warm_split(engine),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        _print(row)
        if profile:
            _print(_profile_serve(torch, port, hub, STREAMS, 8, h, w))
        return {"launches": launches, "input_hw": (h, w),
                "width": model.spec.width, "s0_objects": objects["s0"],
                "fps": row["fps"]}
    finally:
        hub.stop()


def _pipeline_stages(port, hub, params: dict, pipeline=CLS_PIPELINE):
    """Stage factory of the classify, track and gate phases: a pipeline
    of ``pipelines/`` (vehicle_attributes by default), its parameters
    bound and its stages built as the REST server builds them
    (``stages/build.py``, fusion pass included)."""
    spec = port["PipelineLoader"](ROOT / "pipelines").get(*pipeline)
    stage_specs, _ = port["resolve_parameters"](spec, params)

    def make(uri, publish):
        return port["build_stages"](stage_specs, hub, source_uri=uri,
                                    publish_fn=publish)
    return make


def _crop_boxes(torch, gen, b: int):
    """[b, ROI_BUDGET, 4] valid normalized boxes on the card."""
    p = torch.rand((b, ROI_BUDGET, 2, 2), generator=gen, device="cuda")
    return torch.cat([p.amin(2), p.amax(2)], -1)


def _attributed(objects: list[dict]) -> int:
    """Objects that carry both vehicle attributes, each with a finite
    confidence and a label."""
    n = 0
    for obj in objects:
        if all(isinstance(obj.get(a), dict) for a in ("color", "type")):
            for a in ("color", "type"):
                if not (math.isfinite(obj[a]["confidence"])
                        and isinstance(obj[a]["label"], str)):
                    raise AssertionError(f"bad attribute {a}: {obj[a]}")
            n += 1
    return n


def _check_fused_kernel_path(torch, port, stage) -> None:
    """One batch of IMAGES frames through the fused step, with the
    kernel and with the plain qgemm on the card: the same detections
    (≥ 95 % matched at IoU ≥ 0.9), the same rows left unclassified, and
    probability blocks within 1e-2 (bf16 activations; cuDNN may take
    another algorithm between the two calls)."""
    import numpy as np

    qg, ql = port["qgemm"], port["qlinear"]
    h, w = stage.ingest_size
    batch = torch.from_numpy(np.stack([
        port["wire_frame"](ev.frame, (h, w), "i420")
        for s in range(IMAGES)
        for ev in port["SyntheticSource"](w, h, count=1, seed=s).frames()
    ])).cuda()
    step = stage.engine.step_fn
    before = qg.launches
    packed_k = step(batch).cpu().numpy()
    if qg.launches - before != 13:
        raise AssertionError(f"classify check: {qg.launches - before} qgemm "
                             "launches in one fused forward, expected 13")
    ql.qgemm = qg.qgemm_reference
    try:
        packed_p = step(batch).cpu().numpy()
    finally:
        ql.qgemm = qg.qgemm
    if packed_k.shape != (IMAGES, 32, 18) or not np.isfinite(packed_k).all():
        raise AssertionError(f"classify check: output {packed_k.shape}")
    rates = [_match_rate(packed_p[i, :, :7], packed_k[i, :, :7])
             for i in range(IMAGES)]
    same = ((packed_k[..., 6] == packed_p[..., 6])
            & (packed_k[..., 5] == packed_p[..., 5])
            & (np.abs(packed_k[..., :4] - packed_p[..., :4]).max(-1) <= 1e-3))
    cls_k = packed_k[..., 7:].sum(-1) > 0.5
    cls_p = packed_p[..., 7:].sum(-1) > 0.5
    diff = float(np.abs(packed_k[..., 7:] - packed_p[..., 7:])[same].max())
    check = {"phase": "classify-check", "packed_equal":
             bool((packed_k == packed_p).all()),
             "detections_matched": min(rates),
             "rows_same": float(same.mean()),
             "classified_per_frame": float(cls_p.sum(-1).mean()),
             "unclassified_rows_equal": bool((cls_k[same] == cls_p[same]).all()),
             "prob_max_abs_diff": diff}
    unclassified_zero = bool((packed_k[~cls_k][:, 7:] == 0).all())
    if (min(rates) < 0.95 or not check["unclassified_rows_equal"]
            or diff > 1e-2 or not cls_p.any() or not unclassified_zero):
        raise AssertionError(f"classify check failed: {check}")
    _print(check)


def phase_classify(torch, port) -> dict:
    """The detect+classify pipeline at full width, served to STREAMS
    streams in this process: fused, then unfused."""
    qg = port["qgemm"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    total = {"aligned": 0, "masked": 0}
    try:
        det, cls = hub.model(KEY), hub.model(CLS_KEY)
        for mode, extra in (("fused", {}),
                            ("unfused", {"reclassify-interval": 3})):
            make = _pipeline_stages(port, hub, {"detection-threshold": 0.2,
                                                **extra})
            stages = make("warm", None)
            kinds = [type(st).__name__ for st in stages]
            engines = {e.name.split(":")[0]: e for e in
                       (getattr(st, "engine", None) for st in stages) if e}
            want = (["detect_classify"] if mode == "fused"
                    else ["detect", "classify"])
            if list(engines) != want:
                raise AssertionError(f"classify {mode}: stages {kinds}")
            _await_warm(f"classify {mode}", engines.values())
            if mode == "fused":
                _check_fused_kernel_path(torch, port, stages[0])
            fwd0 = {k: _fwd(e.stats_row()) for k, e in engines.items()}
            _reset_launches(qg)
            objects: dict[str, dict[int, list]] = {}
            runners, published, wall, threads = _serve(
                port, make, STREAMS, FRAMES, 512, 512, objects)
            launches = qg.launches
            variants = dict(qg.variant_launches)
            rows = {k: e.stats_row() for k, e in engines.items()}
            fwd = {k: _fwd(rows[k]) - fwd0[k] for k in engines}

            _check_served(f"classify {mode}", runners, published, threads)
            per = ({"detect_classify": 13} if mode == "fused"
                   else {"detect": 10, "classify": 3})
            want_launches = sum(per[k] * fwd[k] for k in per)
            # only the classifier's calls can be ragged: at small buckets
            # its M (bucket × 8 × {324, 81, 25}) leaves the tiling
            cls_fwd = fwd.get("detect_classify", 0) + fwd.get("classify", 0)
            if (not all(fwd.values()) or launches != want_launches
                    or variants["masked"] > 3 * cls_fwd):
                raise AssertionError(
                    f"classify {mode}: {launches} qgemm launches {variants} "
                    f"for forwards {fwd}, expected {per} per forward")
            objects = [o for objs in objects["s0"].values() for o in objs]
            attributed = _attributed(objects)
            if not attributed:
                raise AssertionError(f"classify {mode}: no object of stream 0 "
                                     f"carries color and type ({len(objects)})")
            _print({"phase": "classify", "mode": mode, "streams": STREAMS,
                    **_latency_row(runners, wall), "forwards": fwd, "qgemm_launches": launches,
                    "variants": variants,
                    "s0_objects": len(objects), "s0_attributed": attributed,
                    "occupancy": {k: r["mean_occupancy"] for k, r in rows.items()},
                    "unit_occupancy": {k: r["unit_occupancy"]
                                       for k, r in rows.items()},
                    "bucket_batches": {k: r["bucket_batches"]
                                       for k, r in rows.items()},
                    "stage_ms": {k: r["stage_ms"] for k, r in rows.items()}})
            for v in total:
                total[v] += variants[v]
        return {"variants": total, "models": (
            det.preprocess.height, det.preprocess.width, det.spec.width,
            cls.preprocess.height, cls.preprocess.width, cls.spec.width,
            cls.spec.heads)}
    finally:
        hub.stop()


#: the engine phase's watchdog budget on hub A (the stub wedge trips it)
ENGINE_STALL_S = 5.0


def _stage_delta(stages, row0: dict, row1: dict) -> dict:
    """Per-batch stage ms over the batches between two /engines rows
    (every one of ``stages``; 0 where a path has no such stage)."""
    n0, n1 = row0["batches"], row1["batches"]
    return {k: (row1["stage_ms"].get(k, 0.0) * n1
                - row0["stage_ms"].get(k, 0.0) * n0) / max(1, n1 - n0)
            for k in stages}


def _bucket_delta(row0: dict, row1: dict) -> dict:
    return {b: n - row0["bucket_batches"].get(b, 0)
            for b, n in row1["bucket_batches"].items()
            if n != row0["bucket_batches"].get(b, 0)}


def _objects_diff(a: dict, b: dict) -> dict:
    """Published objects of two runs of the same traffic, frame by
    frame: frames whose objects are not exactly equal, and the largest
    box and confidence differences among same-length frames."""
    frames = differ = 0
    box = conf = 0.0
    for sid, seqs in a.items():
        for seq, objs in seqs.items():
            other = b.get(sid, {}).get(seq)
            frames += 1
            if objs == other:
                continue
            differ += 1
            if other is None or len(other) != len(objs):
                box = conf = math.inf
                continue
            for x, y in zip(objs, other):
                bx, by = (x["detection"]["bounding_box"],
                          y["detection"]["bounding_box"])
                box = max(box, max(abs(bx[k] - by[k]) for k in bx))
                conf = max(conf, abs(x["detection"]["confidence"]
                                     - y["detection"]["confidence"]))
    return {"frames": frames, "frames_differing": differ,
            "max_box_diff": box, "max_confidence_diff": conf}


def _replay_vs_eager(torch, port, engine, per_forward: int) -> dict:
    """One batch of IMAGES frames through the engine's captured graph of
    that bucket and through its step eagerly: the same bits, and the
    replay launches the kernel ``per_forward`` times."""
    import numpy as np

    live = getattr(engine, "_engine", engine)
    bg = live._graphs.get(IMAGES)
    if bg is None:
        raise AssertionError(f"engine: no graph for bucket {IMAGES}")
    batch = torch.from_numpy(np.stack([
        port["wire_frame"](ev.frame, (512, 512), "i420")
        for s in range(IMAGES)
        for ev in port["SyntheticSource"](512, 512, count=1,
                                          seed=s).frames()])).cuda()
    eager = live.step_fn(batch).cpu().numpy()
    before = port["qgemm"].launches
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        replayed = live._graphs.replay(bg, [batch]).cpu().numpy()
    torch.cuda.synchronize()
    launched = port["qgemm"].launches - before
    if launched != per_forward or not (replayed == eager).all():
        raise AssertionError(
            f"engine: replay of bucket {IMAGES} launched {launched} "
            f"(want {per_forward}), equal to eager: "
            f"{bool((replayed == eager).all())}")
    # K1's device time per forward, inside the replay and eager
    from torch.profiler import ProfilerActivity, profile

    k1_ms, seen = {}, {}
    for how, fn in (("replay", lambda: live._graphs.replay(bg, [batch])),
                    ("eager", lambda: live.step_fn(batch))):
        seen[how] = []
        # the profiler now and then loses kernel records: a capture
        # counts only if it saw every kernel of the 10 forwards
        for _ in range(3):
            with torch.cuda.stream(stream):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if "qgemm" in e.key
                      and e.device_type == torch.autograd.DeviceType.CUDA]
            seen[how].append(sum(e.count for e in events))
            if seen[how][-1] == 10 * per_forward:
                break
        else:
            raise AssertionError(f"engine: the profiler saw {seen[how]} "
                                 f"qgemm kernels in 10 {how} forwards, "
                                 f"want {10 * per_forward}")
        k1_ms[how] = sum(e.self_device_time_total for e in events) / 1e4
    return {"bucket": IMAGES, "replay_equals_eager": True,
            "replay_launches": launched,
            "k1_device_ms_per_forward": k1_ms, "profiler_counts": seen}


#: seconds the quarantined engine may take to destroy its streams once
#: its wedged launcher is released
WEDGE_FREE_S = 30.0


def _wedge_and_recover(torch, port, hub, engine) -> dict:
    """A stub wedge on a supervised engine of ``hub``: its launches
    block on a host event; the watchdog fails the stranded frame and
    flags the engine, the supervisor quarantines it and rebuilds it
    with freshly captured graphs, and the same frame is served again
    with the same result. /healthz (the port's route, in process) walks
    its 503 ladder and returns to 200."""
    import numpy as np

    app = port["App"](port["PipelineRegistry"](
        port["Settings"](pipelines_dir=str(ROOT / "pipelines"),
                         device="cuda"), hub=hub))
    wire = port["wire_frame"](next(port["SyntheticSource"](
        512, 512, count=1, seed=5).frames()).frame, (512, 512), "i420")
    before = engine.submit(frames=wire).result(timeout=60)
    old = engine._engine
    release = threading.Event()
    old.pre_launch = release.wait
    t0 = time.perf_counter()
    stranded = engine.submit(frames=wire)
    try:
        stranded.result(timeout=60)
        raise AssertionError("engine: the wedged frame resolved")
    except TimeoutError:
        pass
    stall_s = time.perf_counter() - t0
    ladder = []
    deadline = time.perf_counter() + 120
    while time.perf_counter() < deadline:
        resp = app.handle("GET", "/healthz", b"")
        status = (resp.status, json.loads(resp.body)["status"])
        if not ladder or ladder[-1] != status:
            ladder.append(status)
        if (503, "restarting") in ladder and status == (200, "ok"):
            break
        time.sleep(0.05)
    recovered_s = time.perf_counter() - t0
    release.set()  # the quarantined launcher wakes and exits
    if (503, "restarting") not in ladder or ladder[-1] != (200, "ok"):
        raise AssertionError(f"engine: /healthz ladder {ladder}")
    new = engine._engine
    row = engine.stats_row()
    if new is old or engine.restarts != 1 or row["state"] != "running":
        raise AssertionError(f"engine: no rebuild ({engine.restarts})")
    if new.graphs_captured() != len(new.buckets):
        raise AssertionError(f"engine: the rebuild captured "
                             f"{new.graphs_captured()} graphs")
    after = engine.submit(frames=wire).result(timeout=60)
    if not np.array_equal(before, after):
        raise AssertionError("engine: the rebuilt engine answers the same "
                             "frame differently")
    # the quarantined engine's free thread destroys its streams once its
    # woken threads have exited: wait for that, so no later check sees
    # them go
    released = time.perf_counter()
    stale = set(old.owned_streams())
    while stale & port["streams"].live_handles("cuda"):
        if time.perf_counter() - released > WEDGE_FREE_S:
            raise AssertionError(
                f"engine: the quarantined engine's streams still alive "
                f"{WEDGE_FREE_S} s after its launcher was released")
        time.sleep(0.05)
    return {"stall_s": stall_s, "recovered_s": recovered_s,
            "ladder": ladder, "restarts": engine.restarts,
            "recaptured_graphs": new.graphs_captured(),
            "same_result": True,
            "quarantined_streams_freed_s": time.perf_counter() - released}


def _graph_workspaces(torch, port) -> dict:
    """A capture's cuBLAS workspaces are its own. A float32 GEMM step
    (a biased linear, the cuBLASLt path, then a matmul, the cuBLAS
    path) is captured by ``StepGraphs`` and then run eagerly on the
    capture's thread and stream, as a background warmup runs the next
    bucket while the engine replays the last: the eager run must
    allocate fresh workspaces (device memory grows by more than its
    output), not reuse the ones baked into the graph, which a replay on
    the compute stream would use at the same time. A replay agrees with
    the eager run within 1e-5 × its largest magnitude."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(16)
    w = torch.randn((1024, 1024), generator=gen).to(dev)
    bias = torch.randn((1024,), generator=gen).to(dev)

    def step(x):
        return torch.nn.functional.linear(x, w, bias) @ w

    x = torch.randn((8, 1024), generator=gen).numpy()
    graphs = port["StepGraphs"](step, dev)
    try:
        bg = graphs.capture(8, [x], threading.Lock())
        with torch.cuda.stream(graphs.stream):
            xs = torch.from_numpy(x).to(dev)
            graphs.stream.synchronize()
            before = torch.cuda.memory_allocated()
            eager = step(xs)
            graphs.stream.synchronize()
            grown = torch.cuda.memory_allocated() - before
            replay = graphs.replay(bg, [xs]).clone()
            graphs.stream.synchronize()
        out_bytes = eager.numel() * eager.element_size()
        err = float((replay - eager).abs().max())
        scale = float(eager.abs().max())
        out = {"eager_alloc_bytes": grown, "output_bytes": out_bytes,
               "pool_bytes": graphs.pool_bytes(),
               "replay_max_abs_err": err, "max_abs": scale}
        if grown <= out_bytes or err > 1e-5 * scale:
            raise AssertionError(f"graph workspaces: {out}")
        return out
    finally:
        torch.cuda.synchronize()
        graphs.free()


#: engines alive at once in the own_streams check: 3 streams each, past
#: torch's pool of 32 streams a device
OWN_STREAM_ENGINES = 12
#: the own_streams step: width of its square matmuls, their count
OWN_STREAM_WIDTH, OWN_STREAM_DEPTH = 512, 16
OWN_STREAM_ITEMS = 64


def _own_streams(torch, port) -> dict:
    """OWN_STREAM_ENGINES CUDA engines alive at once: their streams
    pairwise distinct and alive; engines 0 and 1 serving from two
    threads at once through their captured graphs, each result equal to
    the step run eagerly; stop() destroys every stream."""
    import numpy as np

    streams = port["streams"]
    # sets, not counts: a stream of an earlier engine destroyed meanwhile
    # (a quarantined engine frees its own from a thread of its own)
    # leaves these comparisons as they are
    before = streams.live_handles("cuda")
    gen = torch.Generator().manual_seed(11)

    def make_step(w):
        def step(x):
            y = x
            for _ in range(OWN_STREAM_DEPTH):
                y = torch.tanh(y @ w)
            return y
        return step

    weights = [(torch.randn(OWN_STREAM_WIDTH, OWN_STREAM_WIDTH, generator=gen)
                / OWN_STREAM_WIDTH ** 0.5).cuda()
               for _ in range(OWN_STREAM_ENGINES)]
    engines = [port["BatchEngine"](f"own-streams-{i}", make_step(w), "cuda",
                                   max_batch=8, deadline_ms=2.0)
               for i, w in enumerate(weights)]
    try:
        handles = [h for e in engines for h in e.owned_streams()]
        if len(set(handles)) != len(handles) or \
                len(handles) != 3 * OWN_STREAM_ENGINES:
            raise AssertionError(f"own_streams: {len(set(handles))} distinct "
                                 f"of {len(handles)} stream handles")
        if streams.live_handles("cuda") - before != set(handles):
            raise AssertionError("own_streams: the streams made since the "
                                 "engines were built are not their own "
                                 "streams, all alive")
        example = np.zeros(OWN_STREAM_WIDTH, np.float32)
        for e in engines[:2]:
            e.set_example(frames=example)
            e.warmup()
            if e.graphs_captured() != len(e.buckets):
                raise AssertionError(f"own_streams: {e.name} captured "
                                     f"{e.graphs_captured()} graphs")
        items = np.random.default_rng(12).standard_normal(
            (OWN_STREAM_ITEMS, OWN_STREAM_WIDTH)).astype(np.float32)
        results: dict = {}

        def serve(i):
            futs = [engines[i].submit(frames=x) for x in items]
            results[i] = np.stack([f.result(timeout=60) for f in futs])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        worst = 0.0
        for i in (0, 1):
            rows = engines[i].stats_row()
            with torch.inference_mode():
                want = engines[i].step_fn(
                    torch.from_numpy(items).cuda()).cpu().numpy()
            if i not in results:
                raise AssertionError(f"own_streams: engine {i} hung")
            worst = max(worst, float(np.abs(results[i] - want).max()))
            if rows["batches"] == 0:
                raise AssertionError(f"own_streams: engine {i} ran no batch")
        if worst > 1e-5:
            raise AssertionError(f"own_streams: replayed results differ from "
                                 f"eager by {worst}")
    finally:
        for e in engines:
            e.stop()
    alive = len(streams.live_handles("cuda") - before)
    if alive:
        raise AssertionError(f"own_streams: {alive} streams alive after "
                             "stop()")
    return {"engines": OWN_STREAM_ENGINES, "streams": len(handles),
            "distinct": len(set(handles)), "replayed_concurrently": 2,
            "items_each": OWN_STREAM_ITEMS, "wall_s": wall,
            "max_abs_diff_vs_eager": worst, "alive_after_stop": 0}


def phase_engine(torch, port) -> dict:
    """The reference's default engine against today's eager one: hub A
    (slot staging, pipelined transfer, every bucket captured as a CUDA
    graph at warmup, supervised) and hub B (legacy assembly, inline
    transfer, no warmup: every batch eager) serve detect and fused
    detect+classify to the same STREAMS × FRAMES traffic."""
    qg = port["qgemm"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hubs = {"A": _default_hub(port, registry, stall_timeout_s=ENGINE_STALL_S),
            "B": port["EngineHub"](registry, device="cuda", warmup=False,
                                   assembly="legacy", transfer="inline")}
    out: dict = {"phase": "engine"}
    variants = {"aligned": 0, "masked": 0}
    try:
        for label, params, pipeline, per in (
                ("detect", {"threshold": 0.2}, DETECT_PIPELINE, 10),
                ("fused", {"detection-threshold": 0.2}, CLS_PIPELINE, 13)):
            served = {}
            for name, hub in hubs.items():
                make = _pipeline_stages(port, hub, params, pipeline)
                engine = make("warm", None)[0].engine
                # run 1 ("cold"): hub A's streams start while its
                # buckets are being captured; run 2 ("warm") after
                for run in ("cold", "warm"):
                    warm_at_start = engine.warmed.is_set()
                    row0 = engine.stats_row()
                    _reset_launches(qg)
                    objects: dict = {}
                    runners, published, wall, threads = _serve(
                        port, make, STREAMS, FRAMES, 512, 512, objects)
                    where = f"engine {label} {name} {run}"
                    _check_served(where, runners, published, threads)
                    if name == "A":
                        _await_warm(where, [engine])
                    row = engine.stats_row()
                    fwd = _fwd(row) - _fwd(row0)
                    if fwd == 0 or qg.launches != per * fwd:
                        raise AssertionError(
                            f"{where}: {qg.launches} qgemm launches for "
                            f"{fwd} forwards, expected {per} each")
                    served[name, run] = objects
                    for v in variants:
                        variants[v] += qg.variant_launches[v]
                    out[f"{label}_{name}_{run}"] = {
                        "assembly": row["assembly"],
                        "transfer": row["transfer"],
                        "warmed_at_start": warm_at_start,
                        **_latency_row(runners, wall), "forwards": fwd,
                        "warm_forwards":
                            row["warm_forwards"] - row0["warm_forwards"],
                        "qgemm_launches": qg.launches,
                        "bucket_batches": _bucket_delta(row0, row),
                        "graphs": row["graphs"],
                        "capture_s": row["compile_s"],
                        "graph_pool_bytes": row["graph_pool_bytes"],
                        "stage_ms": _stage_delta(port["STAGES"], row0, row)}
                if name == "A":
                    out[f"{label}_A_warm"]["replay_check"] = \
                        _replay_vs_eager(torch, port, engine, per)
                    out[f"{label}_A_warm"]["warm_split_s"] = \
                        _warm_split(engine)
            for key, objects in served.items():
                diff = _objects_diff(objects, served["B", "cold"])
                out[f"{label}_{'_'.join(key)}_vs_B_cold"] = diff
                if diff["frames_differing"]:
                    # not bit-equal: held to the kernel-against-plain
                    # tolerance of the track phase, and reported
                    _objects_agree(
                        {(s, q): o for s, per_s in objects.items()
                         for q, o in per_s.items()},
                        {(s, q): o for s, per_s in served["B", "cold"].items()
                         for q, o in per_s.items()})
        for (label, params, pipeline), (name, hub) in itertools.product(
                (("detect", {"threshold": 0.2}, DETECT_PIPELINE),
                 ("fused", {"detection-threshold": 0.2}, CLS_PIPELINE)),
                hubs.items()):
            prof = _profile_serve(
                torch, port, hub, STREAMS, FRAMES, 512, 512,
                make=_pipeline_stages(port, hub, params, pipeline))
            out[f"{label}_{name}_profiled"] = {
                k: prof[k] for k in ("wall_s", "device_busy_ms",
                                     "device_busy_share", "kernel_launches")}
        out["host_per_frame"] = _host_frame_ms(port)
        # the same detect engine built again in this process: what its
        # warmup costs once the first engine has paid the one-time set-up
        hubs["C"] = _default_hub(port, registry, stall_timeout_s=ENGINE_STALL_S)
        second = _pipeline_stages(port, hubs["C"], {"threshold": 0.2},
                                  DETECT_PIPELINE)("warm", None)[0].engine
        _await_warm("engine second", [second])
        out["detect_second_engine_warm_split_s"] = _warm_split(second)
        hubs.pop("C").stop()
        out["wedge"] = _wedge_and_recover(
            torch, port, hubs["A"],
            hubs["A"].engine("detect", KEY,
                             score_threshold=port["ENGINE_SCORE_FLOOR"]))
        out["graph_workspaces"] = _graph_workspaces(torch, port)
        out["own_streams"] = _own_streams(torch, port)
        _print(out)
        return {**out, "variants": variants}
    finally:
        for hub in hubs.values():
            hub.stop()


#: the tracking pipeline (detect+classify fused, then track) and the
#: detect pipeline the gate phase serves with inference-interval adaptive
TRACK_PIPELINE = ("object_tracking", "person_vehicle_bike")
DETECT_PIPELINE = ("object_detection", "person_vehicle_bike")
GATED = {"inference-interval": "adaptive"}


def _sequential(port, make, streams: int, frames: int) -> dict:
    """The streams one after another, one frame in flight: every forward
    is a batch of one frame, whichever qgemm runs. Returns (stream id,
    seq) → published objects."""
    out: dict[tuple[str, int], list] = {}

    def publish(ctx):
        out[(ctx.stream_id, ctx.seq)] = ctx.metadata["objects"]

    for s in range(streams):
        uri = f"synthetic://512x512@30?count={frames}&seed={s}"
        runner = port["StreamRunner"](f"s{s}", make(uri, publish), uri,
                                      window=1)
        runner.run(port["SyntheticSource"].from_uri(uri).frames())
        if runner.errors:
            raise AssertionError(f"sequential s{s}: {runner.errors} errors")
    return out


def _objects_agree(kernel: dict, plain: dict) -> dict:
    """Kernel-path against plain-path objects, frame by frame: the same
    count, labels, ids and attribute labels, boxes within 1e-3 and
    confidences within 1e-2. Returns counts; raises on the first
    frame that differs."""
    objects = exact = 0
    for key in sorted(plain):
        k, p = kernel.get(key), plain[key]
        ok = k is not None and len(k) == len(p)
        for ko, po in zip(k or [], p):
            kb, pb = ko["detection"]["bounding_box"], po["detection"]["bounding_box"]
            ok = ok and (ko.get("id"), ko["detection"]["label"]) == (
                po.get("id"), po["detection"]["label"])
            ok = ok and max(abs(kb[c] - pb[c]) for c in pb) <= 1e-3
            ok = ok and abs(ko["detection"]["confidence"]
                            - po["detection"]["confidence"]) <= 1e-2
            for a in ATTRIBUTES:
                ok = ok and (a in ko) == (a in po)
                if a in po:
                    ok = ok and ko[a]["label"] == po[a]["label"] and abs(
                        ko[a]["confidence"] - po[a]["confidence"]) <= 1e-2
            objects += 1
            exact += ko == po
        if not ok:
            raise AssertionError(
                f"track check: frame {key} differs between the kernel and "
                f"the plain qgemm: {json.dumps(k)[:600]} vs "
                f"{json.dumps(p)[:600]}")
    return {"frames": len(plain), "objects": objects, "exact_objects": exact}


def phase_track(torch, port) -> dict:
    """The tracking pipeline (object_tracking/person_vehicle_bike: detect
    and classify fused in one engine, then the tracker) at full width,
    served to STREAMS streams; then the same traffic one frame at a
    time with the kernel and with the plain qgemm on the card."""
    qg, ql = port["qgemm"], port["qlinear"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    # the kernel-against-plain runs need the eager step (a replay runs
    # the kernel it captured whatever qgemm is bound): no warmup there
    eager_hub = port["EngineHub"](registry, device="cuda")
    try:
        make = _pipeline_stages(port, hub, {"detection-threshold": 0.2},
                                TRACK_PIPELINE)
        stages = make("warm", None)
        kinds = [type(st).__name__ for st in stages]
        if kinds[:2] != ["FusedDetectClassifyStage", "TrackStage"]:
            raise AssertionError(f"track: stages {kinds}")
        engine = stages[0].engine
        _await_warm("track", [engine])
        fwd0 = _fwd(engine.stats_row())
        _reset_launches(qg)
        objects: dict[str, dict[int, list]] = {}
        runners, published, wall, threads = _serve(
            port, make, STREAMS, FRAMES, 512, 512, objects)
        variants = dict(qg.variant_launches)
        launches = qg.launches
        stats = engine.stats_row()
        forwards = _fwd(stats) - fwd0
        _check_served("track", runners, published, threads)
        if (forwards == 0 or launches != 13 * forwards
                or variants["masked"] > 3 * forwards):
            raise AssertionError(
                f"track: {launches} qgemm launches {variants} for {forwards} "
                "fused forwards, expected 13 per forward")
        served = [o for per in objects.values() for objs in per.values()
                  for o in objs]
        if not served or any("id" not in o for o in served):
            raise AssertionError(f"track: {len(served)} objects, some "
                                 "without an id")
        ids = [o["id"] for o in served]
        if len(set(ids)) >= len(ids):
            raise AssertionError("track: no id persists across frames")
        attributed = _attributed(served)
        if not attributed:
            raise AssertionError("track: no object carries color and type")

        make_eager = _pipeline_stages(port, eager_hub,
                                      {"detection-threshold": 0.2},
                                      TRACK_PIPELINE)
        kernel = _sequential(port, make_eager, STREAMS, FRAMES)
        ql.qgemm = qg.qgemm_reference
        try:
            plain = _sequential(port, make_eager, STREAMS, FRAMES)
        finally:
            ql.qgemm = qg.qgemm
        check = {"phase": "track-check", **_objects_agree(kernel, plain),
                 "ids": len({o["id"] for objs in plain.values() for o in objs})}
        _print(check)
        _print({"phase": "track", "streams": STREAMS,
                **_latency_row(runners, wall), "forwards": forwards,
                "qgemm_launches": launches, "variants": variants,
                "objects": len(served), "distinct_ids": len(set(ids)),
                "attributed_objects": attributed,
                "occupancy": stats["mean_occupancy"],
                "bucket_batches": stats["bucket_batches"],
                "stage_ms": stats["stage_ms"]})
        return variants
    finally:
        hub.stop()
        eager_hub.stop()


def _replay_gate(port, stream: int) -> list[bool]:
    """The port's MotionGate alone over one stream's frames, on the host:
    the run/skip sequence the served stage must give."""
    gate = port["MotionGate"](port["GateConfig"].from_properties(GATED))
    return [gate.decide(ev.frame) for ev in port["SyntheticSource"](
        512, 512, count=FRAMES, seed=stream).frames()]


def phase_gate(torch, port, slice_fps: float | None) -> dict:
    """person_vehicle_bike with inference-interval adaptive, served to
    STREAMS streams: the motion gate decides per frame, skipped frames
    never reach the engine and coast the last detections."""
    qg, gate_mod = port["qgemm"], port["gate"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    try:
        base = _pipeline_stages(port, hub, {"threshold": 0.2, **GATED},
                                DETECT_PIPELINE)
        engine = base("warm", None)[0].engine
        _await_warm("gate", [engine])
        decisions: dict[str, list[bool]] = {}
        gates = {}

        def make(uri, publish):
            stages = base(uri, publish)
            gate = stages[0].gate
            if gate is None or stages[0].engine is not engine:
                raise AssertionError("gate: the detect stage built no gate, "
                                     "or another engine than the warmed one")
            record = decisions.setdefault(uri, [])
            decide = gate.decide

            def recording(frame):
                run = decide(frame)
                record.append(run)
                return run
            gate.decide = recording
            gates[uri] = gate
            return stages

        gate_mod.registry.reset()
        row0 = engine.stats_row()
        _reset_launches(qg)
        runners, published, wall, threads = _serve(
            port, make, STREAMS, FRAMES, 512, 512)
        variants = dict(qg.variant_launches)
        launches = qg.launches
        summary = gate_mod.registry.summary()
        row = engine.stats_row()
        forwards = _fwd(row) - _fwd(row0)
        items = row["items"] - row0["items"]
        _check_served("gate", runners, published, threads)
        ran = sum(g.ran for g in gates.values())
        skipped = sum(g.skipped for g in gates.values())
        for uri, gate in gates.items():
            if gate.ran + gate.skipped != FRAMES:
                raise AssertionError(f"gate {uri}: ran {gate.ran} + skipped "
                                     f"{gate.skipped} != {FRAMES}")
        replay = {f"synthetic://512x512@30?count={FRAMES}&seed={s}":
                  _replay_gate(port, s) for s in range(STREAMS)}
        if decisions != replay:
            bad = [u for u in replay if decisions.get(u) != replay[u]]
            raise AssertionError(f"gate: decisions differ from the host "
                                 f"replay on {bad}")
        if (summary["ran"], summary["skipped"], summary["streams"]) != (
                ran, skipped, STREAMS):
            raise AssertionError(f"gate: registry {summary} against ran "
                                 f"{ran}, skipped {skipped}")
        if items != ran or forwards == 0 or launches != 10 * forwards \
                or variants["masked"]:
            raise AssertionError(
                f"gate: the engine took {items} frames in {forwards} forwards "
                f"({launches} qgemm launches {variants}) for {ran} ran frames")
        if skipped == 0:
            raise AssertionError("gate: no frame was skipped")
        lat = _latency_row(runners, wall)
        _print({"phase": "gate", "streams": STREAMS, **lat,
                "slice_fps": slice_fps,
                "fps_over_slice": (lat["fps"] / slice_fps
                                   if slice_fps else None),
                "ran": ran, "skipped": skipped,
                "skip_rate": skipped / (ran + skipped),
                "max_consecutive_skips": max(
                    g.max_consecutive_skips for g in gates.values()),
                "registry": summary, "forwards": forwards, "items": items,
                "qgemm_launches": launches,
                "occupancy": row["mean_occupancy"],
                "bucket_batches": row["bucket_batches"],
                "stage_ms": row["stage_ms"]})
        gate_mod.registry.reset()
        return variants
    finally:
        hub.stop()


#: the unfused detect+classify path of the ragged and tune phases: one
#: detect and one classify engine (reclassify-interval > 1 stops the
#: fusion pass)
UNFUSED = {"reclassify-interval": 3}
#: the consolidated ladder of a packed hub at max_batch 128
PACKED_LADDER = [1, 2, 8, 32, 128]
#: packed against dense, on probabilities: float32 and INT8 (bf16
#: activations; cuDNN may take another algorithm at each batch)
PACKED_ATOL = {"float32": 1e-5, "int8": 2e-2}
#: detection thresholds the ragged phase chooses from (the seeded SSD's
#: vehicle scores crowd between 0.3 and 0.4)
THRESHOLDS = (0.1, 0.2, 0.3, *(round(0.3 + 0.01 * i, 2) for i in range(1, 13)))
#: the classify stages' ingest size (stages/infer.py ClassifyStage)
CLS_INGEST = (432, 768)


def _vehicle_threshold(torch, port, model) -> dict:
    """The highest detection threshold of THRESHOLDS at which most frames
    (half or more) still carry 1–8 vehicles, else the one where the most
    do: the first 4 frames of each of the STREAMS streams through the
    detect step at the engine's score floor."""
    import numpy as np

    step = port["build_detect_step"](
        model, score_threshold=port["ENGINE_SCORE_FLOOR"], wire_format="i420")
    frames = np.stack([
        port["wire_frame"](ev.frame, (512, 512), "i420")
        for s in range(STREAMS)
        for ev in port["SyntheticSource"](512, 512, count=4,
                                          seed=s).frames()])
    rows = step(torch.from_numpy(frames).to(model.device)).cpu().numpy()
    vehicle = model.labels.index("vehicle")
    counts = {}
    for t in THRESHOLDS:
        n = ((rows[..., 6] > 0.5) & (rows[..., 4] >= t)
             & (rows[..., 5] == vehicle)).sum(-1)
        counts[t] = {"share_1_to_8": float(((n >= 1) & (n <= 8)).mean()),
                     "mean": float(n.mean())}
    most = [t for t in THRESHOLDS if counts[t]["share_1_to_8"] >= 0.5]
    best = (max(most) if most else
            max(THRESHOLDS, key=lambda t: counts[t]["share_1_to_8"]))
    return {"threshold": best, "by_threshold": counts}


def _classify_inputs(torch, port, device, counts: list[int],
                     seed: int = 21):
    """Wire frames at the classify ingest size, one per entry of
    ``counts``, and that many random valid boxes each: dense [B, 8, 4]
    (zero rows past each count) and packed [U, 4] with its seg (−1 on a
    pad tail: U = unit_rows(B) of a packed classify engine)."""
    import numpy as np

    h, w = CLS_INGEST
    frames = torch.from_numpy(np.stack([
        port["wire_frame"](next(port["SyntheticSource"](
            w, h, count=1, seed=seed + i).frames()).frame, (h, w), "i420")
        for i in range(len(counts))])).to(device)
    gen = torch.Generator().manual_seed(seed)
    dense = torch.zeros((len(counts), ROI_BUDGET, 4))
    packed, seg = [], []
    for i, k in enumerate(counts):
        p = torch.rand((k, 2, 2), generator=gen)
        b = torch.cat([p.amin(1), p.amax(1)], -1)
        dense[i, :k] = b
        packed.append(b)
        seg += [i] * k
    u = max(ROI_BUDGET, 4 * len(counts))
    units = len(seg)
    boxes = torch.zeros((u, 4))
    boxes[:units] = torch.cat(packed)
    seg = torch.tensor(seg + [-1] * (u - units), dtype=torch.int32)
    return frames, dense.to(device), boxes.to(device), seg.to(device), units


def _packed_vs_dense_step(torch, port, models: dict) -> dict:
    """The packed classify step against the dense one on the card, at
    float32 and INT8, on the same frames and boxes: every real unit
    within PACKED_ATOL of its dense row, the same argmax per head
    wherever the dense top-2 margin exceeds the tolerance, pad rows
    exactly zero."""
    counts = [3, 0, 8, 1, 5, 2, 7, 4]
    out = {}
    for dtype, model in models.items():
        frames, dense, boxes, seg, units = _classify_inputs(
            torch, port, model.device, counts)
        tol = PACKED_ATOL[dtype]
        d = port["build_classify_step"](model, wire_format="i420")(
            frames, dense)
        p = port["build_classify_step_ragged"](model, wire_format="i420")(
            frames, boxes, seg)
        want = torch.cat([d[i, :k] for i, k in enumerate(counts)])
        got = p[:units]
        diff = (got - want).abs().max().item()
        margin_ok = True
        for a, b in ((0, 7), (7, 11)):
            top = want[:, a:b].topk(2, dim=-1).values
            decided = (top[:, 0] - top[:, 1]) > tol
            same = want[:, a:b].argmax(-1) == got[:, a:b].argmax(-1)
            margin_ok &= bool(same[decided].all())
        pad_zero = bool((p[units:] == 0).all())
        out[dtype] = {"units": units, "rows": int(p.shape[0]),
                      "max_abs_diff": diff, "bit_equal": diff == 0.0,
                      "tolerance": tol, "labels_equal_where_decided":
                      margin_ok, "pad_rows_zero": pad_zero}
        if (diff > tol or not margin_ok or not pad_zero
                or not torch.isfinite(p).all()):
            raise AssertionError(f"ragged: packed against dense {dtype}: "
                                 f"{out[dtype]}")
    _print({"phase": "ragged-step", **out})
    return out


def _packed_replay_vs_eager(torch, port, engine) -> dict:
    """One packed batch (8 frames, 30 real units in a block of 32)
    through the classify engine's captured graph of bucket 8 and through
    its step eagerly: the same bits, and 3 kernel launches per replay."""
    live = getattr(engine, "_engine", engine)
    bg = live._graphs.get(IMAGES)
    if bg is None:
        raise AssertionError(f"ragged: no packed graph for bucket {IMAGES}")
    frames, _, boxes, seg, units = _classify_inputs(
        torch, port, live.device, [3, 0, 8, 1, 5, 2, 7, 4], seed=33)
    eager = live.step_fn(frames, boxes, seg).cpu()
    before = port["qgemm"].launches
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        replayed = live._graphs.replay(bg, [frames, boxes, seg]).cpu()
    torch.cuda.synchronize()
    launched = port["qgemm"].launches - before
    equal = bool(torch.equal(replayed, eager))
    if launched != 3 or not equal or replayed.shape[0] != 32:
        raise AssertionError(f"ragged: packed replay launched {launched}, "
                             f"equal to eager: {equal}")
    return {"bucket": IMAGES, "unit_rows": int(replayed.shape[0]),
            "units": units, "replay_equals_eager": True,
            "replay_launches": launched}


def _attributes_diff(dense: dict, packed: dict) -> dict:
    """Published objects of the dense and the packed hub, frame by frame:
    frames whose detections are equal, and on those, each attribute's
    label agreement and confidence difference (within the INT8
    tolerance: two probability vectors within it give top confidences
    within it, whichever label wins)."""
    frames = same_det = attrs = labels_equal = 0
    conf = 0.0
    for sid, seqs in dense.items():
        for seq, (meta, _) in seqs.items():
            frames += 1
            other = packed.get(sid, {}).get(seq)
            if other is None:
                continue
            d, p = meta["objects"], other[0]["objects"]
            if [o["detection"] for o in d] != [o["detection"] for o in p]:
                continue
            same_det += 1
            for od, op in zip(d, p):
                for a in ATTRIBUTES:
                    if (a in od) != (a in op):
                        raise AssertionError(
                            f"ragged: {sid}/{seq}: {a} on one hub only")
                    if a in od:
                        attrs += 1
                        labels_equal += od[a]["label"] == op[a]["label"]
                        conf = max(conf, abs(od[a]["confidence"]
                                             - op[a]["confidence"]))
    out = {"frames": frames, "frames_same_detections": same_det,
           "attributes": attrs, "labels_equal": labels_equal,
           "max_confidence_diff": conf}
    if same_det < 0.95 * frames or attrs == 0 \
            or conf > PACKED_ATOL["int8"]:
        raise AssertionError(f"ragged: published outputs differ: {out}")
    return out


def _engine_summary(stages, row: dict, row0: dict) -> dict:
    return {"buckets": row["buckets"], "graphs": row["graphs"],
            "graph_pool_bytes": row["graph_pool_bytes"],
            "mean_occupancy": row["mean_occupancy"],
            "unit_occupancy": row["unit_occupancy"],
            "bucket_batches": _bucket_delta(row0, row),
            "stage_ms": _stage_delta(stages, row0, row)}


def _oversize_split(torch, port, registry) -> dict:
    """Batches past the top bucket on the card, as in the reference's
    oversize tests: a legacy-assembly engine whose ladder is shrunk to
    [2, 4] under max_batch 16 takes 10 items in one deadline, and a
    packed scheduler engine takes one class pick of 8 items of 8 units,
    past its top unit block (32 rows). Every result equals the step run
    once on the whole unsplit batch (the values are integers, so any
    reduction order gives the same bits); ``oversize_splits`` >= 1 in
    the engine's stats and in its ``/engines`` row; the dispatch thread
    is alive afterwards."""
    import types

    import numpy as np

    dev = torch.device("cuda")

    def affine(x):
        return x * 2 + 1

    def packed(frames, boxes, seg):
        src = torch.clamp(seg, 0, frames.shape[0] - 1).long()
        a = boxes.sum(-1)[:, None] + frames[src][:, :1].float()
        return torch.cat([a, a * 3], -1) * (seg >= 0).float()[:, None]

    rng = np.random.default_rng(16)
    spec = port["RaggedSpec"]("boxes", (4,), max_units=8, unit_budget=4)
    sched = port["SchedConfig"](
        deadline_ms={"realtime": 1.0, "standard": 30.0, "batch": 4.0})
    legacy = port["BatchEngine"](
        "oversize-legacy", affine, dev, max_batch=16, deadline_ms=50.0,
        input_names=("x",), stall_timeout_s=0, assembly="legacy")
    legacy.buckets = [2, 4]
    ragged = port["BatchEngine"](
        "oversize-packed", packed, dev, max_batch=8, deadline_ms=30.0,
        input_names=("frames", "boxes"), stall_timeout_s=0,
        ragged="packed", ragged_spec=spec, sched=sched, transfer="inline")
    cases = {
        "legacy": (legacy, [{"x": np.full((3,), i, np.uint8)}
                            for i in range(10)]),
        "packed": (ragged, [
            {"frames": rng.integers(0, 200, (6,), np.uint8),
             "boxes": rng.integers(0, 50, (8, 4)).astype(np.float32)}
            for _ in range(8)]),
    }
    hub = port["EngineHub"](registry, device="cuda")
    app = port["App"](types.SimpleNamespace(hub=hub))
    out: dict = {}
    try:
        for name, (eng, items) in cases.items():
            hub._engines[f"oversize:{name}"] = eng
            futs = [eng.submit(**it) for it in items]
            got = [np.asarray(f.result(timeout=60)) for f in futs]
            if name == "legacy":
                x = torch.from_numpy(np.stack([it["x"] for it in items]))
                plain = list(affine(x.to(dev)).cpu().numpy())
            else:
                frames = torch.from_numpy(
                    np.stack([it["frames"] for it in items])).to(dev)
                boxes = torch.from_numpy(
                    np.concatenate([it["boxes"] for it in items])).to(dev)
                seg = torch.arange(len(items), device=dev).repeat_interleave(
                    spec.max_units).to(torch.int32)
                rows = packed(frames, boxes, seg).cpu().numpy()
                plain = [rows[i * 8:(i + 1) * 8] for i in range(len(items))]
            equal = all(np.array_equal(g, p) for g, p in zip(got, plain))
            resp = app.handle("GET", "/engines", b"")
            row = json.loads(resp.body)[f"oversize:{name}"]
            st = eng.stats_row()
            alive = eng._dispatcher.is_alive()
            out[name] = {"items": len(items), "buckets": list(eng.buckets),
                         "batches": st["batches"],
                         "oversize_splits": st["oversize_splits"],
                         "engines_oversize_splits": row["oversize_splits"],
                         "equal_to_unsplit": equal, "dispatcher_alive": alive}
            if not equal or st["oversize_splits"] < 1 \
                    or row["oversize_splits"] != st["oversize_splits"] \
                    or not alive:
                raise AssertionError(f"ragged oversize {name}: {out[name]}")
    finally:
        legacy.stop()
        ragged.stop()
    return out


def phase_ragged(torch, port) -> dict:
    """vehicle_attributes unfused (a detect and a classify engine), the
    same STREAMS × FRAMES traffic on hub "dense" (EVAM_RAGGED off) and
    hub "packed": the published outputs, the packed and dense classify
    steps, a packed replay against its eager step, the ladder, the
    kernel's launches."""
    qg = port["qgemm"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hubs = {"dense": _default_hub(port, registry),
            "packed": _default_hub(port, registry, ragged="packed")}
    out: dict = {"phase": "ragged"}
    variants = {"aligned": 0, "masked": 0}
    try:
        pick = _vehicle_threshold(torch, port, hubs["dense"].model(KEY))
        out["threshold"] = pick
        params = {"detection-threshold": pick["threshold"], **UNFUSED}
        served = {}
        for name, hub in hubs.items():
            make = _pipeline_stages(port, hub, params)
            engines = {e.name.split(":")[0]: e for e in _stage_engines(
                make("warm", None))}
            if list(engines) != ["detect", "classify"]:
                raise AssertionError(f"ragged {name}: engines {list(engines)}")
            _await_warm(f"ragged {name}", engines.values())
            if name == "packed":
                for e in engines.values():
                    if e.buckets != PACKED_LADDER:
                        raise AssertionError(f"ragged: {e.name} ladder "
                                             f"{e.buckets}")
            row0 = {k: e.stats_row() for k, e in engines.items()}
            _reset_launches(qg)
            metas: dict = {}
            runners, published, wall, threads = _serve(
                port, make, STREAMS, FRAMES, 512, 512, metas=metas)
            _check_served(f"ragged {name}", runners, published, threads)
            rows = {k: e.stats_row() for k, e in engines.items()}
            fwd = {k: _fwd(rows[k]) - _fwd(row0[k]) for k in engines}
            want = 10 * fwd["detect"] + 3 * fwd["classify"]
            if not all(fwd.values()) or qg.launches != want \
                    or qg.variant_launches["masked"] > 3 * fwd["classify"]:
                raise AssertionError(
                    f"ragged {name}: {qg.launches} qgemm launches "
                    f"{dict(qg.variant_launches)} for forwards {fwd}, "
                    "expected 10 per detect and 3 per classify forward")
            for v in variants:
                variants[v] += qg.variant_launches[v]
            served[name] = metas
            items = rows["classify"]["items"] - row0["classify"]["items"]
            out[name] = {
                **_latency_row(runners, wall), "forwards": fwd,
                "qgemm_launches": dict(qg.variant_launches),
                "classify_items": items,
                "classify_units": (rows["classify"]["units"]
                                   - row0["classify"]["units"]),
                **{k: _engine_summary(port["STAGES"], rows[k], row0[k])
                   for k in engines}}
            if name == "packed":
                out["packed"]["replay_check"] = _packed_replay_vs_eager(
                    torch, port, engines["classify"])
        # packing wins where frames carry fewer regions than the unit
        # budget on average; reported, not asserted (it is the data's)
        out["packed_unit_occupancy_ge_dense"] = (
            out["packed"]["classify"]["unit_occupancy"]
            >= out["dense"]["classify"]["unit_occupancy"])
        out["published"] = _attributes_diff(served["dense"],
                                             served["packed"])
        f32 = port["ModelRegistry"](device="cuda", dtype="float32",
                                    allow_random_weights=True).get(CLS_KEY)
        out["step"] = _packed_vs_dense_step(
            torch, port, {"float32": f32, "int8": hubs["dense"].model(CLS_KEY)})
        out["oversize"] = _oversize_split(torch, port, registry)
        _print(out)
        return {"variants": variants, "packed": out["packed"]}
    finally:
        for hub in hubs.values():
            hub.stop()


def _class_latency(runners, priorities: list[str]) -> dict:
    out = {}
    for cls in sorted(set(priorities)):
        mine = [r for r, p in zip(runners, priorities) if p == cls]
        lat = sorted(x for r in mine for x in r.latencies)
        if lat:
            q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
            out[cls] = {"frames": len(lat), "p50_ms": 1e3 * q(0.5),
                        "p99_ms": 1e3 * q(0.99),
                        "shed": sum(r.shed for r in mine)}
        else:
            out[cls] = {"frames": 0, "shed": sum(r.shed for r in mine)}
    return out


def _check_shed(where: str, runners, published, threads) -> dict[str, int]:
    """Every frame published once, in order, or counted as shed (and
    nothing else failed). Returns the streams' sheds per stream."""
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{where}: a stream did not finish")
    for s, r in enumerate(runners):
        seqs = published.get(f"s{s}", [])
        if seqs != sorted(set(seqs)) or not set(seqs) <= set(range(FRAMES)):
            raise AssertionError(f"{where}: s{s} published out of order")
        if r.errors != r.shed or len(seqs) + r.shed != FRAMES:
            raise AssertionError(
                f"{where}: s{s} published {len(seqs)}, shed {r.shed}, "
                f"errors {r.errors} of {FRAMES} frames")
    return {r.stream_id: r.shed for r in runners}


def phase_sched(torch, port) -> dict:
    """The detect path on the default engine with the scheduler on: 4
    realtime and 4 batch streams, then the same with a batch staleness
    budget small enough to shed under that load, then the scheduler off
    on the same traffic (one registry, three hubs)."""
    qg = port["qgemm"]
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    cfg = port["SchedConfig"].from_settings(port["Settings"].from_env(
        env={"EVAM_SCHED": "1"}).sched, standard_deadline_ms=8.0)
    shed_cfg = dataclasses.replace(cfg, staleness_ms={
        **cfg.staleness_ms, "batch": SHED_BATCH_MS})
    priorities = ["realtime", "batch"] * (STREAMS // 2)
    out: dict = {"phase": "sched", "config": {
        "deadline_ms": cfg.deadline_ms, "staleness_ms": cfg.staleness_ms,
        "shed_run_batch_staleness_ms": SHED_BATCH_MS}}
    variants = {"aligned": 0, "masked": 0}
    for run, sched in (("on", cfg), ("shed", shed_cfg), ("off", None)):
        hub = _default_hub(port, registry, sched=sched)
        try:
            app = port["App"](port["PipelineRegistry"](
                port["Settings"](pipelines_dir=str(ROOT / "pipelines"),
                                 device=registry.device.type), hub=hub))
            make = _pipeline_stages(port, hub, {"threshold": 0.2},
                                    DETECT_PIPELINE)
            engine = make("warm", None)[0].engine
            _await_warm(f"sched {run}", [engine])
            row0 = engine.stats_row()
            _reset_launches(qg)
            runners, published, wall, threads = _serve(
                port, make, STREAMS, FRAMES, 512, 512, priorities=priorities)
            where = f"sched {run}"
            if run == "shed":
                sheds = _check_shed(where, runners, published, threads)
            else:
                _check_served(where, runners, published, threads)
                sheds = {}
            row = engine.stats_row()
            fwd = _fwd(row) - _fwd(row0)
            if fwd == 0 or qg.launches != 10 * fwd \
                    or qg.variant_launches["masked"]:
                raise AssertionError(f"{where}: {qg.launches} qgemm "
                                     f"launches for {fwd} forwards")
            for v in variants:
                variants[v] += qg.variant_launches[v]
            seen = {c: sum(r.shed for r, p in zip(runners, priorities)
                           if p == c) for c in ("realtime", "standard",
                                                "batch")}
            health = json.loads(app.handle("GET", "/healthz", b"").body)
            sched_view = json.loads(app.handle("GET", "/scheduler",
                                               b"").body)
            if health["scheduler"]["shed"] != seen \
                    or sched_view["shed"] != seen:
                raise AssertionError(
                    f"{where}: shed counts /healthz "
                    f"{health['scheduler']['shed']}, /scheduler "
                    f"{sched_view['shed']}, streams {seen}")
            if run == "shed" and not seen["batch"]:
                raise AssertionError(f"{where}: no batch frame was shed")
            if row["state"] != "running" or row["restarts"] \
                    or engine.stalled.is_set():
                raise AssertionError(f"{where}: engine {row['state']}, "
                                     f"{row['restarts']} restarts")
            out[run] = {**_latency_row(runners, wall),
                        "capacity_fps": sched_view["capacity_fps"],
                        "by_class": _class_latency(runners, priorities),
                        "shed": seen, "shed_per_stream": sheds,
                        "forwards": fwd,
                        "sched_enabled": health["scheduler"]["enabled"],
                        "bucket_batches": _bucket_delta(row0, row),
                        "stage_ms": _stage_delta(port["STAGES"], row0, row)}
        finally:
            hub.stop()
    _print(out)
    return variants


def _tune_env(port, on: bool) -> None:
    """EVAM_TUNE on (a 0.25 s tick, EVAM_TRANSFER_DEPTH pinned at its
    default) or off; the port's settings and live operating point are
    read again."""
    for var, value in TUNE_ENV.items():
        if on:
            os.environ[var] = value
        else:
            os.environ.pop(var, None)
    port["reset_settings"]()
    port["control_state"].reset_cache()


def phase_tune(torch, port) -> dict:
    """EVAM_TUNE=1 (EVAM_TUNE_INTERVAL_S=0.25) over the ragged path: the
    registry runs the controller while STREAMS streams of the unfused
    vehicle_attributes pipeline are served on a packed hub; the
    operating point is read from /scheduler every tick."""
    qg = port["qgemm"]
    _tune_env(port, True)
    try:
        registry = port["ModelRegistry"](device="cuda",
                                         allow_random_weights=True)
        hub = _default_hub(port, registry, ragged="packed")
        preg = port["PipelineRegistry"](
            port["Settings"](pipelines_dir=str(ROOT / "pipelines"),
                             device=registry.device.type), hub=hub)
        app = port["App"](preg)
        try:
            if preg.tuner is None or not preg.tuner.pins["transfer_depth"]:
                raise AssertionError("tune: no controller, or "
                                     "EVAM_TRANSFER_DEPTH not pinned")
            make = _pipeline_stages(port, hub, {"detection-threshold": 0.2,
                                                **UNFUSED})
            engines = {e.name.split(":")[0]: e for e in _stage_engines(
                make("warm", None))}
            _await_warm("tune", engines.values())
            row0 = {k: e.stats_row() for k, e in engines.items()}
            _reset_launches(qg)
            timeline = []
            done = threading.Event()

            def watch():
                last = -1
                while not done.wait(0.05):
                    t = json.loads(app.handle("GET", "/scheduler",
                                              b"").body)["tuning"]
                    if t["ticks"] != last:
                        last = t["ticks"]
                        timeline.append({"ticks": t["ticks"],
                                         "op": t["operating_point"]})

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            try:
                runners, published, wall, threads = _serve(
                    port, make, STREAMS, TUNE_FRAMES, 512, 512)
            finally:
                done.set()
                watcher.join(timeout=5)
            _check_served("tune", runners, published, threads,
                          frames=TUNE_FRAMES)
            rows = {k: e.stats_row() for k, e in engines.items()}
            fwd = {k: _fwd(rows[k]) - _fwd(row0[k]) for k in engines}
            if qg.launches != 10 * fwd["detect"] + 3 * fwd["classify"]:
                raise AssertionError(f"tune: {qg.launches} qgemm launches "
                                     f"for forwards {fwd}")
            tuning = json.loads(app.handle("GET", "/scheduler",
                                           b"").body)["tuning"]
            actions = tuning["actions"]
            if tuning["ticks"] < 3 or not tuning["enabled"]:
                raise AssertionError(f"tune: {tuning['ticks']} ticks")
            if any(not a["reason"] or set(a) != {"tick", "knob", "from",
                                                 "to", "reason"}
                   for a in actions):
                raise AssertionError(f"tune: actions {actions}")
            if tuning["operating_point"]["transfer_depth"] != 0 or any(
                    a["knob"] == "transfer_depth" for a in actions):
                raise AssertionError("tune: the pinned transfer depth moved")
            variants = dict(qg.variant_launches)
            _print({"phase": "tune", **_latency_row(runners, wall),
                    "ticks": tuning["ticks"], "pins": preg.tuner.pins,
                    "operating_point": tuning["operating_point"],
                    "signals": tuning["signals"], "actions": actions,
                    "timeline": timeline, "forwards": fwd,
                    "qgemm_launches": variants})
            return variants
        finally:
            preg.stop_all()
    finally:
        _tune_env(port, False)


#: published-metadata golden (read only) and the routes the rest phase
#: drives
GOLDEN = ROOT / "tests" / "golden" / "message_eva_metadata.json"
PIPELINE = "/pipelines/" + KEY
_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")
_ENUM_RE = re.compile(r"^[A-Za-z0-9_\-/. :=,]{1,64}$")


def canonical(obj):
    """The golden files' canonical form (a copy of
    ``tests/test_golden.py::canonical``): keys and enum strings
    literal, volatile values as typed placeholders, a list as its first
    element."""
    if isinstance(obj, dict):
        return {k: canonical(obj[k]) for k in sorted(obj)}
    if isinstance(obj, list):
        return [canonical(obj[0])] if obj else []
    if isinstance(obj, bool):
        return "<bool>"
    if isinstance(obj, (int, float)):
        return "<num>"
    if isinstance(obj, str):
        if _UUID_RE.match(obj):
            return "<uuid>"
        if _ENUM_RE.match(obj):
            return obj
        return "<str>"
    if obj is None:
        return None
    return f"<{type(obj).__name__}>"


def _shape_errors(got, want, path="$") -> list[str]:
    """Where a canonical message ``got`` leaves the golden's shape
    ``want``: the same keys, ``<num>`` where it has one, and a string
    where it has a string — a label is data, so any label passes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: {got}"]
        return [e for k in want for e in _shape_errors(got[k], want[k],
                                                       f"{path}.{k}")]
    if isinstance(want, list):
        if not isinstance(got, list):
            return [f"{path}: not a list"]
        return [e for g in got for e in _shape_errors(g, want[0], path + "[]")]
    if want == "<num>":
        return [] if got == "<num>" else [f"{path}: {got!r}"]
    return [] if isinstance(got, str) and not got.startswith("<") or \
        got == "<str>" else [f"{path}: {got!r}"]


#: the attribute keys a classified object adds to the golden's shape
ATTRIBUTES = ("color", "type")


def _line_errors(msg: dict, golden: dict) -> list[str]:
    """A published line against the golden, object by object (the
    canonical form keeps only a list's first element), with finite
    numbers; vehicle attributes (``_attributed``) and a tracked object's
    ``id`` are checked apart."""
    msg = dict(msg, objects=[{k: v for k, v in o.items()
                              if k not in ATTRIBUTES + ("id",)}
                             for o in msg.get("objects", [])])
    errors = _shape_errors(canonical(msg), golden)
    for obj in msg["objects"]:
        errors += _shape_errors(canonical(obj), golden["objects"][0],
                                "$.objects[]")
        numbers = [obj["detection"]["confidence"],
                   *obj["detection"]["bounding_box"].values()]
        if not all(math.isfinite(x) for x in numbers):
            errors.append(f"not finite: {numbers}")
    return errors


def _http(base: str, method: str, path: str, body=None):
    """(status, JSON body) of one request to the port's server."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _wait_states(base: str, ids, states, timeout: float) -> dict:
    """Poll /pipelines/status until every id is in one of ``states``."""
    deadline = time.perf_counter() + timeout
    while True:
        _, rows = _http(base, "GET", "/pipelines/status")
        by_id = {r["id"]: r for r in rows if r["id"] in ids}
        if len(by_id) == len(ids) and all(
                r["state"] in states for r in by_id.values()):
            return by_id
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"instances not {states} after {timeout} s: "
                f"{[(r['id'][:8], r['state'], r.get('message')) for r in by_id.values()]}")
        time.sleep(0.05)


def _stream_body(out: Path, count: int | None, seed: int,
                 threshold: str = "threshold") -> dict:
    """A synthetic 512² stream into a file; ``threshold`` names the
    pipeline's detection-threshold parameter."""
    query = f"seed={seed}" if count is None else f"count={count}&seed={seed}"
    return {"source": {"uri": f"synthetic://512x512@30?{query}",
                       "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": {threshold: 0.2}}


CLS_PATH = "/pipelines/{}/{}".format(*CLS_PIPELINE)


def _classify_stream(base: str, out: Path, count: int, golden: dict,
                     where: str, extra: dict | None = None,
                     priority: str = "standard") -> tuple[str, int]:
    """POST one vehicle_attributes stream (``extra`` parameters, e.g.
    reclassify-interval for the unfused pair) and wait for it: ``count``
    lines of the golden's shape, in order, some objects classified.
    Returns (its classifying engine's name, its objects with
    attributes)."""
    body = _stream_body(out, count, 0, "detection-threshold")
    body["parameters"].update(extra or {})
    body["priority"] = priority
    status, iid = _http(base, "POST", CLS_PATH, body)
    if status != 200:
        raise AssertionError(f"{where}: vehicle_attributes POST gave {status} "
                             f"{iid}")
    state = _wait_states(base, [iid], ("COMPLETED", "ERROR", "ABORTED"),
                         300)[iid]
    lines = ([json.loads(x) for x in out.read_text().splitlines()]
             if out.exists() else [])
    stamps = [m["timestamp"] for m in lines]
    if state["state"] != "COMPLETED" or len(lines) != count \
            or stamps != sorted(stamps):
        raise AssertionError(f"{where}: vehicle_attributes {state['state']}, "
                             f"{len(lines)} lines")
    for m in lines:
        errors = _line_errors(m, golden)
        if errors:
            raise AssertionError(f"{where}: vehicle_attributes line off the "
                                 f"golden's shape: {errors[:3]}")
    attributed = sum(_attributed(m["objects"]) for m in lines)
    if not attributed:
        raise AssertionError(f"{where}: no vehicle_attributes object carries "
                             "color and type")
    weights = state["weights"]
    stage = ("detection+classification" if "detection+classification"
             in weights else "classification")
    return weights[stage]["engine"], attributed


#: the rest phase's UDF requests: a whole-frame zone, and two lines
#: across the frame
WHOLE_FRAME = {"zones": [{"name": "whole", "polygon": [[0, 0], [1, 0],
                                                       [1, 1], [0, 1]]}]}
TWO_LINES = {"lines": [
    {"name": "vertical", "line": [[0.5, 0.0], [0.5, 1.0]]},
    {"name": "horizontal", "line": [[0.0, 0.5], [1.0, 0.5]]}]}


def _udf_streams(base: str, registry, tmp: Path, golden: dict) -> dict:
    """POST one object_zone_count and one object_line_crossing stream of
    FRAMES frames and wait for both: every line of the golden's shape;
    every frame with objects carries one zone-count event that counts
    them all; every line-crossing object carries an id, and both UDF
    stages ran (the line-crossing UDF holds the anchors of the tracked
    objects)."""
    zone = "/pipelines/object_detection/object_zone_count"
    line = "/pipelines/object_tracking/object_line_crossing"
    ids = {}
    for path, cfg in ((zone, {"object-zone-count-config": WHOLE_FRAME}),
                      (line, {"object-line-crossing-config": TWO_LINES})):
        body = _stream_body(tmp / f"{path.rsplit('/', 1)[1]}.jsonl", FRAMES, 3)
        body["parameters"].update(cfg)
        status, iid = _http(base, "POST", path, body)
        if status != 200:
            raise AssertionError(f"rest: POST {path} gave {status} {iid}")
        ids[path] = iid
    done = _wait_states(base, list(ids.values()),
                        ("COMPLETED", "ERROR", "ABORTED"), 300)
    out = {}
    for path, iid in ids.items():
        lines = [json.loads(x) for x in (
            tmp / f"{path.rsplit('/', 1)[1]}.jsonl").read_text().splitlines()]
        if done[iid]["state"] != "COMPLETED" or len(lines) != FRAMES:
            raise AssertionError(f"rest: {path} {done[iid]['state']}, "
                                 f"{len(lines)} lines")
        for m in lines:
            errors = _line_errors({k: v for k, v in m.items()
                                   if k != "events"}, golden)
            if errors:
                raise AssertionError(f"rest: {path} line off the golden's "
                                     f"shape: {errors[:3]}")
        objects = [o for m in lines for o in m["objects"]]
        events = [e for m in lines for e in m.get("events", [])]
        stages = registry.get_instance(iid).stages
        kinds = [type(st).__name__ for st in stages]
        if kinds.count("UdfStage") != 2:
            raise AssertionError(f"rest: {path} stages {kinds}")
        if path == zone:
            for m in lines:
                want = ([{"event-type": "zone-count", "zone-name": "whole",
                          "zone-count": len(m["objects"])}]
                        if m["objects"] else [])
                got = [{k: e[k] for k in ("event-type", "zone-name",
                                          "zone-count")}
                       for e in m.get("events", [])]
                if got != want:
                    raise AssertionError(f"rest: zone count events {got}, "
                                         f"expected {want}")
            if not events:
                raise AssertionError("rest: no zone-count event")
            out["zone_count"] = {"objects": len(objects),
                                 "events": len(events)}
        else:
            history = next(st._impl._history for st in stages
                           if type(st).__name__ == "UdfStage"
                           and st._impl is not None)
            if not objects or any("id" not in o for o in objects) \
                    or not history:
                raise AssertionError(
                    f"rest: line crossing: {len(objects)} objects, ids on "
                    f"{sum('id' in o for o in objects)}, {len(history)} "
                    "anchors in the UDF")
            out["line_crossing"] = {
                "objects": len(objects), "events": len(events),
                "distinct_ids": len({o["id"] for o in objects}),
                "udf_anchors": len(history)}
    return out


def _rows(objects: list[dict]):
    """Published objects → packed detect rows (x0, y0, x1, y1, score,
    label_id, valid) for ``_match_rate``."""
    import numpy as np

    return np.asarray([[o["detection"]["bounding_box"][k] for k in
                        ("x_min", "y_min", "x_max", "y_max")]
                       + [o["detection"]["confidence"],
                          o["detection"]["label_id"], 1.0]
                       for o in objects], np.float64).reshape(-1, 7)


def phase_rest(torch, port, slice_objects: dict[int, list]) -> dict[str, int]:
    """The main path through the port's REST server, in this process,
    then one vehicle_attributes stream. Returns the qgemm launches by
    variant."""
    qg = port["qgemm"]
    golden = json.loads(GOLDEN.read_text())  # canonical already
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        settings = port["Settings"].from_env(env={
            "EVAM_PRECISION": "int8", "EVAM_ALLOW_RANDOM_WEIGHTS": "1",
            "PIPELINES_DIR": str(ROOT / "pipelines"),
            "MODELS_DIR": str(tmp / "models"),
            "EVAM_SCHED_CAPACITY_FPS": str(REST_CAPACITY_FPS)})
        registry = port["PipelineRegistry"](settings)
        server = port["make_server"](port["App"](registry), "127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            # the model and engine are built and warmed before the clock
            # starts (EVAM_PRELOAD's path), as in the slice phase
            t_warm = time.perf_counter()
            if registry.preload(KEY) != 1:
                raise AssertionError("rest: preload built no pipeline")
            engine = registry.hub.engine(
                "detect", KEY, score_threshold=port["ENGINE_SCORE_FLOOR"])
            _await_warm("rest", [engine])
            warm_s = time.perf_counter() - t_warm
            fwd0 = _fwd(engine.stats_row())
            _reset_launches(qg)
            t0 = time.perf_counter()
            ids = []
            for s in range(STREAMS):
                status, iid = _http(base, "POST", PIPELINE, _stream_body(
                    tmp / f"s{s}.jsonl", FRAMES, s))
                if status != 200:
                    raise AssertionError(f"rest: POST {s} gave {status} {iid}")
                ids.append(iid)
            done = _wait_states(base, ids, ("COMPLETED", "ERROR", "ABORTED"),
                                timeout=600)
            wall = time.perf_counter() - t0
            launches = qg.launches
            masked = qg.variant_launches["masked"]
            bad = {i[:8]: (r["state"], r.get("message"))
                   for i, r in done.items() if r["state"] != "COMPLETED"}
            if bad:
                raise AssertionError(f"rest: instances did not complete: {bad}")
            _, engines = _http(base, "GET", "/engines")
            _, health = _http(base, "GET", "/healthz")
            if list(engines) != [f"detect:{KEY}"]:
                raise AssertionError(f"rest: engines {list(engines)}, "
                                     "expected one shared detect engine")
            row = engines[f"detect:{KEY}"]
            forwards = _fwd(row) - fwd0
            if forwards == 0 or launches != 10 * forwards or masked:
                raise AssertionError(
                    f"rest: {launches} qgemm launches ({masked} masked) for "
                    f"{forwards} forwards, expected 10 aligned per forward")

            frames = 0
            n_objects = 0
            for s in range(STREAMS):
                lines = [json.loads(x) for x in
                         (tmp / f"s{s}.jsonl").read_text().splitlines()]
                stamps = [m["timestamp"] for m in lines]
                if len(lines) != FRAMES or stamps != sorted(stamps):
                    raise AssertionError(
                        f"rest: stream {s} published {len(lines)} lines, "
                        f"in timestamp order: {stamps == sorted(stamps)}")
                for m in lines:
                    errors = _line_errors(m, golden)
                    if errors:
                        raise AssertionError(f"rest: stream {s} line off the "
                                             f"golden's shape: {errors[:3]}")
                    n_objects += len(m["objects"])
                frames += len(lines)
                if s == 0:
                    rates = [_match_rate(_rows(slice_objects[i]),
                                         _rows(m["objects"]))
                             for i, m in enumerate(lines)]
            if not any(slice_objects.values()) or min(rates) < 0.95:
                raise AssertionError(
                    f"rest: stream 0 matches the slice run at {min(rates)} "
                    f"({sum(map(len, slice_objects.values()))} objects)")

            # one detect+classify stream: the fused engine, 13 launches
            # per forward, some of them masked at small buckets
            _reset_launches(qg)
            fused, attributed = _classify_stream(
                base, tmp / "cls.jsonl", FRAMES, golden, "rest")
            # built by the POST, it warmed while the stream ran: count
            # once its warmup is over
            _await_warm("rest", [registry.hub._engines[fused]])
            _, engines = _http(base, "GET", "/engines")
            cls_fwd = _fwd(engines[fused])
            cls_variants = dict(qg.variant_launches)
            if (cls_fwd == 0 or qg.launches != 13 * cls_fwd
                    or cls_variants["masked"] > 3 * cls_fwd):
                raise AssertionError(
                    f"rest: {qg.launches} qgemm launches {cls_variants} for "
                    f"{cls_fwd} fused forwards, expected 13 per forward")

            # the UDF pipelines on the same detect engine: zone count
            # with a whole-frame zone, line crossing with two lines
            _reset_launches(qg)
            det_fwd0 = _fwd(engines[f"detect:{KEY}"])
            udf = _udf_streams(base, registry, tmp, golden)
            _, engines = _http(base, "GET", "/engines")
            udf_fwd = _fwd(engines[f"detect:{KEY}"]) - det_fwd0
            udf_variants = dict(qg.variant_launches)
            if udf_fwd == 0 or qg.launches != 10 * udf_fwd \
                    or udf_variants["masked"]:
                raise AssertionError(
                    f"rest: {qg.launches} qgemm launches {udf_variants} for "
                    f"{udf_fwd} detect forwards of the UDF pipelines, "
                    "expected 10 aligned per forward")

            # the frame-level pipelines on their own engines: no
            # kernel launch
            _reset_launches(qg)
            frame_level = _frame_level_streams(base, tmp, golden)
            if qg.launches:
                raise AssertionError(f"rest: {qg.launches} qgemm launches "
                                     "in the action and audio pipelines")

            # a long ninth stream, deleted while it runs
            status, long_id = _http(base, "POST", PIPELINE, _stream_body(
                tmp / "long.jsonl", None, 9))
            if status != 200:
                raise AssertionError(f"rest: long POST gave {status} {long_id}")
            deadline = time.perf_counter() + 120
            while not (tmp / "long.jsonl").exists() or \
                    not (tmp / "long.jsonl").read_text():
                if time.perf_counter() > deadline:
                    raise AssertionError("rest: the long stream published nothing")
                time.sleep(0.05)
            status, _ = _http(base, "DELETE", f"{PIPELINE}/{long_id}")
            final = _wait_states(base, [long_id],
                                 ("COMPLETED", "ERROR", "ABORTED"), 60)
            if status != 200 or final[long_id]["state"] != "ABORTED":
                raise AssertionError(f"rest: DELETE gave {status}, state "
                                     f"{final[long_id]['state']}")

            errors = {
                "404": _http(base, "GET", "/pipelines/object_detection/nope"),
                "400": _http(base, "POST", PIPELINE, {"destination": {}}),
            }
            for want, (status, body) in errors.items():
                if str(status) != want or "error" not in body:
                    raise AssertionError(f"rest: expected {want}, got "
                                         f"{status} {body}")
            # the WebRTC frame destination without ENABLE_WEBRTC: ignored,
            # the stream served, as in the reference
            status, webrtc_id = _http(
                base, "POST", PIPELINE,
                {"source": {"uri": "synthetic://64x64@30?count=1",
                            "type": "uri"},
                 "destination": {
                     "metadata": {"type": "file",
                                  "path": str(tmp / "webrtc.jsonl")},
                     "frame": {"type": "webrtc", "peer-id": "cam0"}}})
            if status != 200:
                raise AssertionError(f"rest: webrtc POST gave {status} "
                                     f"{webrtc_id}")
            state = _wait_states(base, [webrtc_id],
                                 ("COMPLETED", "ERROR", "ABORTED"), 60)
            if state[webrtc_id]["state"] != "COMPLETED" or len(
                    (tmp / "webrtc.jsonl").read_text().splitlines()) != 1:
                raise AssertionError(f"rest: webrtc stream {state}")
            _, engines_after = _http(base, "GET", "/engines")
            if sorted(engines_after) != sorted([
                    f"detect:{KEY}", fused, f"action_encode:{ENC_KEY}",
                    f"action_decode:{DEC_KEY}", f"audio:{AUDIO_KEY}"]):
                raise AssertionError(f"rest: engines {list(engines_after)} "
                                     "after the error requests")
            result = {
                "phase": "rest", "streams": STREAMS, "frames": frames,
                "objects": n_objects, "warm_s": warm_s, "wall_s": wall,
                "fps": frames / wall,
                "avg_fps": [done[i]["avg_fps"] for i in ids],
                "forwards": forwards, "qgemm_launches": launches,
                "mean_occupancy": row["mean_occupancy"],
                "bucket_batches": row["bucket_batches"],
                "host_stages_ms": health["host_stages_ms"],
                "match_rate_s0": min(rates),
                "vehicle_attributes": {
                    "engine": fused, "forwards": cls_fwd,
                    "qgemm_launches": sum(cls_variants.values()),
                    "variants": cls_variants, "attributed_objects": attributed,
                    "occupancy": engines[fused]["mean_occupancy"]},
                "udf": {**udf, "forwards": udf_fwd, "variants": udf_variants},
                "frame_level": frame_level,
                "errors": {k: v[1]["error"] for k, v in errors.items()},
                "webrtc_off": "served"}
            _print(result)
            return {"aligned": launches + cls_variants["aligned"]
                    + udf_variants["aligned"],
                    "masked": cls_variants["masked"]}
        finally:
            server.shutdown()
            server.server_close()
            registry.stop_all()


# ------------------------------------------- action recognition, audio

ENC_KEY = "action_recognition/encoder"
DEC_KEY = "action_recognition/decoder"
AUDIO_KEY = "audio_detection/environment"
ACTION_PIPELINE = ("action_recognition", "general")
AUDIO_PIPELINE = ("audio_detection", "environment")
#: the action phase's traffic: synthetic 512×512 streams × frames each
ACTION_STREAMS, ACTION_FRAMES = 4, 48
#: the audio phase's traffic: synthetic tone streams × seconds each
AUDIO_STREAMS, AUDIO_SECONDS = 4, 5
#: the audio pipeline's 100 ms chunks (audiomixer) and its window
CHUNK_SAMPLES, WINDOW_SAMPLES = 1600, 16000
#: card against CPU at float32 (TF32 off, set in main): an output
#: within FP32_RTOL × its largest CPU magnitude; top-1 equal wherever
#: the CPU's top-2 margin exceeds twice that
FP32_RTOL = 1e-4


def phase_weights(torch, port) -> dict:
    """The models-dir layout written and read on the card: the INT8 SSD
    and the action decoder saved with the port's ``save_weights``, then
    loaded through a registry that refuses random weights, with the
    ``msgpack`` package blocked (the port's standard-library codec, on a
    machine with or without it): every tensor and the forward outputs
    on one input equal."""
    import importlib.util

    keys = (KEY, DEC_KEY)
    saver = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    if saver.precision != "INT8":
        raise AssertionError("weights: EVAM_PRECISION=int8 did not select INT8")
    row = {"phase": "weights", "precision": saver.precision,
           "msgpack_installed": importlib.util.find_spec("msgpack") is not None}
    blocked = sys.modules.get("msgpack", False)
    sys.modules["msgpack"] = None  # an import of it now raises
    try:
        with tempfile.TemporaryDirectory() as tmp:
            models = Path(tmp) / "models"
            t0 = time.perf_counter()
            row["file_bytes"] = {
                k: saver.save_weights(k, models).stat().st_size for k in keys}
            row["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loader = port["ModelRegistry"](models_dir=models, device="cuda",
                                           allow_random_weights=False)
            loaded = {k: loader.get(k) for k in keys}
            row["load_s"] = time.perf_counter() - t0
    finally:
        if blocked is False:
            del sys.modules["msgpack"]
        else:
            sys.modules["msgpack"] = blocked
    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = {
        KEY: (torch.rand((2, 512, 512, 3), generator=gen, device="cuda")
              * 255).to(torch.bfloat16),
        DEC_KEY: torch.randn((2, 16, 512), generator=gen, device="cuda")}
    row["tensors"] = 0
    for key, back in loaded.items():
        if back.weight_source != "msgpack":
            raise AssertionError(f"weights: {key} loaded {back.weight_source}")
        want = saver.get(key).module.state_dict()
        got = back.module.state_dict()
        if list(got) != list(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"weights: {key} state_dict differs")
        row["tensors"] += len(got)
        with torch.inference_mode():
            a = saver.get(key).forward(inputs[key])
            b = back.forward(inputs[key])
        a, b = ((a, b) if isinstance(a, dict) else ({"out": a}, {"out": b}))
        if not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"weights: {key} forward outputs differ")
    row["forward_equal"] = True
    _print(row)
    return row


def _fp32_pair(torch, port, key: str):
    """The same seeded float32 model (full width) on the CPU and on the
    card."""
    kw = dict(dtype="float32", allow_random_weights=True)
    cpu = port["ModelRegistry"](device="cpu", **kw).get(key)
    gpu = port["ModelRegistry"](device="cuda", **kw).get(key)
    want, got = cpu.module.state_dict(), gpu.module.state_dict()
    if not all(torch.equal(want[k], got[k].cpu()) for k in want):
        raise AssertionError(f"{key}: card and CPU weights differ")
    return cpu, gpu


def _card_vs_cpu(torch, where: str, name: str, cpu_out, gpu_out,
                 top1: bool = True) -> dict:
    """``gpu_out`` within FP32_RTOL × max |cpu_out|, finite, of the same
    shape; with ``top1``, the same argmax on every row whose CPU top-2
    margin exceeds twice the tolerance."""
    r, g = cpu_out.float(), gpu_out.float().cpu()
    if g.shape != r.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{where}: bad {name} {tuple(g.shape)}")
    diff = (g - r).abs().max().item()
    scale = r.abs().max().item()
    tol = FP32_RTOL * scale
    row = {"phase": where, "output": name, "shape": list(r.shape),
           "max_abs_diff": diff, "max_abs_cpu": scale, "tolerance": tol}
    if diff > tol:
        raise AssertionError(f"{where}: {name} differs by {diff} > {tol}")
    if top1:
        top = r.topk(2, dim=-1).values
        decided = (top[:, 0] - top[:, 1]) > 2 * tol
        same = r.argmax(-1) == g.argmax(-1)
        row["top1_decided"] = int(decided.sum())
        row["top1_equal"] = int(same.sum())
        if not bool(same[decided].all()):
            raise AssertionError(f"{where}: {name} top-1 differs")
    _print(row)
    return row


def _frame_line_errors(msg: dict, golden: dict, name: str,
                       data_len: int | None = None) -> list[str]:
    """A line of a frame-level pipeline against the golden: the golden's
    keys, no objects, and each frame-level tensor with name, label,
    label_id and confidence (and ``data_len`` numbers of data), finite."""
    base = {k: v for k, v in msg.items() if k not in ("tensors", "level")}
    errors = _shape_errors(canonical(base), golden)
    if msg["objects"]:
        errors.append("objects on a frame-level line")
    keys = {"name", "label", "label_id", "confidence"} | (
        {"data"} if data_len else set())
    for t in msg.get("tensors", []):
        if set(t) != keys or t["name"] != name or not isinstance(
                t["label"], str):
            errors.append(f"tensor off shape: {sorted(t)}")
            continue
        numbers = [t["confidence"], *t.get("data", [])]
        if not all(math.isfinite(x) for x in numbers):
            errors.append("tensor not finite")
        if data_len and len(t["data"]) != data_len:
            errors.append(f"tensor data of {len(t['data'])}")
    return errors


def _engine_rows(hub, names) -> dict:
    """Batches, items, occupancy and the launch and readback ms a batch
    of each named engine."""
    stats = hub.stats()
    return {n: {"batches": stats[n]["batches"], "items": stats[n]["items"],
                "mean_occupancy": stats[n]["mean_occupancy"],
                "launch_ms": stats[n]["stage_ms"].get("launch"),
                "readback_ms": stats[n]["stage_ms"].get("readback")}
            for n in names}


def _check_actions(where: str, lines: list[dict], golden: dict) -> int:
    """No tensor before frame 16; then one 400-long ``action`` tensor a
    frame whose probabilities sum to 1. Returns the tensors."""
    clip = 16
    for seq, m in enumerate(lines):
        errors = _frame_line_errors(m, golden, "action", 400)
        if seq < clip - 1 and "tensors" in m:
            errors.append(f"a tensor at frame {seq}, before the clip filled")
        if seq >= clip - 1:
            ts = m.get("tensors", [])
            if len(ts) != 1 or abs(sum(ts[0]["data"]) - 1.0) > 1e-3:
                errors.append(f"frame {seq}: {len(ts)} action tensors")
        if errors:
            raise AssertionError(f"{where}: {errors[:3]}")
    return max(0, len(lines) - (clip - 1))


#: the native phase: synthetic 1080p streams, so every frame's encode
#: is a real resize (1080×1920 → the engines' 512²)
NATIVE_HW = (1080, 1920)
#: (source, destination) of the byte checks: the two served encodes,
#: odd sizes, an upscale and the no-resize case
NATIVE_CASES = [((1080, 1920), (512, 512)), ((1080, 1920), (432, 768)),
                ((481, 641), (64, 96)), ((97, 131), (100, 130)),
                ((33, 47), (12, 10)), ((480, 640), (480, 640))]
#: threads encoding at once in the native phase's timing
ENCODE_THREADS = 8


def _native_bytes(port) -> dict:
    """The library against the numpy copies, byte for byte, on every
    function at every NATIVE_CASES size (odd destinations for the BGR
    resize and the luma grid)."""
    import numpy as np

    native, color = port["native"], port["color"]
    checked = 0
    for (sh, sw), (dh, dw) in NATIVE_CASES:
        frame = np.random.default_rng(sh + dw).integers(
            0, 256, (sh, sw, 3), np.uint8)
        pairs = [
            (native.resize_bgr_to_i420(frame, dh, dw),
             color.resize_bgr_to_i420_host(frame, dh, dw)),
            (native.resize_bgr(frame, dh + 1, dw + 3),
             color.resize_bgr_host(frame, dh + 1, dw + 3)),
            (native.luma_grid(frame, 16, 16), port["luma_grid"](frame, 16, 16)),
            (native.luma_grid(frame, 5, 7), port["luma_grid"](frame, 5, 7)),
        ]
        if sh % 4 == 0 and sw % 2 == 0:
            pairs.append((native.bgr_to_i420(frame),
                          color.bgr_to_i420_host(frame)))
        for got, want in pairs:
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(
                    f"native: {sh}x{sw} → {dh}x{dw} differs from the numpy "
                    f"copy in {int((got != want).sum())} bytes")
            checked += 1
    return {"arrays_equal": checked}


def _encode_ms(fn, frames: list, threads: int) -> dict:
    """``fn(frame)`` over ``frames`` on each of ``threads`` threads at
    once: wall ms per frame over all threads, and frames per second."""
    barrier = threading.Barrier(threads + 1)

    def work():
        barrier.wait()
        for f in frames:
            fn(f)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t0
    n = threads * len(frames)
    return {"ms_per_frame": 1e3 * wall / n, "frames_per_s": n / wall}


def phase_native(torch, port, built: dict) -> dict:
    """The host encode in the native library (``built``: the build
    phase's ``native.build()``) against its numpy copies: bytes, ms per
    frame on one and on ENCODE_THREADS threads, then the detect and the
    fused cell served from 1080p streams with the policy on and with
    EVAM_NO_NATIVE=1."""
    import numpy as np

    native, qg = port["native"], port["qgemm"]
    if os.environ.get("EVAM_NO_NATIVE") or os.environ.get("EVAM_NATIVE"):
        raise AssertionError("native: run with EVAM_NO_NATIVE and "
                             "EVAM_NATIVE unset (the default policy)")
    out: dict = {"phase": "native", "compile_s": built["seconds"],
                 "library": built["path"], "cpu_count": os.cpu_count()}
    if not native._use_native():
        raise AssertionError(f"native: the policy is off on "
                             f"{os.cpu_count()} cores")
    out["bytes"] = _native_bytes(port)

    frames = [ev.frame for ev in port["SyntheticSource"](
        NATIVE_HW[1], NATIVE_HW[0], count=16, seed=1).frames()]
    ms = {}
    for path, fn in (("native", native.resize_bgr_to_i420),
                     ("numpy", port["color"].resize_bgr_to_i420_host)):
        for threads in (1, ENCODE_THREADS):
            ms[f"{path}_{threads}_threads"] = _encode_ms(
                lambda f: fn(f, 512, 512), frames, threads)
    out["encode_1080p_to_512"] = ms

    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    variants = {"aligned": 0, "masked": 0}
    try:
        for label, params, pipeline, per in (
                ("detect", {"threshold": 0.2}, DETECT_PIPELINE, 10),
                ("fused", {"detection-threshold": 0.2}, CLS_PIPELINE, 13)):
            make = _pipeline_stages(port, hub, params, pipeline)
            engine = make("warm", None)[0].engine
            _await_warm(f"native {label}", [engine])
            served = {}
            for policy in ("on", "off"):
                if policy == "off":
                    os.environ["EVAM_NO_NATIVE"] = "1"
                try:
                    where = f"native {label} {policy}"
                    row0 = engine.stats_row()
                    _reset_launches(qg)
                    objects: dict = {}
                    runners, published, wall, threads = _serve(
                        port, make, STREAMS, FRAMES, *NATIVE_HW, objects)
                    _check_served(where, runners, published, threads)
                    row = engine.stats_row()
                    fwd = _fwd(row) - _fwd(row0)
                    if fwd == 0 or qg.launches != per * fwd:
                        raise AssertionError(
                            f"{where}: {qg.launches} qgemm launches for "
                            f"{fwd} forwards, expected {per} each")
                    for v in variants:
                        variants[v] += qg.variant_launches[v]
                    prof = _profile_serve(torch, port, hub, STREAMS, FRAMES,
                                          *NATIVE_HW, make=make)
                finally:
                    os.environ.pop("EVAM_NO_NATIVE", None)
                served[policy] = objects
                out[f"{label}_{policy}"] = {
                    **_latency_row(runners, wall), "forwards": fwd,
                    "qgemm_launches": per * fwd,
                    "bucket_batches": _bucket_delta(row0, row),
                    "stage_ms": _stage_delta(port["STAGES"], row0, row),
                    "device_busy_share": prof["device_busy_share"],
                    "profiled_wall_s": prof["wall_s"]}
            diff = _objects_diff(served["on"], served["off"])
            out[f"{label}_on_vs_off"] = diff
            if diff["frames_differing"]:
                # batches formed otherwise: held to the kernel-against-
                # plain tolerance, and reported
                _objects_agree(
                    {(s, q): o for s, per_s in served["on"].items()
                     for q, o in per_s.items()},
                    {(s, q): o for s, per_s in served["off"].items()
                     for q, o in per_s.items()})
    finally:
        hub.stop()
    if not np.isfinite(out["detect_on"]["fps"]):
        raise AssertionError("native: no frames served")
    _print(out)
    return {"variants": variants}


#: the fleet phase's engines: each shard's ladder tops at half of it
FLEET_MAX_BATCH = 16


class _Saturation:
    """Admission stand-in for the fleet phase's controller: a set
    utilization."""

    def __init__(self, util: float):
        self.util = util

    def utilization(self) -> float:
        return self.util

    def capacity_fps(self, live: bool = False) -> float:
        return 100.0

    def effective_demand_fps(self) -> float:
        return 100.0 * self.util


def phase_fleet(torch, port) -> dict:
    """EVAM_FLEET=sharded: on this one-card machine the served path
    degrades to off; then a FleetEngine of two shards on cuda:0 built
    through the hub's device list, held against a single engine."""
    import numpy as np

    qg = port["qgemm"]
    out: dict = {"phase": "fleet", "cuda_devices": torch.cuda.device_count()}
    served_reg = port["PipelineRegistry"](port["Settings"].from_env(
        env={"EVAM_FLEET": "sharded"}))
    try:
        hub = served_reg.hub
        out["served"] = {"devices": [str(d) for d in hub.devices],
                         "fleet_active": hub.fleet_active,
                         "mode": served_reg.scheduler_status()["fleet"]["mode"]}
        if hub.fleet_active != (len(hub.devices) > 1):
            raise AssertionError(f"fleet: {out['served']}")
    finally:
        served_reg.stop_all()

    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    fleet_hub = port["EngineHub"](
        registry, device="cuda", devices=["cuda:0", "cuda:0"],
        fleet="sharded", fleet_max_shards=2, max_batch=FLEET_MAX_BATCH,
        stall_timeout_s=ENGINE_STALL_S, first_batch_grace=2.0,
        max_restarts=0, warmup=True)
    single_hub = port["EngineHub"](registry, device="cuda",
                                   max_batch=FLEET_MAX_BATCH, warmup=True)
    variants = {"aligned": 0, "masked": 0}
    try:
        params = {"threshold": 0.2}
        make_f = _pipeline_stages(port, fleet_hub, params, DETECT_PIPELINE)
        make_s = _pipeline_stages(port, single_hub, params, DETECT_PIPELINE)
        fleet = make_f("warm", None)[0].engine
        single = make_s("warm", None)[0].engine
        if not isinstance(fleet, port["FleetEngine"]) or sorted(
                fleet.shards) != ["s0", "s1"]:
            raise AssertionError(f"fleet: built {type(fleet).__name__}")
        # both hubs serve captured graphs, as `serve` does
        _await_warm("fleet", [*fleet.shards.values(), single])
        out["buckets"] = {"shard": fleet.buckets}

        # one frame in flight: every forward a batch of one on both
        seq_f = _sequential(port, make_f, STREAMS, 8)
        seq_s = _sequential(port, make_s, STREAMS, 8)
        differ = [k for k in seq_s if seq_f.get(k) != seq_s[k]]
        if differ:
            raise AssertionError(f"fleet: bucket-1 objects differ from a "
                                 f"single engine's on {differ[:4]}")
        out["same_bucket_bit_equal_frames"] = len(seq_s)
        placer = port["ConsistentHashPlacer"](["s0", "s1"])
        pins = {f"s{s}": fleet.placement(f"s{s}") for s in range(STREAMS)}
        if pins != {k: placer.place(k) for k in pins}:
            raise AssertionError(f"fleet: pins {pins} are not the placer's")
        out["placement"] = pins

        # all streams at once
        rows0 = {label: e.stats_row() for label, _, e in fleet.shard_rows()}
        _reset_launches(qg)
        objects: dict = {}
        runners, published, wall, threads = _serve(
            port, make_f, STREAMS, FRAMES, 512, 512, objects)
        _check_served("fleet", runners, published, threads)
        launches = qg.launches
        for v in variants:
            variants[v] += qg.variant_launches[v]
        per_shard = {label: 10 * (_fwd(e.stats_row()) - _fwd(rows0[label]))
                     for label, _, e in fleet.shard_rows()}
        if launches != sum(per_shard.values()) or not all(
                per_shard[label] for label in set(pins.values())):
            raise AssertionError(f"fleet: {launches} launches, per shard "
                                 f"{per_shard}")
        ref_objects: dict = {}
        ref_runners, ref_published, ref_wall, ref_threads = _serve(
            port, make_s, STREAMS, FRAMES, 512, 512, ref_objects)
        _check_served("fleet single", ref_runners, ref_published,
                      ref_threads)
        diff = _objects_diff(objects, ref_objects)
        if diff["frames_differing"]:
            _objects_agree({(s, q): o for s, p in objects.items()
                            for q, o in p.items()},
                           {(s, q): o for s, p in ref_objects.items()
                            for q, o in p.items()})
        out["served_run"] = {**_latency_row(runners, wall),
                             "k1_launches_per_shard": per_shard,
                             "vs_single_engine": diff,
                             # the same streams on one engine, also warm
                             "single_engine": _latency_row(ref_runners,
                                                           ref_wall)}

        # the batch class rides the twin: a bucket of IMAGES rows split
        # over the two shards' devices and gathered back
        pre = fleet_hub.model(KEY).preprocess
        wires = [port["wire_frame"](ev.frame, (pre.height, pre.width), "i420")
                 for s in range(IMAGES)
                 for ev in port["SyntheticSource"](512, 512, count=1,
                                                   seed=s).frames()]
        # the first batch-class frame builds the twin, which warms
        # before the rest are sent: the fleet is then warm as a whole
        fleet.submit(priority="batch", stream="bulk",
                     frames=wires[0]).result(timeout=120)
        _await_warm("fleet twin", [fleet._mesh_eng])
        if not fleet.warmed.is_set() or fleet_hub.readiness()["warming"]:
            raise AssertionError(f"fleet: {fleet_hub.readiness()}")
        futs = [fleet.submit(priority="batch", stream="bulk", frames=w)
                for w in wires]
        twin_rows = np.stack([f.result(timeout=120) for f in futs])
        single_rows = np.stack([f.result(timeout=120) for f in [
            single.submit(frames=w) for w in wires]])
        twin = fleet._mesh_eng
        rates = [_match_rate(single_rows[i], twin_rows[i])
                 for i in range(IMAGES)]
        if twin is None or twin.stats.items != IMAGES + 1 \
                or min(rates) < 0.95:
            raise AssertionError(f"fleet: the twin matched {rates}")
        out["twin"] = {"items": twin.stats.items, "buckets": twin.buckets,
                       "bucket_batches": twin.stats_row()["bucket_batches"],
                       "detections_matched": min(rates),
                       "max_abs_diff": float(np.abs(twin_rows
                                                    - single_rows).max())}

        # the eighth law through the controller: idle drains a shard,
        # saturation grows one back (warmed before it joins)
        tune = port["TuneController"](
            fleet_hub, port["TuneState"](port["TuneSettings"](
                enabled=True, damping=1, cooldown=0)),
            admission=_Saturation(0.1))
        tune.tick()
        down = sorted(fleet.shards)
        tune.admission = _Saturation(0.95)
        tune.tick()
        deadline = time.perf_counter() + 300
        while len(fleet.shards) < 2 and time.perf_counter() < deadline:
            time.sleep(0.1)
        grown = fleet.shards.get("s1")
        if down != ["s0"] or grown is None or \
                grown.stats_row()["graphs"] != len(grown.buckets):
            raise AssertionError(f"fleet: scale down gave {down}, scale up "
                                 f"{sorted(fleet.shards)}")
        out["scale"] = {"after_down": down, "after_up": sorted(fleet.shards),
                        "summary": fleet.fleet_summary(),
                        "spinup_s": fleet._last_spinup_s,
                        "actions": [a for a in tune.state.snapshot()["actions"]
                                    if a["knob"] == "fleet_shards"]}

        # a wedged shard past its restart budget (0): degraded, retired,
        # its streams re-placed onto the survivor
        stream = "s0"
        label = fleet.placement(stream)
        shard = fleet.shards[label]
        release = threading.Event()
        shard._engine.pre_launch = release.wait
        before = fleet.rebalances
        try:
            fleet.submit(stream=stream, frames=wires[0]).result(timeout=60)
            raise AssertionError("fleet: the wedged frame resolved")
        except TimeoutError:
            pass
        deadline = time.perf_counter() + 60
        while shard.state != "degraded" and time.perf_counter() < deadline:
            time.sleep(0.05)
        again = fleet.submit(stream=stream, frames=wires[0]).result(timeout=60)
        release.set()
        moved = fleet.placement(stream)
        summary = fleet.fleet_summary()
        if (shard.state != "degraded" or moved == label
                or summary["degraded_shards"] != 1
                or fleet.rebalances <= before or again.shape != (32, 7)):
            raise AssertionError(f"fleet: wedge of {label}: {summary}")
        out["wedge"] = {"shard": label, "state": shard.state,
                        "stream_moved_to": moved,
                        "rebalances": fleet.rebalances - before,
                        "summary": summary}
        _print(out)
        return {"variants": variants}
    finally:
        fleet_hub.stop()
        single_hub.stop()


def phase_action(torch, port) -> dict:
    """action_recognition/general: the full-width encoder and decoder on
    the card against the CPU at float32, then served INT8 (the float
    modules in bfloat16; no kernel of this repo on this path)."""
    import numpy as np

    qg = port["qgemm"]
    enc_cpu, enc_gpu = _fp32_pair(torch, port, ENC_KEY)
    dec_cpu, dec_gpu = _fp32_pair(torch, port, DEC_KEY)
    attn = dec_gpu.module.TransformerBlock_0.MultiHeadDotProductAttention_0
    shape = (enc_gpu.preprocess.height, enc_gpu.preprocess.width,
             enc_gpu.spec.width, enc_gpu.module.embed_dim,
             dec_gpu.module.pos_embed.shape[-1], dec_gpu.module.depth,
             tuple(attn.query.weight.shape[1:]),
             dec_gpu.module.Dense_1.out_features)
    if shape != (224, 224, 32, 512, 512, 4, (8, 64), 400):
        raise AssertionError(f"action: not the full-width models: {shape}")
    gen = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (16, 224, 224, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    wire = torch.from_numpy(np.stack([port["wire_frame"](f, (224, 224), "i420")
                                      for f in frames]))
    emb = {}
    for dev, model in (("cpu", enc_cpu), ("cuda", enc_gpu)):
        step = port["build_action_encode_step"](model, "i420")
        emb[dev] = step(wire.to(dev))
    _card_vs_cpu(torch, "action-check", "embeddings", emb["cpu"], emb["cuda"],
                 top1=False)
    clips = torch.stack([emb["cpu"].roll(i, 0) for i in range(4)])
    with torch.inference_mode():
        logits = {"cpu": dec_cpu.forward(clips),
                  "cuda": dec_gpu.forward(clips.cuda())}
    _card_vs_cpu(torch, "action-check", "logits", logits["cpu"],
                 logits["cuda"])
    probs = {dev: port["build_action_decode_step"](m)(clips.to(dev))
             for dev, m in (("cpu", dec_cpu), ("cuda", dec_gpu))}
    _card_vs_cpu(torch, "action-check", "probabilities", probs["cpu"],
                 probs["cuda"], top1=False)

    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    try:
        make = _pipeline_stages(port, hub, {}, ACTION_PIPELINE)
        (stage,) = [st for st in make("warm", None) if hasattr(st, "clip")]
        _await_warm("action", [stage.enc_engine, stage.dec_engine])
        _reset_launches(qg)
        metas: dict = {}
        runners, published, wall, threads = _serve(
            port, make, ACTION_STREAMS, ACTION_FRAMES, 512, 512, metas=metas)
        launches = qg.launches
        _check_served("action phase", runners, published, threads,
                      ACTION_FRAMES)
        if launches:
            raise AssertionError(f"action phase: {launches} qgemm launches")
        golden = json.loads(GOLDEN.read_text())
        tensors = sum(_check_actions(
            f"action phase s{s}",
            [metas[f"s{s}"][i][0] for i in range(ACTION_FRAMES)], golden)
            for s in range(ACTION_STREAMS))
        names = [f"action_encode:{ENC_KEY}", f"action_decode:{DEC_KEY}"]
        row = {"phase": "action", "streams": ACTION_STREAMS,
               "frames_per_stream": ACTION_FRAMES, "precision":
               registry.precision, **_latency_row(runners, wall),
               "action_tensors": tensors, "qgemm_launches": launches,
               "engines": _engine_rows(hub, names)}
        _print(row)
        return row
    finally:
        hub.stop()


def _replay_windows(chunks: list[int], stride: int) -> list[int]:
    """The chunks that carry a window, by the audio stage's rule
    replayed on the host: the first once a whole window has arrived,
    then each time ``stride`` more samples have."""
    have = since = 0
    out = []
    for i, n in enumerate(chunks):
        have = min(WINDOW_SAMPLES, have + n)
        since += n
        if have >= WINDOW_SAMPLES and since >= stride:
            since = 0
            out.append(i)
    return out


def _check_windows(where: str, lines: list[dict], golden: dict,
                   window: float = 0.2) -> int:
    """A ``detection`` tensor on exactly the chunks the host replay of
    the stride rule gives, and lines of the golden's shape. Returns the
    windows."""
    want = _replay_windows([CHUNK_SAMPLES] * len(lines),
                           int(WINDOW_SAMPLES * window))
    got = [i for i, m in enumerate(lines) if "tensors" in m]
    errors = [e for m in lines
              for e in _frame_line_errors(m, golden, "detection")]
    if got != want or errors:
        raise AssertionError(f"{where}: windows at {got}, replay {want}; "
                             f"{errors[:3]}")
    return len(got)


def phase_audio(torch, port) -> dict:
    """audio_detection/environment: the full-width AclNet on the card
    against the CPU at float32, then served INT8 (bfloat16 weights,
    float32 arithmetic; no kernel of this repo on this path)."""
    qg = port["qgemm"]
    cpu, gpu = _fp32_pair(torch, port, AUDIO_KEY)
    shape = (gpu.spec.input_size, gpu.spec.width, gpu.spec.num_classes)
    if shape != ((1, WINDOW_SAMPLES), 32, 53):
        raise AssertionError(f"audio: not the full-width model: {shape}")
    gen = torch.Generator().manual_seed(4)
    windows = torch.randint(-32768, 32768, (8, WINDOW_SAMPLES), generator=gen,
                            dtype=torch.int16)
    x = windows.float() / 32768.0
    with torch.inference_mode():
        logits = {"cpu": cpu.forward(x), "cuda": gpu.forward(x.cuda())}
    _card_vs_cpu(torch, "audio-check", "logits", logits["cpu"], logits["cuda"])
    probs = {dev: port["build_audio_step"](m)(windows.to(dev))
             for dev, m in (("cpu", cpu), ("cuda", gpu))}
    _card_vs_cpu(torch, "audio-check", "probabilities", probs["cpu"],
                 probs["cuda"], top1=False)

    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    try:
        make = _pipeline_stages(port, hub, {"threshold": 0.0,
                                            "sliding-window": 0.2},
                                AUDIO_PIPELINE)
        _await_warm("audio", _stage_engines(make("warm", None)))

        def source(s):
            uri = f"synthetic-audio://seconds={AUDIO_SECONDS}&seed={s}"
            return uri, port["SyntheticAudioSource"].from_uri(uri)

        chunks = AUDIO_SECONDS * 16000 // CHUNK_SAMPLES
        _reset_launches(qg)
        metas: dict = {}
        runners, published, wall, threads = _serve(
            port, make, AUDIO_STREAMS, chunks, 0, 0, metas=metas,
            source=source)
        launches = qg.launches
        _check_served("audio phase", runners, published, threads, chunks)
        if launches:
            raise AssertionError(f"audio phase: {launches} qgemm launches")
        golden = json.loads(GOLDEN.read_text())
        n_windows = 0
        lat = []
        for s in range(AUDIO_STREAMS):
            rows = [metas[f"s{s}"][i] for i in range(chunks)]
            n_windows += _check_windows(f"audio phase s{s}",
                                        [m for m, _ in rows], golden)
            lat += [t for m, t in rows if "tensors" in m]
        lat.sort()
        q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
        names = [f"audio:{AUDIO_KEY}"]
        rows = _engine_rows(hub, names)
        if rows[names[0]]["items"] != n_windows:
            raise AssertionError(f"audio phase: {rows} for {n_windows} windows")
        row = {"phase": "audio", "streams": AUDIO_STREAMS,
               "seconds_per_stream": AUDIO_SECONDS,
               "precision": registry.precision, "windows": n_windows,
               "wall_s": wall, "windows_per_s": n_windows / wall,
               "window_p50_ms": 1e3 * q(0.50), "window_p99_ms": 1e3 * q(0.99),
               "chunks": sum(len(r.latencies) for r in runners),
               "qgemm_launches": launches, "engines": rows}
        _print(row)
        return row
    finally:
        hub.stop()


def _frame_level_streams(base: str, tmp: Path, golden: dict) -> dict:
    """POST one action_recognition/general stream (24 frames at 512²)
    and one audio_detection/environment stream (3 s), and wait for both:
    COMPLETED, lines of the golden's shape, action tensors from frame
    16 on, detection tensors on the replayed windows."""
    bodies = {
        "/pipelines/{}/{}".format(*ACTION_PIPELINE): (
            "synthetic://512x512@30?count=24&seed=0", {}, tmp / "action.jsonl"),
        "/pipelines/{}/{}".format(*AUDIO_PIPELINE): (
            "synthetic-audio://seconds=3&seed=1", {"threshold": 0.0},
            tmp / "audio.jsonl")}
    ids = {}
    for path, (uri, params, out) in bodies.items():
        status, iid = _http(base, "POST", path, {
            "source": {"uri": uri, "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": params})
        if status != 200:
            raise AssertionError(f"rest: POST {path} gave {status} {iid}")
        ids[iid] = path
    done = _wait_states(base, list(ids), ("COMPLETED", "ERROR", "ABORTED"),
                        300)
    bad = {ids[i]: (r["state"], r.get("message")) for i, r in done.items()
           if r["state"] != "COMPLETED"}
    if bad:
        raise AssertionError(f"rest: frame-level instances: {bad}")
    lines = {path: [json.loads(x) for x in out.read_text().splitlines()]
             for path, (_, _, out) in bodies.items()}
    action, audio = lines.values()
    if len(action) != 24 or len(audio) != 30:
        raise AssertionError(f"rest: {len(action)} action lines, "
                             f"{len(audio)} audio lines")
    return {"action_tensors": _check_actions("rest: action", action, golden),
            "audio_windows": _check_windows("rest: audio", audio, golden)}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _kernel_launches(base: str) -> dict[str, int]:
    """The server's qgemm launches by variant, read from /metrics."""
    with urllib.request.urlopen(base + "/metrics", timeout=120) as resp:
        text = resp.read().decode()
    found = dict(re.findall(
        r'^evam_kernel_launches\{kernel="qgemm",variant="(\w+)"\} (\S+)$',
        text, re.M))
    if set(found) != {"aligned", "masked"}:
        raise AssertionError(f"/metrics has no qgemm launch counts: {found}")
    return {k: int(float(v)) for k, v in found.items()}


def _await_health(base: str, proc, log_path: Path, t0: float,
                  timeout: float = 240.0) -> dict:
    """Poll /healthz until it answers 200 "ok" (no engine warming)."""
    while True:
        try:
            status, body = _http(base, "GET", "/healthz")
            if status == 200 and body["status"] == "ok":
                return body
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            raise AssertionError(
                f"serve: /healthz not ok (exit {proc.poll()}): "
                f"{log_path.read_text()[-2000:]}")
        time.sleep(0.2)


def _scheduler_shape(base: str, where: str) -> dict:
    """GET /scheduler against tests/golden/route_scheduler.json (its
    action log, empty in the golden, checked entry by entry)."""
    status, sched = _http(base, "GET", "/scheduler")
    golden = json.loads((ROOT / "tests" / "golden"
                         / "route_scheduler.json").read_text())
    actions = sched["tuning"]["actions"]
    got = canonical({**sched, "tuning": {**sched["tuning"], "actions": []}})
    errors = [] if got == golden else [json.dumps(got)[:1500]]
    errors += [f"action {a}" for a in actions
               if set(a) != {"tick", "knob", "from", "to", "reason"}]
    if status != 200 or errors:
        raise AssertionError(f"{where}: /scheduler {status}: {errors[:3]}")
    return sched


def phase_serve() -> dict[str, int]:
    """``python3 -m evam_tpu_torch.cli.main serve`` as a user starts it,
    with ragged packing, the scheduler (capacity pinned) and the control
    plane on: a realtime person_vehicle_bike stream, batch fused and
    unfused vehicle_attributes streams, a realtime unfused one, then a
    start past the capacity. Returns the child's qgemm launches by
    variant."""
    golden = json.loads(GOLDEN.read_text())
    rest_port = _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, REST_PORT=str(rest_port),
                   EVAM_PRECISION="int8", EVAM_QGEMM="pallas",
                   EVAM_ALLOW_RANDOM_WEIGHTS="1",
                   EVAM_PRELOAD="/".join(DETECT_PIPELINE),
                   MODELS_DIR=str(Path(tmp) / "models"),
                   EVAM_RAGGED="packed", EVAM_SCHED="1", EVAM_TUNE="1",
                   EVAM_SCHED_CAPACITY_FPS=str(SERVE_CAPACITY_FPS))
        log_path = Path(tmp) / "serve.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        try:
            # the preloaded engine warms before the port opens its
            # traffic: /healthz answers "warming", then "ok"
            health = _await_health(base, proc, log_path, t0)
            up_s = time.perf_counter() - t0
            if (health["engines"], health["compiled_programs"]) != (
                    1, len(PACKED_LADDER)) or not health["scheduler"]["enabled"]:
                raise AssertionError(f"serve: preload left {health}")
            out = Path(tmp) / "serve.jsonl"
            status, iid = _http(base, "POST", PIPELINE, {
                **_stream_body(out, 8, 0), "priority": "realtime"})
            if status != 200:
                raise AssertionError(f"serve: POST gave {status} {iid}")
            state = _wait_states(base, [iid], ("COMPLETED", "ERROR",
                                               "ABORTED"), 300)[iid]
            lines = out.read_text().splitlines() if out.exists() else []
            if state["state"] != "COMPLETED" or len(lines) != 8:
                raise AssertionError(f"serve: {state}, {len(lines)} lines")
            # the child's forwards show on /engines, its kernel
            # launches (as its wrapper counts them) on /metrics
            _, engines = _http(base, "GET", "/engines")
            forwards = sum(_fwd(v) for v in engines.values())
            launches = _kernel_launches(base)
            if forwards == 0 or launches["aligned"] != 10 * forwards \
                    or launches["masked"]:
                raise AssertionError(
                    f"serve: qgemm launches {launches} for {forwards} "
                    "forwards, expected 10 aligned per forward")
            # then the detect+classify pipeline through the same server,
            # fused (batch class) and unfused on the packed classify
            # engine (realtime)
            # (an engine a POST builds captures its buckets under the
            # stream's first frames: those can outlive the realtime
            # class's 200 ms staleness budget, so the cold starts are
            # batch-class and the realtime stream runs warm)
            fused, attributed = _classify_stream(
                base, Path(tmp) / "cls.jsonl", 8, golden, "serve",
                priority="batch")
            packed, packed_attributed = _classify_stream(
                base, Path(tmp) / "unfused.jsonl", 8, golden, "serve",
                extra=UNFUSED, priority="batch")
            # the engines the POSTs built finish their warmup
            _await_health(base, proc, log_path, time.perf_counter())
            _classify_stream(base, Path(tmp) / "unfused_rt.jsonl", 8, golden,
                             "serve", extra=UNFUSED, priority="realtime")
            _, engines = _http(base, "GET", "/engines")
            total = _kernel_launches(base)
            cls_fwd = _fwd(engines[fused])
            pk_fwd = _fwd(engines[packed])
            det_fwd = _fwd(engines[f"detect:{KEY}"])
            if (cls_fwd == 0 or pk_fwd == 0 or det_fwd <= forwards
                    or engines[packed]["ragged"] != "packed"
                    or engines[packed]["buckets"] != PACKED_LADDER
                    or sum(total.values())
                    != 10 * det_fwd + 13 * cls_fwd + 3 * pk_fwd
                    or total["masked"] > 3 * (cls_fwd + pk_fwd)):
                raise AssertionError(
                    f"serve: qgemm launches {total} for {det_fwd} detect, "
                    f"{cls_fwd} fused and {pk_fwd} packed classify forwards, "
                    "expected 10, 13 and 3 per forward")
            # /traces (tracing on by default) in the golden's shape
            status, traces = _http(base, "GET", "/traces")
            if status != 200 or not traces["enabled"]:
                raise AssertionError(f"serve: /traces {status} {traces}")
            _traces_shape(traces, "serve")
            # /scheduler in the golden's shape; a start past the pinned
            # capacity answers 503 with Retry-After
            _scheduler_shape(base, "serve")
            req = urllib.request.Request(
                base + PIPELINE, method="POST", data=json.dumps({
                    **_stream_body(Path(tmp) / "no.jsonl", 8, 0),
                    "fps": 1000}).encode())
            try:
                urllib.request.urlopen(req, timeout=60)
                raise AssertionError("serve: an over-capacity start was "
                                     "admitted")
            except urllib.error.HTTPError as exc:
                rejected = {"status": exc.code,
                            "retry_after": exc.headers.get("Retry-After"),
                            "body": json.loads(exc.read())}
            if (rejected["status"] != 503 or not rejected["retry_after"]
                    or set(rejected["body"]) != {"error", "retry_after_s"}):
                raise AssertionError(f"serve: over capacity gave {rejected}")
            after = _scheduler_shape(base, "serve")
            if (after["rejected"]["standard"] != 1 or after["admitted"] != {
                    "realtime": 2, "standard": 0, "batch": 2}
                    or after["capacity_fps"] != SERVE_CAPACITY_FPS
                    or not after["tuning"]["enabled"]
                    or after["tuning"]["ticks"] < 1):
                raise AssertionError(f"serve: /scheduler after the 503: "
                                     f"{after}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=30)
            if code != 0:
                raise AssertionError(f"serve: exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            _print({"phase": "serve", "up_s": up_s,
                    "graphs": {k: v["graphs"] for k, v in engines.items()},
                    "streams_s": t1 - t0 - up_s, "frames": len(lines),
                    "forwards": {k: v["batches"] for k, v in engines.items()},
                    "qgemm_launches": total, "avg_fps": state["avg_fps"],
                    "attributed_objects": attributed,
                    "packed_attributed_objects": packed_attributed,
                    "over_capacity": rejected,
                    "scheduler": {k: after[k] for k in (
                        "capacity_fps", "admitted", "rejected", "shed",
                        "utilization")},
                    "tuning": {"ticks": after["tuning"]["ticks"],
                               "actions": len(after["tuning"]["actions"]),
                               "operating_point":
                                   after["tuning"]["operating_point"]},
                    "traces": {k: traces[k] for k in (
                        "retained", "dropped", "frames", "batches")},
                    "exit_code": code, "stop_s": time.perf_counter() - t1})
            return total
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()




# ------------------------------------------------------------------ eii

EII_FRAMES = 64
EII_RESULTS = "eii_results"


def _eii_message_errors(meta: dict, golden: dict) -> list[str]:
    """An EII message against tests/golden/message_eii_msgbus.json: the
    golden's keys in its shape (the message carries more: the frame's
    EVA-schema fields and the encoding), every region checked, the
    image handle 12 hex digits. A region's ``object_id`` is null where
    no tracker runs (the reference publishes null too): it is held to
    the golden's number only where it is set."""
    missing = set(golden) - set(meta)
    if missing:
        return [f"missing {sorted(missing)}"]
    sub = {k: meta[k] for k in golden}
    sub["gva_meta"] = [{**g, "object_id": 0 if g.get("object_id") is None
                        else g["object_id"]} for g in meta["gva_meta"]]
    errors = _shape_errors(canonical(sub), golden)
    handle = meta["img_handle"]
    if not (isinstance(handle, str) and len(handle) == 12
            and all(c in "0123456789abcdef" for c in handle)):
        errors.append(f"img_handle {handle!r}")
    return errors


def _sock_dir(tmp: Path) -> str:
    """A socket directory under ``tmp`` by its shorter name (relative
    to the working directory, or absolute): an AF_UNIX path holds at
    most 107 bytes."""
    d = tmp / "s"
    d.mkdir()
    name = min(os.path.relpath(d), str(d), key=len)
    if len(name) + len(EII_RESULTS) + 2 > 107:
        raise AssertionError(f"eii: no socket path under 107 bytes: {d}")
    return name


def _hold_until_joined(registry, subscriber) -> None:
    """Hold the EII manager's pipeline start until a probe published on
    its own publisher reaches ``subscriber``: a PUB drops what it sends
    before a subscription arrives (pub/sub's slow joiner), and every one
    of the frames must arrive."""
    start = registry.start_instance

    def held(name, version, request, publish_fn=None, **kw):
        publisher = publish_fn.__self__.publisher
        deadline = time.perf_counter() + 60
        while True:
            publisher.publish({"probe": True})
            if subscriber.recv() is not None:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("eii: the subscriber never joined")
        return start(name, version, request, publish_fn=publish_fn, **kw)

    registry.start_instance = held


def _eii_results(subscriber, n: int, where: str) -> list:
    """``n`` messages that are not probes, in arrival order."""
    out = []
    deadline = time.perf_counter() + 300
    while len(out) < n:
        msg = subscriber.recv()
        if msg is not None and "probe" not in msg[0]:
            out.append(msg)
        if time.perf_counter() > deadline:
            raise AssertionError(f"{where}: {len(out)} of {n} messages")
    return out


def _halt_manager(mgr) -> None:
    """Stop an EII manager whose stream has ended and keep its registry
    (and the hub's warm engine) for the next manager."""
    mgr._stop.set()
    if mgr.app_source is not None:
        mgr.app_source.end()
    mgr._teardown_ingest()
    mgr.cfg.close()
    if mgr.instance is not None:
        mgr.registry.stop_instance(mgr.instance.id)
        mgr.instance.wait(timeout=60)
    mgr.publisher.close()


def _eii_config(path: Path, app: dict, publisher: dict,
                subscribers: list | None = None) -> Path:
    path.write_text(json.dumps({"config": app, "interfaces": {
        "Publishers": [{"Name": "default", "Topics": [EII_RESULTS],
                        "AllowedClients": ["*"], **publisher}],
        "Subscribers": subscribers or []}}))
    return path


def phase_eii(torch, port) -> dict:
    """EII mode at the slice's configuration (INT8, the hand kernel,
    person_vehicle_bike 512², width 32): (a) a decoder source to the
    bus, (b) the bus through an AppSource to the bus, both in this
    process on one registry whose detect engine is warmed first, then
    (c) ``python -m evam_tpu_torch.cli.main serve --mode EII`` as a
    child. Returns the qgemm launches of (a) and (b) by variant."""
    import numpy as np

    qg = port["qgemm"]
    golden = json.loads((ROOT / "tests" / "golden"
                         / "message_eii_msgbus.json").read_text())
    params = {"threshold": 0.2}
    uri = f"synthetic://768x432@30?count={EII_FRAMES}"
    out: dict = {"phase": "eii", "frames": EII_FRAMES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        settings = port["Settings"].from_env(env={
            "EVAM_PRECISION": "int8", "EVAM_ALLOW_RANDOM_WEIGHTS": "1",
            "PIPELINES_DIR": str(ROOT / "pipelines"),
            "MODELS_DIR": str(tmp / "models")})
        if not settings.sched.enabled:
            raise AssertionError("eii: the scheduler is not on by default")
        registry = port["PipelineRegistry"](settings)
        hub = registry.hub
        try:
            if registry.preload(KEY) != 1:
                raise AssertionError("eii: preload built no pipeline")
            engine = hub.engine("detect", KEY,
                                score_threshold=port["ENGINE_SCORE_FLOOR"])
            _await_warm("eii", [engine])

            # what the EVA path publishes for the same 64 frames, on the
            # same warm engine
            eva: dict[int, tuple] = {}

            def record(ctx):
                eva[ctx.seq] = (port["eii_gva_meta"](ctx),
                                ctx.metadata["objects"],
                                ctx.metadata["timestamp"])

            specs, _ = port["resolve_parameters"](
                registry.loader.get(*DETECT_PIPELINE), params)
            runner = port["StreamRunner"](
                "eva", port["build_stages"](specs, hub, source_uri=uri,
                                            publish_fn=record), uri)
            runner.run(port["SyntheticSource"].from_uri(uri).frames())
            if sorted(eva) != list(range(EII_FRAMES)) or runner.errors:
                raise AssertionError(f"eii: the EVA path published "
                                     f"{len(eva)} frames")

            # (a) decoder source → bus
            _reset_launches(qg)
            fwd0 = _fwd(engine.stats_row())
            tcp_port = _free_port()
            cfg_a = _eii_config(tmp / "a.json", {
                "source": "gstreamer", "pipeline": "/".join(DETECT_PIPELINE),
                "source_parameters": {"type": "uri", "uri": uri},
                "publish_frame": True, "encoding": {"type": "png", "level": 3},
                "model_parameters": params},
                {"Type": "zmq_tcp", "EndPoint": f"127.0.0.1:{tcp_port}"})
            sub = port["MsgBusSubscriber"](
                {"Type": "zmq_tcp", "EndPoint": f"127.0.0.1:{tcp_port}"},
                EII_RESULTS, recv_timeout_ms=100)
            start = registry.start_instance
            _hold_until_joined(registry, sub)
            try:
                t0 = time.perf_counter()
                mgr = port["EiiManager"](
                    settings, cfg_mgr=port["ConfigMgr"](cfg_a),
                    registry=registry)
                t1 = time.perf_counter()
                try:
                    msgs = _eii_results(sub, EII_FRAMES, "eii (a)")
                    wall_a = time.perf_counter() - t1
                finally:
                    _halt_manager(mgr)
            finally:
                registry.start_instance = start
                sub.close()
            forwards = _fwd(engine.stats_row()) - fwd0
            launches_a = dict(qg.variant_launches)
            if (forwards == 0 or launches_a["aligned"] != 10 * forwards
                    or launches_a["masked"]):
                raise AssertionError(
                    f"eii (a): qgemm launches {launches_a} for {forwards} "
                    "forwards, expected 10 aligned per forward")
            frames = [ev.frame for ev in
                      port["SyntheticSource"].from_uri(uri).frames()]
            n_objects = 0
            for k, ((meta, blob), frame) in enumerate(zip(msgs, frames)):
                errors = _eii_message_errors(meta, golden)
                gva, objects, ts = eva[k]
                if meta["timestamp"] != ts:
                    errors.append(f"frame {k}: timestamp {meta['timestamp']}"
                                  f" out of order (EVA {ts})")
                if meta["gva_meta"] != gva or meta["objects"] != objects:
                    errors.append(f"frame {k}: objects differ from EVA")
                if meta.get("encoding_type") != "png" or not np.array_equal(
                        port["decode_frame"](blob, "png"), frame):
                    errors.append(f"frame {k}: PNG not pixel-equal")
                if errors:
                    raise AssertionError(f"eii (a): {errors[:4]}")
                n_objects += len(meta["gva_meta"])
            if n_objects == 0:
                raise AssertionError("eii (a): no object in 64 frames")
            out["a"] = {"messages": len(msgs), "wall_s": wall_a,
                        "msgs_per_s": len(msgs) / wall_a,
                        "boot_s": t1 - t0, "objects": n_objects,
                        "forwards": forwards, "qgemm_launches": launches_a,
                        "png_bytes_mean": sum(len(b) for _, b in msgs)
                        / len(msgs)}

            # (b) bus → AppSource → bus: raw 1080p BGR frames at 30 fps
            _reset_launches(qg)
            fwd0 = _fwd(engine.stats_row())
            drops0 = port["metrics"].get_counter("evam_eii_ingest_drops")
            sock_dir = _sock_dir(tmp)
            ipc = {"Type": "zmq_ipc", "EndPoint": sock_dir}
            cfg_b = _eii_config(tmp / "b.json", {
                "source": "msgbus", "pipeline": "/".join(DETECT_PIPELINE),
                "publish_frame": False, "model_parameters": params}, ipc,
                [{"Name": "in", "Topics": ["camera1_stream"], **ipc}])
            sub = port["MsgBusSubscriber"](ipc, EII_RESULTS,
                                           recv_timeout_ms=100)
            _hold_until_joined(registry, sub)
            feeder = None
            try:
                mgr = port["EiiManager"](
                    settings, cfg_mgr=port["ConfigMgr"](cfg_b),
                    registry=registry)
                try:
                    feeder = port["MsgBusPublisher"](ipc, "camera1_stream")
                    deadline = time.perf_counter() + 60
                    while not feeder._sock.subscribed_peers():
                        if time.perf_counter() > deadline:
                            raise AssertionError("eii (b): the ingest "
                                                 "never subscribed")
                        time.sleep(0.01)
                    t1 = time.perf_counter()
                    for ev in port["SyntheticSource"](
                            1920, 1080, count=EII_FRAMES,
                            realtime=True).frames():
                        feeder.publish({"width": 1920, "height": 1080},
                                       ev.frame.tobytes())
                    # the stream keeps frames in flight until later frames
                    # or its end release them: end it once every frame
                    # is in
                    while mgr.app_source._seq < EII_FRAMES:
                        if time.perf_counter() - t1 > 120:
                            raise AssertionError(
                                f"eii (b): {mgr.app_source._seq} of "
                                f"{EII_FRAMES} frames ingested")
                        time.sleep(0.01)
                    mgr.app_source.end()
                    results = _eii_results(sub, EII_FRAMES, "eii (b)")
                    wall_b = time.perf_counter() - t1
                finally:
                    mgr.stop()  # the whole stop path: registry and hub
            finally:
                sub.close()
                if feeder is not None:
                    feeder.close()
            forwards_b = _fwd(engine.stats_row()) - fwd0
            launches_b = dict(qg.variant_launches)
            drops = port["metrics"].get_counter(
                "evam_eii_ingest_drops") - drops0
            stamps = [m["timestamp"] for m, _ in results]
            errors = [e for m, _ in results
                      for e in _eii_message_errors(m, golden)]
            if (drops or errors or stamps != sorted(stamps)
                    or any(m["resolution"] != {"height": 1080, "width": 1920}
                           or b is not None for m, b in results)):
                raise AssertionError(f"eii (b): drops {drops}, "
                                     f"{errors[:3]}")
            if (forwards_b == 0 or launches_b["aligned"] != 10 * forwards_b
                    or launches_b["masked"]):
                raise AssertionError(
                    f"eii (b): qgemm launches {launches_b} for "
                    f"{forwards_b} forwards, expected 10 aligned per forward")
            out["b"] = {"messages": len(results), "wall_s": wall_b,
                        "msgs_per_s": len(results) / wall_b,
                        "ingest_drops": drops, "forwards": forwards_b,
                        "qgemm_launches": launches_b}
        finally:
            hub.stop()

        # (c) the CLI as a user starts it
        tcp_port = _free_port()
        cfg_c = _eii_config(tmp / "c.json", {
            "source": "gstreamer", "pipeline": "/".join(DETECT_PIPELINE),
            "source_parameters": {"type": "uri",
                                  "uri": "synthetic://768x432@30"},
            "model_parameters": params},
            {"Type": "zmq_tcp", "EndPoint": f"127.0.0.1:{tcp_port}"})
        env = dict(os.environ, EVAM_EII_CONFIG=str(cfg_c),
                   EVAM_PRECISION="int8", EVAM_QGEMM="pallas",
                   EVAM_ALLOW_RANDOM_WEIGHTS="1",
                   MODELS_DIR=str(tmp / "models_c"))
        log_path = tmp / "eii.log"
        sub = port["MsgBusSubscriber"](
            {"Type": "zmq_tcp", "EndPoint": f"127.0.0.1:{tcp_port}"},
            EII_RESULTS, recv_timeout_ms=100)
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve",
                 "--mode", "EII"], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        try:
            while (first := sub.recv()) is None:
                if proc.poll() is not None or time.perf_counter() - t0 > 240:
                    raise AssertionError(
                        f"eii (c): no message (exit {proc.poll()}): "
                        f"{log_path.read_text()[-2000:]}")
            first_s = time.perf_counter() - t0
            errors = _eii_message_errors(first[0], golden)
            if errors:
                raise AssertionError(f"eii (c): {errors[:3]}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=30)
            if code != 0:
                raise AssertionError(f"eii (c): exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            out["c"] = {"first_message_s": first_s, "exit_code": code,
                        "stop_s": time.perf_counter() - t1}
        finally:
            sub.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _print(out)
    return {v: launches_a[v] + launches_b[v] for v in ("aligned", "masked")}


# ------------------------------------------------------------------ ir

#: the manifest's IR models (``fetch-models --synthesize-omz --topology
#: manifest``): key → what its input is
IR_KEYS = {
    "object_detection/person_vehicle_bike": "image",
    "object_detection/person": "image",
    "object_detection/vehicle": "image",
    "face_detection_retail/1": "image",
    "object_classification/vehicle_attributes": "image",
    "emotion_recognition/1": "image",
    "action_recognition/encoder": "image",
    "action_recognition/decoder": "clips",
    "audio_detection/environment": "audio",
}
#: the IR SSD forward the layout and depthwise variants are timed on
IR_BUCKET = 8


def _write_yolo_ir(port, target: Path) -> Path:
    """A YOLOv3-tiny-shaped detector IR at 416²: the input scaled by
    1/255 in the graph (as Model Optimizer folds ``--scale 255`` in), a
    stride-2 conv ladder to /32 and a 1×1 head of 255 channels on /16
    and /32, each cut at a RegionYolo (80 classes, three masked anchors
    of the six)."""
    import numpy as np

    rng = np.random.default_rng(20260801)
    b = port["IRBuilder"]("yolo_tiny_like")
    weights: dict = {}
    s = 416
    shape = (1, 3, s, s)
    data = b.layer("Parameter", {"shape": f"1,3,{s},{s}",
                                 "element_type": "f32"},
                   out_shapes=(shape,), name="data")
    scale = b.const(np.full((1, 1, 1, 1), 1 / 255, np.float32), "scale")
    cur = b.layer("Multiply", inputs=[(data[0], data[1], shape),
                                      (*scale, (1, 1, 1, 1))],
                  out_shapes=(shape,), name="scaled")
    feats = []
    for i, ch in enumerate((16, 32, 64, 128, 256)):  # /2 … /32
        cur, shape = port["conv_bias_relu"](b, weights, rng, cur, shape,
                                            f"c{i}", ch, 3, 2)
        if i >= 3:
            feats.append((cur, shape))
    for j, (mask, (feat, fshape)) in enumerate(zip(("0,1,2", "3,4,5"), feats)):
        _, c, h, w = fshape
        wgt = (rng.normal(size=(255, c, 1, 1)) / np.sqrt(c)).astype(np.float32)
        wc = b.const(wgt, f"head{j}_w")
        head = b.layer(
            "Convolution", {"strides": "1,1", "pads_begin": "0,0",
                            "pads_end": "0,0", "dilations": "1,1"},
            inputs=[(feat[0], feat[1], fshape), (*wc, wgt.shape)],
            out_shapes=((1, 255, h, w),), name=f"head{j}")
        region = b.layer(
            "RegionYolo", {"classes": "80", "coords": "4", "num": "6",
                           "do_softmax": "0", "mask": mask,
                           "anchors": "10,14,23,27,37,58,81,82,135,169,"
                                      "344,319"},
            inputs=[(head[0], head[1], (1, 255, h, w))],
            out_shapes=((1, 255, h, w),), name=f"region{j}")
        b.result((region[0], region[1], (1, 255, h, w)))
    target.mkdir(parents=True, exist_ok=True)
    return b.write(target)


def _ir_input(torch, model, gen, batch: int = 2):
    """A batch the model's engine step would hand its forward: frames
    (NHWC, 0–255), embedding clips, or audio windows in [-1, 1]."""
    kind = IR_KEYS.get(model.spec.key, "image")
    if kind == "clips":
        return torch.randn((batch,) + tuple(model.ir.input_shape[1:]),
                           generator=gen)
    if kind == "audio":
        return torch.rand((batch, model.ir.input_shape[-1]),
                          generator=gen) * 2 - 1
    h, w = model.preprocess.height, model.preprocess.width
    return torch.rand((batch, h, w, 3), generator=gen) * 255


def _ir_outputs(out) -> dict:
    return out if isinstance(out, dict) else {"out": out}


def _ir_serve(torch, port, hubs: dict, params: dict, pipeline, label: str,
              out: dict) -> None:
    """One pipeline from the IR models dir on hub A (the defaults: every
    bucket captured, after it has warmed) and hub B (eager), twice each
    (the second run is the cell's reading): every frame published in
    order, no qgemm launch, every run's objects against hub B's first
    run (bit-equal, or held to the track phase's tolerance and the
    difference reported); fps, p50/p99, stage ms and hub A's profiled
    busy share."""
    qg = port["qgemm"]
    served = {}
    for name, hub in hubs.items():
        make = _pipeline_stages(port, hub, params, pipeline)
        engines = _stage_engines(make("warm", None))
        if name == "A":
            _await_warm(f"ir {label} A", engines)
        for run in ("first", "second"):
            rows0 = [e.stats_row() for e in engines]
            _reset_launches(qg)
            objects: dict = {}
            runners, published, wall, threads = _serve(
                port, make, STREAMS, FRAMES, 512, 512, objects)
            where = f"ir {label} {name} {run}"
            _check_served(where, runners, published, threads)
            if qg.launches:
                raise AssertionError(f"{where}: {qg.launches} qgemm launches "
                                     "on an IR engine")
            rows = [e.stats_row() for e in engines]
            served[name, run] = objects
            out[f"{label}_{name}_{run}"] = {
                "engines": [e.name for e in engines],
                "assembly": rows[0]["assembly"],
                "transfer": rows[0]["transfer"],
                **_latency_row(runners, wall),
                "forwards": sum(_fwd(r) - _fwd(r0)
                                for r, r0 in zip(rows, rows0)),
                "qgemm_launches": qg.launches,
                "graphs": rows[0]["graphs"],
                "capture_failures": rows[0]["capture_failures"],
                "capture_s": rows[0]["compile_s"],
                "graph_pool_bytes": rows[0]["graph_pool_bytes"],
                "bucket_batches": _bucket_delta(rows0[0], rows[0]),
                "stage_ms": _stage_delta(port["STAGES"], rows0[0], rows[0])}
    base = served["B", "first"]
    if not any(objs for per in base.values() for objs in per.values()):
        raise AssertionError(f"ir {label}: no object published")
    for key, objects in served.items():
        if key == ("B", "first"):
            continue
        diff = _objects_diff(objects, base)
        out[f"{label}_{'_'.join(key)}_vs_B_first"] = diff
        if diff["frames_differing"]:
            diff["held"] = _objects_agree(
                {(s, q): o for s, per in objects.items()
                 for q, o in per.items()},
                {(s, q): o for s, per in base.items()
                 for q, o in per.items()})
    prof = _profile_serve(torch, port, hubs["A"], STREAMS, FRAMES, 512, 512,
                          make=_pipeline_stages(port, hubs["A"], params,
                                                pipeline))
    out[f"{label}_A_profiled"] = {k: prof[k] for k in (
        "wall_s", "device_busy_ms", "device_busy_share", "kernel_launches")}
    if qg.launches:
        raise AssertionError(f"ir {label}: qgemm launched in the profiled run")


def _ir_temporal(port, hub, out: dict) -> None:
    """action_recognition/general (the encoder IR, the TensorIterator
    decoder IR) and audio_detection/environment (the AclNet IR) served
    on hub A, every bucket of their engines captured first: an action
    tensor a frame from frame 16, a detection on each replayed window,
    no qgemm launch."""
    qg = port["qgemm"]
    golden = json.loads(GOLDEN.read_text())
    frames = 24
    make = _pipeline_stages(port, hub, {}, ACTION_PIPELINE)
    engines = _stage_engines(make("warm", None))
    rows = _await_warm("ir action", engines)
    graphs = {e.name: r["graphs"] for e, r in zip(engines, rows)}
    _reset_launches(qg)
    metas: dict = {}
    runners, published, wall, threads = _serve(
        port, make, ACTION_STREAMS, frames, 512, 512, metas=metas)
    _check_served("ir action", runners, published, threads, frames)
    tensors = sum(_check_actions(
        f"ir action s{s}", [metas[f"s{s}"][i][0] for i in range(frames)],
        golden) for s in range(ACTION_STREAMS))
    out["action"] = {**_latency_row(runners, wall), "action_tensors": tensors,
                     "graphs": graphs, "qgemm_launches": qg.launches}

    make = _pipeline_stages(port, hub, {"threshold": 0.0,
                                        "sliding-window": 0.2},
                            AUDIO_PIPELINE)
    engines = _stage_engines(make("warm", None))
    rows = _await_warm("ir audio", engines)

    def source(s):
        uri = f"synthetic-audio://seconds=3&seed={s}"
        return uri, port["SyntheticAudioSource"].from_uri(uri)

    chunks = 3 * 16000 // CHUNK_SAMPLES
    metas = {}
    runners, published, wall, threads = _serve(
        port, make, 2, chunks, 0, 0, metas=metas, source=source)
    _check_served("ir audio", runners, published, threads, chunks)
    windows = sum(_check_windows(
        f"ir audio s{s}", [metas[f"s{s}"][i][0] for i in range(chunks)],
        golden) for s in range(2))
    out["audio"] = {"windows": windows, "wall_s": wall,
                    "graphs": {e.name: r["graphs"]
                               for e, r in zip(engines, rows)},
                    "qgemm_launches": qg.launches}
    if qg.launches:
        raise AssertionError(f"ir: {qg.launches} qgemm launches on the "
                             "action or audio IR engines")


def _ir_variants(torch, port, xml: Path, out: dict) -> None:
    """One IR SSD forward at bucket IR_BUCKET (512², width 32): the
    layout (EVAM_IR_LAYOUT nhwc / nchw) and depthwise (EVAM_DWCONV lax /
    shift, which the NCHW plan reaches) variants, outputs within
    FP32_RTOL × max at float32, then each timed in bfloat16 (the serving
    dtype) on the engine's channels_last view of NHWC frames."""
    gen = torch.Generator().manual_seed(21)
    frames = torch.rand((IR_BUCKET, 512, 512, 3), generator=gen) * 255
    variants = (("nhwc", "lax"), ("nchw", "lax"), ("nchw", "shift"))
    before = os.environ.get("EVAM_DWCONV")
    models = {}
    try:
        for layout, dw in variants:
            os.environ["EVAM_DWCONV"] = dw
            models[layout, dw] = port["load_ir"](xml, layout=layout).cuda()
    finally:
        if before is None:
            os.environ.pop("EVAM_DWCONV", None)
        else:
            os.environ["EVAM_DWCONV"] = before
    x32 = frames.cuda().permute(0, 3, 1, 2)
    with torch.inference_mode():
        ref = models[variants[0]](x32)
        for key in variants[1:]:
            got = models[key](x32)
            for name in ref:
                _card_vs_cpu(torch, "ir-variants", f"{'/'.join(key)} {name}",
                             ref[name].cpu(), got[name], top1=False)
    xb = frames.to("cuda", torch.bfloat16).permute(0, 3, 1, 2)
    timings = {}
    for key, model in models.items():
        model.cast_params(torch.bfloat16)
        with torch.inference_mode():
            wall, dev = _time_ms(torch, lambda m=model: m(xb))
        timings["/".join(key)] = {"wall_ms": wall, "device_ms": dev}
    out["ssd_forward_b8_bf16"] = timings


def phase_ir(torch, port) -> dict:
    """Real-model import on the card: the manifest's IRs written by the
    real entry point, card against CPU, the full-width IR SSD and the
    fused IR detect+classify served, the YOLO IR's detect step, the
    layout and depthwise variants, and no qgemm launch on an IR
    engine."""
    import numpy as np

    qg = port["qgemm"]
    out: dict = {"phase": "ir", "nvidia_smi": _nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        models = Path(tmp) / "models"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "evam_tpu_torch.cli.main", "fetch-models",
             "--synthesize-omz", "omz", "--topology", "manifest", "--output",
             str(models)], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"ir: fetch-models exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
        out["fetch_models_s"] = time.perf_counter() - t0
        yolo_xml = _write_yolo_ir(port, models / "yolo" / "1" / "FP32")

        # every IR at float32 on the CPU and on the card (TF32 off)
        kw = dict(models_dir=models, dtype="float32")
        cpu = port["ModelRegistry"](device="cpu", **kw)
        gpu = port["ModelRegistry"](device="cuda", **kw)
        gen = torch.Generator().manual_seed(11)
        checked = {}
        for key in IR_KEYS:
            mc, mg = cpu.get(key), gpu.get(key)
            if mg.weight_source != "ir-bin" or mg.ir is None:
                raise AssertionError(f"ir: {key} is not served from its IR")
            x = _ir_input(torch, mc, gen)
            with torch.inference_mode():
                oc, og = (_ir_outputs(mc.forward(x)),
                          _ir_outputs(mg.forward(x.cuda())))
            checked[key] = {
                name: _card_vs_cpu(torch, "ir-check", f"{key} {name}",
                                   oc[name], og[name],
                                   top1=False)["max_abs_diff"]
                for name in oc}
        out["card_vs_cpu_max_abs_diff"] = checked
        det = gpu.get(KEY)
        shape = (det.ir.input_shape, tuple(det.ir.params["conv0_w"].shape),
                 det.spec.num_classes, gpu.get(CLS_KEY).ir.input_shape,
                 tuple(gpu.get(CLS_KEY).ir.params["c1_w"].shape),
                 gpu.get(CLS_KEY).spec.heads)
        if shape != ((1, 3, 512, 512), (32, 3, 3, 3), 4, (1, 3, 72, 72),
                     (16, 3, 3, 3), (("color", 7), ("type", 4))):
            raise AssertionError(f"ir: not the full-width models: {shape}")

        # the YOLO IR through the detect step, card against CPU
        yc, yg = cpu.get("yolo/1"), gpu.get("yolo/1")
        frames = torch.randint(0, 256, (4, 416, 416, 3), generator=gen,
                               dtype=torch.uint8).numpy()
        wire = torch.from_numpy(np.stack(
            [port["wire_frame"](f, (416, 416), "i420") for f in frames]))
        rows = {}
        for dev, model in (("cpu", yc), ("cuda", yg)):
            step = port["build_detect_step"](model, score_threshold=0.6,
                                             wire_format="i420")
            rows[dev] = step(wire.to(dev)).cpu().numpy()
        with torch.inference_mode():
            x = _ir_input(torch, yc, gen)
            maps_c, maps_g = yc.forward(x), yg.forward(x.cuda())
        for name in maps_c:
            _card_vs_cpu(torch, "ir-check", f"yolo {name}", maps_c[name],
                         maps_g[name], top1=False)
        rate = float(np.mean([_match_rate(rows["cpu"][i], rows["cuda"][i])
                              for i in range(len(frames))]))
        valid = int((rows["cpu"][..., 6] > 0.5).sum())
        out["yolo"] = {"heads": len(yg.yolo_specs), "classes":
                       yg.spec.num_classes, "valid_cpu": valid,
                       "valid_card": int((rows["cuda"][..., 6] > 0.5).sum()),
                       "match_rate": rate}
        # random weights put many YOLO scores within float rounding of
        # each other, so NMS may keep a different near-tie on the card
        if valid == 0 or rate < 0.9:
            raise AssertionError(f"ir: YOLO detections differ: {out['yolo']}")
        del cpu, gpu

        # the layout and depthwise variants of the full-width IR SSD
        _ir_variants(torch, port, next((models / KEY / "FP32").glob("*.xml")),
                     out)

        # served: the IR SSD, then the fused IR detect+classify (INT8
        # serving configuration: the IRs serve their float weights in
        # bfloat16 and never reach the int8 kernel)
        registry = port["ModelRegistry"](models_dir=models, device="cuda")
        hubs = {"A": _default_hub(port, registry,
                                  stall_timeout_s=ENGINE_STALL_S),
                "B": port["EngineHub"](registry, device="cuda", warmup=False,
                                       assembly="legacy", transfer="inline")}
        try:
            out["precision"] = registry.precision
            _ir_serve(torch, port, hubs, {"threshold": 0.2}, DETECT_PIPELINE,
                      "detect", out)
            _ir_serve(torch, port, hubs, {"detection-threshold": 0.2},
                      CLS_PIPELINE, "fused", out)
            _ir_temporal(port, hubs["A"], out)
        finally:
            for hub in hubs.values():
                hub.stop()
    out["qgemm_launches"] = qg.launches
    _print(out)
    return out


# ---------------------------------------------------------------- trace

#: the trace ring's /traces golden (read only)
TRACES_GOLDEN = ROOT / "tests" / "golden" / "route_traces.json"
#: frames per stream of each trace run (8 streams): a window long
#: enough for an on/off difference of a few per cent to show
TRACE_FRAMES = 128
#: the ranges PROFILING_MODE wraps around the engine's work
PROF_RANGES = tuple(f"evam.{s}" for s in (
    "submit_wait", "slot_write", "seal", "h2d_issue", "h2d_wait",
    "launch", "readback", "resolve", "step"))


def _traces_shape(payload: dict, where: str) -> None:
    """A /traces payload against tests/golden/route_traces.json: the
    golden's keys and types (its ``traceEvents`` is the empty ring's
    list), and Chrome "X" events."""
    golden = json.loads(TRACES_GOLDEN.read_text())
    got = canonical({**payload, "traceEvents": []})
    bad = [e for e in payload["traceEvents"]
           if e.get("ph") != "X" or not {"name", "cat", "ts", "dur", "pid",
                                          "tid", "args"} <= set(e)]
    if got != golden or not payload["traceEvents"] or bad:
        raise AssertionError(f"{where}: /traces off the golden's shape: "
                             f"{got}, {len(payload['traceEvents'])} events, "
                             f"{bad[:2]}")


def _set_env(port, **values) -> None:
    """Set (a value) or unset (None) environment knobs and drop every
    memo that read them: settings, the trace ring, the checkpoint store,
    the fault injector."""
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    port["reset_settings"]()
    port["trace"].reset_cache()
    port["state"].reset_cache()
    port["faults"].reset_cache()


def _trace_run(torch, port, registry, mode: str, profile: bool) -> dict:
    """person_vehicle_bike on a fresh hub A with EVAM_TRACE=``mode``:
    every bucket captured, STREAMS × FRAMES frames, 10 launches a
    forward; with tracing on, the ring's payload, frames and batch
    records checked, and with ``profile`` PROFILING_MODE's ranges."""
    qg, trace = port["qgemm"], port["trace"]
    _set_env(port, EVAM_TRACE=mode)
    ring = trace.active()
    if (ring is not None) != (mode == "1"):
        raise AssertionError(f"trace: EVAM_TRACE={mode} gave ring {ring}")
    hub = _default_hub(port, registry)
    try:
        engine = _detect_stages(port, hub)("warm", None)[0].engine
        (warm,) = _await_warm(f"trace {mode}", [engine])
        fwd0 = _fwd(engine.stats_row())
        _reset_launches(qg)
        objects: dict[str, dict[int, list]] = {}
        runners, published, wall, threads = _serve(
            port, _detect_stages(port, hub), STREAMS, TRACE_FRAMES, 512,
            512, objects)
        variants = dict(qg.variant_launches)
        stats = engine.stats_row()
        forwards = _fwd(stats) - fwd0
        _check_served(f"trace {mode}", runners, published, threads,
                      TRACE_FRAMES)
        if forwards == 0 or variants["aligned"] != 10 * forwards \
                or variants["masked"]:
            raise AssertionError(f"trace {mode}: qgemm launches {variants} "
                                 f"for {forwards} forwards")
        out = {"objects": objects, "variants": variants,
               "row": {**_latency_row(runners, wall), "forwards": forwards,
                       "graphs": warm["graphs"],
                       "buckets": len(warm["buckets"]),
                       "stage_ms": stats["stage_ms"]}}
        if ring is None:
            return out
        # the completer retires a batch's record just after resolving it
        deadline = time.perf_counter() + 30
        while ring.snapshot()[2] and time.perf_counter() < deadline:
            time.sleep(0.01)
        payload = trace.traces_payload()
        _traces_shape(payload, "trace")
        frames, done, pending = ring.snapshot()
        if pending or len(done) != stats["batches"] or not frames:
            raise AssertionError(
                f"trace: {len(frames)} frames, {len(done)} batch records "
                f"({len(pending)} pending) for {stats['batches']} batches")
        for ft in frames:
            names = {s[0] for s in ft.spans}
            if not (any(n.startswith("stage.") for n in names)
                    and {"sched.queue_wait", "engine.dispatch"} <= names):
                raise AssertionError(f"trace: frame {ft.stream_id}#{ft.seq} "
                                     f"has spans {sorted(names)}")
        for rec in done:
            if (rec["engine"] != engine.name or rec["device"] != "cuda:0"
                    or set(rec["stages"]) != set(port["STAGES"])
                    or rec.get("launch") != "host_issue"
                    or rec["status"] != "ok"):
                raise AssertionError(f"trace: batch record "
                                     f"{ {k: v for k, v in rec.items() if k != 'clock'} }")
        mean = lambda s: 1e3 * statistics.fmean(r["stages"][s] for r in done)
        out["ring"] = {"retained": payload["retained"],
                       "dropped": payload["dropped"],
                       "frames": payload["frames"],
                       "batches": payload["batches"],
                       "events": len(payload["traceEvents"]),
                       "launch_ms_mean": mean("launch"),
                       "readback_ms_mean": mean("readback"),
                       "spans_per_frame": statistics.fmean(
                           len(ft.spans) for ft in frames)}
        if not profile:
            return out
        # PROFILING_MODE: a torch.profiler capture of served batches
        # shows the ranges of the engine's threads
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        trace.maybe_start_profiler(True)
        try:
            try:
                config = _ExperimentalConfig(profile_all_threads=True)
            except TypeError as exc:
                raise AssertionError(
                    f"trace: this torch ({torch.__version__}) cannot "
                    "profile every thread") from exc
            _reset_launches(qg)
            fwd1 = _fwd(engine.stats_row())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         experimental_config=config) as prof:
                prof_runners, prof_pub, _, prof_threads = _serve(
                    port, _detect_stages(port, hub), 2, 8, 512, 512)
                torch.cuda.synchronize()
            _check_served("trace profile", prof_runners, prof_pub,
                          prof_threads, 8)
            names = {e.key for e in prof.key_averages()}
            missing = sorted(set(PROF_RANGES) - names)
            if missing:
                raise AssertionError(f"trace: PROFILING_MODE ranges missing "
                                     f"from the capture: {missing}")
            prof_fwd = _fwd(engine.stats_row()) - fwd1
            prof_variants = dict(qg.variant_launches)
            if prof_variants["aligned"] != 10 * prof_fwd:
                raise AssertionError(f"trace: profiled run {prof_variants} "
                                     f"for {prof_fwd} forwards")
            out["variants"] = {v: variants[v] + prof_variants[v]
                               for v in variants}
            out["profile"] = {"ranges": len(PROF_RANGES),
                              "forwards": prof_fwd}
        finally:
            trace.stop_profiler()
        return out
    finally:
        hub.stop()


def phase_trace(torch, port) -> dict:
    """person_vehicle_bike on hub A, served twice in one process with
    EVAM_TRACE on and then off, the same seeds: objects bit-equal, fps
    and p50/p99 of both, every bucket captured with tracing on, 10
    launches a forward, the ring in the golden's shape with every
    retained frame's spans and every batch record's engine, device and
    eight stages, and PROFILING_MODE's ranges in a torch.profiler
    capture. Returns the qgemm launches by variant."""
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    runs = []
    try:
        # on, off three times: a pair's difference against the spread
        # of the same mode's runs
        for i, mode in enumerate(("1", "0") * 3):
            runs.append(_trace_run(torch, port, registry, mode, i == 0))
    finally:
        _set_env(port, EVAM_TRACE=None)
    for run in runs[1:]:
        if run["objects"] != runs[0]["objects"]:
            raise AssertionError(
                f"trace: objects differ with tracing on and off: "
                f"{_objects_diff(runs[0]['objects'], run['objects'])}")
    on, off = runs[0::2], runs[1::2]
    med = lambda rs, k: statistics.median(r["row"][k] for r in rs)
    _print({"phase": "trace", "streams": STREAMS,
            "frames_per_stream": TRACE_FRAMES,
            "runs": [{"trace": ("on", "off")[i % 2], **r["row"]}
                     for i, r in enumerate(runs)],
            "fps_on_over_off": med(on, "fps") / med(off, "fps"),
            "p50_on_minus_off_ms": med(on, "p50_ms") - med(off, "p50_ms"),
            "p99_on_minus_off_ms": med(on, "p99_ms") - med(off, "p99_ms"),
            "ring": [r["ring"] for r in on], "profile": on[0]["profile"],
            "objects": sum(len(o) for per in on[0]["objects"].values()
                           for o in per.values())})
    return {v: sum(r["variants"][v] for r in runs)
            for v in ("aligned", "masked")}


# ---------------------------------------------------------------- chaos

CHAOS_STREAMS = 4
#: the watchdog's budget in the chaos phase (EVAM_STALL_TIMEOUT_S), and
#: the injected wedge, above it
CHAOS_STALL_S = 3.0
CHAOS_WEDGE_S = 8.0
#: frames every stream publishes before the fault is armed, and frames
#: a restored stream serves
CHAOS_ARM_FRAMES = 8
CHAOS_FRAMES = 16
TRACK_PATH = "/pipelines/{}/{}".format(*TRACK_PIPELINE)


def _lines(path: Path) -> list[dict]:
    return ([json.loads(x) for x in path.read_text().splitlines()]
            if path.exists() else [])


def _await_lines(path: Path, n: int, where: str,
                 timeout: float = 120.0) -> list[dict]:
    deadline = time.perf_counter() + timeout
    while True:
        lines = _lines(path)
        if len(lines) >= n:
            return lines
        if time.perf_counter() > deadline:
            raise AssertionError(f"{where}: {path.name} has {len(lines)} of "
                                 f"{n} lines")
        time.sleep(0.02)


def _ids(lines: list[dict]) -> list[int]:
    return [o["id"] for m in lines for o in m["objects"]]


def _ids_continue(where: str, before: list[int], after: list[int],
                  blob: dict) -> dict:
    """No tracker id issued twice on a stream: every id published after
    the restore that was not a live track of the checkpoint (those keep
    their ids) is above every id published before it."""
    live = {t["track_id"] for st in blob["payload"]["stages"].values()
            if isinstance(st, dict)
            for t in (st.get("tracker") or {}).get("tracks", [])}
    new = set(after) - live
    top = max(before, default=0)
    if not before or not new or min(new) <= top:
        raise AssertionError(f"{where}: ids after the restore "
                             f"{sorted(new)[:8]} not above {top} (live "
                             f"{sorted(live)[:8]}, {len(before)} before)")
    return {"max_before": top, "live_tracks": len(live),
            "new_ids": len(new), "min_new": min(new)}


def _track_stream(out: Path, seed: int, count: int | None) -> dict:
    """A tracking stream into ``out``: unbounded ones at 30 fps
    (realtime), so they are still running when the chaos strikes."""
    body = _stream_body(out, count, seed, "detection-threshold")
    if count is None:
        body["source"]["realtime"] = True
    return body


def _chaos_rebuild(torch, port, tmp: Path) -> dict:
    """The wedge drill in this process: 4 tracking streams through a
    PipelineRegistry with EVAM_CKPT=1 (interval 4) and a 3 s watchdog;
    once each has published CHAOS_ARM_FRAMES frames the fault is armed
    (EVAM_FAULT_INJECT=wedge=1,wedge_n=1,wedge_s=8, EVAM_FAULT_SEED=7)
    and the next batch wedges. The watchdog trips, the supervisor writes
    one flight artifact whose pending row for the wedged batch stops at
    h2d_wait and captures every stream at the pre_rebuild barrier; the
    streams go down with the engine, it rebuilds and captures its
    buckets again, and each stream restarts from its pre_rebuild
    checkpoint: no tracker id issued twice. 13 launches a forward."""
    qg = port["qgemm"]
    flight_dir = tmp / "flight"
    _set_env(port, EVAM_ALLOW_RANDOM_WEIGHTS=1,
             PIPELINES_DIR=ROOT / "pipelines", MODELS_DIR=tmp / "models",
             EVAM_SCHED_CAPACITY_FPS=REST_CAPACITY_FPS,
             EVAM_STALL_TIMEOUT_S=CHAOS_STALL_S, EVAM_CKPT=1,
             EVAM_CKPT_INTERVAL=4, EVAM_TRACE_FLIGHT_DIR=flight_dir,
             EVAM_FAULT_INJECT=None, EVAM_FAULT_SEED=None)
    store, ring = port["state"].active(), port["trace"].active()
    if store is None or ring is None:
        raise AssertionError(f"chaos: checkpoint store {store}, trace ring "
                             f"{ring}: both must be on")
    registry = port["PipelineRegistry"](port["Settings"].from_env())
    try:
        stages = _pipeline_stages(port, registry.hub,
                                  {"detection-threshold": 0.2},
                                  TRACK_PIPELINE)("warm", None)
        engine = stages[0].engine
        _await_warm("chaos", [engine])
        fwd0 = _fwd(engine.stats_row())
        _reset_launches(qg)
        ids = [registry.start_instance(*TRACK_PIPELINE, _track_stream(
            tmp / f"c{s}.jsonl", s, None)).id for s in range(CHAOS_STREAMS)]
        for s in range(CHAOS_STREAMS):
            _await_lines(tmp / f"c{s}.jsonl", CHAOS_ARM_FRAMES, "chaos")
        os.environ["EVAM_FAULT_INJECT"] = (
            f"wedge=1,wedge_n=1,wedge_s={CHAOS_WEDGE_S}")
        os.environ["EVAM_FAULT_SEED"] = "7"
        port["faults"].reset_cache()
        t_arm = time.perf_counter()
        # the flight dump and the pre_rebuild capture come before the
        # handle turns "restarting"
        while engine.state != "restarting":
            if time.perf_counter() - t_arm > 60:
                raise AssertionError("chaos: the armed wedge never "
                                     f"quarantined the engine ({engine.state})")
            time.sleep(0.005)
        t_quarantine = time.perf_counter()
        blobs = {iid: store.export(iid) for iid in ids}
        for iid in ids:  # the streams go down with the engine
            registry.stop_instance(iid)
        for iid in ids:
            registry.get_instance(iid).wait(30)
        barriers = {iid[:8]: port["state"].decode(b).barrier if b else None
                    for iid, b in blobs.items()}
        if set(barriers.values()) != {"pre_rebuild"}:
            raise AssertionError(f"chaos: checkpoints at {barriers}")
        stalls = port["metrics"].get_counter("evam_engine_stalls",
                                             labels={"engine": engine.name})
        while engine.state != "running":
            if engine.state == "degraded" or \
                    time.perf_counter() - t_quarantine > 120:
                raise AssertionError(f"chaos: no rebuild ({engine.state})")
            time.sleep(0.01)
        rebuild_s = time.perf_counter() - t_quarantine
        (rebuilt,) = _await_warm("chaos rebuilt", [engine])
        if engine.restarts != 1 or stalls < 1:
            raise AssertionError(f"chaos: {engine.restarts} rebuilds, "
                                 f"{stalls} watchdog trips")
        # the flight recorder: one artifact, the wedged batch's row
        # stopped where the wedge sits (after h2d_wait, in the launch)
        flights = sorted(flight_dir.glob("flight-*.jsonl"))
        if len(flights) != 1 or engine.last_flight != str(flights[0]):
            raise AssertionError(f"chaos: flight artifacts {flights}, "
                                 f"last {engine.last_flight}")
        rows = [json.loads(x) for x in flights[0].read_text().splitlines()]
        header = rows[0]
        pending = sorted((r for r in rows if r["type"] == "batch"
                          and r["pending"]), key=lambda r: r["bid"])
        if (header["reason"] != "stall watchdog fired"
                or header["state"].get("outstanding") != 1 or not pending
                or pending[0]["last_stage"] != "h2d_wait"
                or any(r["last_stage"] == "h2d_wait" for r in pending[1:])):
            raise AssertionError(
                f"chaos: flight header {header}, pending rows "
                f"{[(r['bid'], r['last_stage']) for r in pending]}")
        before = {iid: _ids(_lines(tmp / f"c{s}.jsonl"))
                  for s, iid in enumerate(ids)}
        # every stream restarts from its pre_rebuild checkpoint
        t_restore = time.perf_counter()
        restored = [registry.start_instance(
            *TRACK_PIPELINE, _track_stream(tmp / f"r{s}.jsonl", s,
                                           CHAOS_FRAMES),
            saved_state=blobs[iid]) for s, iid in enumerate(ids)]
        restore_s = time.perf_counter() - t_restore
        summary = store.summary()
        continued = []
        for s, (iid, inst) in enumerate(zip(ids, restored)):
            origin = inst.status()["checkpoint"].get("restored_from") or {}
            inst.wait(120)
            lines = _lines(tmp / f"r{s}.jsonl")
            if (origin.get("barrier") != "pre_rebuild"
                    or inst.state.value != "COMPLETED"
                    or len(lines) != CHAOS_FRAMES):
                raise AssertionError(f"chaos: restored stream {s}: {origin}, "
                                     f"{inst.state.value}, {len(lines)} lines")
            continued.append(_ids_continue(f"chaos stream {s}", before[iid],
                                           _ids(lines), blobs[iid]))
        variants = dict(qg.variant_launches)
        forwards = _fwd(engine.stats_row()) - fwd0
        if (forwards == 0 or sum(variants.values()) != 13 * forwards
                or variants["masked"] > 3 * forwards):
            raise AssertionError(f"chaos: qgemm launches {variants} for "
                                 f"{forwards} fused forwards")
        return {"variants": variants, "row": {
            "arm_to_quarantine_s": t_quarantine - t_arm,
            "rebuild_s": rebuild_s, "restore_s": restore_s,
            "last_restore_ms": summary["last_restore_ms"],
            "restored": summary["restored"], "captured": summary["captured"],
            "rebuilt_graphs": rebuilt["graphs"],
            "pending_rows": [(r["bid"], r["last_stage"]) for r in pending],
            "forwards": forwards, "streams": continued}}
    finally:
        registry.stop_all()


def _launches_per_forward(base: str, where: str,
                          per_forward: int = 13) -> dict:
    """A consistent (launches, forwards) pair from a serving child
    (/metrics and /engines read back to back until they agree)."""
    for _ in range(100):
        _, engines = _http(base, "GET", "/engines")
        launches = _kernel_launches(base)
        forwards = sum(_fwd(v) for k, v in engines.items() if ":" in k)
        if forwards and sum(launches.values()) == per_forward * forwards:
            return {**launches, "forwards": forwards,
                    "checkpoint": engines.get("checkpoint")}
        time.sleep(0.05)
    raise AssertionError(f"{where}: qgemm launches {launches} for {forwards} "
                         f"forwards, expected {per_forward} per forward")


def _chaos_resume(tmp: Path) -> dict:
    """``serve`` with EVAM_STATE_DIR and EVAM_CKPT=1: one tracking
    stream, SIGTERM after 16 published frames, and the child started
    again: resume() restarts the stream from the drain checkpoint
    (``checkpoint.restored_from``), and every new id is above the
    highest before."""
    rest_port = _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    env = dict(os.environ, REST_PORT=str(rest_port), EVAM_PRECISION="int8",
               EVAM_QGEMM="pallas", EVAM_ALLOW_RANDOM_WEIGHTS="1",
               EVAM_PRELOAD="/".join(TRACK_PIPELINE),
               MODELS_DIR=str(tmp / "models"),
               EVAM_STATE_DIR=str(tmp / "state"), EVAM_CKPT="1",
               EVAM_CKPT_INTERVAL="4",
               EVAM_SCHED_CAPACITY_FPS=str(REST_CAPACITY_FPS))
    for k in ("EVAM_FAULT_INJECT", "EVAM_FAULT_SEED", "EVAM_STALL_TIMEOUT_S",
              "EVAM_TRACE_FLIGHT_DIR"):
        env.pop(k, None)
    out = tmp / "resume.jsonl"
    lives = []
    for life in (1, 2):
        log_path = tmp / f"serve{life}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        try:
            _await_health(base, proc, log_path, t0)
            up_s = time.perf_counter() - t0
            if life == 1:
                status, iid = _http(base, "POST", TRACK_PATH,
                                    _track_stream(out, 5, None))
                if status != 200:
                    raise AssertionError(f"chaos: POST gave {status} {iid}")
                origin = None
            else:
                _, rows = _http(base, "GET", "/pipelines/status")
                if len(rows) != 1 or rows[0]["state"] != "RUNNING":
                    raise AssertionError(f"chaos: resumed {rows}")
                origin = rows[0]["checkpoint"].get("restored_from")
            first = _await_lines(out, 1, f"chaos life {life}")
            first_s = time.perf_counter() - t0
            lines = _await_lines(out, CHAOS_FRAMES, f"chaos life {life}")
            counts = _launches_per_forward(base, f"chaos life {life}")
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
            if code != 0:
                raise AssertionError(f"chaos: serve exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            lives.append({"up_s": up_s, "first_line_s": first_s,
                          "stop_s": time.perf_counter() - t_term,
                          "restored_from": origin, **counts,
                          "lines": len(lines), "first": bool(first)})
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if life == 1:
            before = _ids(_lines(out))
            out.rename(tmp / "resume.before.jsonl")
            (entry,) = json.loads((tmp / "state" / "streams.json").read_text())
            blob = entry["state"]
            if blob.get("payload", {}).get("barrier") != "drain":
                raise AssertionError(f"chaos: streams.json holds "
                                     f"{str(blob)[:300]}")
    origin = lives[1]["restored_from"] or {}
    if origin.get("barrier") != "drain":
        raise AssertionError(f"chaos: resumed from {origin}")
    ids = _ids_continue("chaos resume", before, _ids(_lines(out)), blob)
    return {"lives": lives, "ids": ids,
            "variants": {v: lives[0][v] + lives[1][v]
                         for v in ("aligned", "masked")}}


def phase_chaos(torch, port) -> dict:
    """The tracking pipeline through a real wedge and a restart (see
    ``_chaos_rebuild`` and ``_chaos_resume``). Returns the qgemm
    launches by variant."""
    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in (
        "EVAM_ALLOW_RANDOM_WEIGHTS", "PIPELINES_DIR", "MODELS_DIR",
        "EVAM_SCHED_CAPACITY_FPS", "EVAM_STALL_TIMEOUT_S", "EVAM_CKPT",
        "EVAM_CKPT_INTERVAL", "EVAM_TRACE_FLIGHT_DIR", "EVAM_FAULT_INJECT",
        "EVAM_FAULT_SEED")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            rebuild = _chaos_rebuild(torch, port, tmp)
        finally:
            _set_env(port, **saved)
        resume = _chaos_resume(tmp)
    _print({"phase": "chaos", **rebuild["row"], "resume": resume["lives"],
            "resume_ids": resume["ids"], "wall_s": time.perf_counter() - t0})
    return {v: rebuild["variants"][v] + resume["variants"][v]
            for v in ("aligned", "masked")}


# --------------------------------------------------------------- ingest

#: the ingest phase's cameras (codec, width, height): 6 MJPEG at 1080p,
#: 2 I_PCM H.264 at 720p, INGEST_FRAMES frames each at INGEST_FPS
INGEST_CAMS = [("jpeg", 1920, 1080)] * 6 + [("h264", 1280, 720)] * 2
INGEST_FPS = 30.0
INGEST_FRAMES = 256
#: the JPEG quality of the cameras and of the re-stream (push_bgr's)
INGEST_QUALITY = 80
#: frames per camera the demux run keeps to push again through an
#: AppSource (the objects of both paths compared frame by frame); every
#: camera must publish at least this many of its INGEST_FRAMES, a floor
#: of 5.6 fps a camera over the 8.5 s the cameras send
INGEST_KEEP = 48
#: decode workers of the shared demux in (b), and of the serve child's
#: demux and pool in (c)
INGEST_DEMUX_WORKERS = 4
#: round-trip PSNR floors (dB): the codec at q80 on the textured 1080p
#: frame, and the I_PCM writer and reader (4:2:0 chroma) at 720p
JPEG_PSNR_FLOOR = 30.0
IPCM_PSNR_FLOOR = 30.0
#: annotated frames the REST child's re-stream must give back
RESTREAM_FRAMES = 32
#: frames of each file stream the REST child decodes through its pool
FILE_FRAMES = 16


def _textured(h: int, w: int, seed: int):
    """A frame with detail everywhere (gradients and noise), where a
    codec works as on a camera's picture."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    f = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    return np.clip(f + rng.integers(-8, 9, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def _median_ms(fn, n: int = 9) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _check_detect_launches(where: str, variants: dict, forwards: int) -> None:
    """10 aligned qgemm launches per detect forward, none masked."""
    if forwards == 0 or variants["aligned"] != 10 * forwards \
            or variants["masked"]:
        raise AssertionError(f"{where}: qgemm launches {variants} for "
                             f"{forwards} forwards, expected 10 aligned per "
                             "forward")


def _ingest_codec(port) -> dict:
    """(a): the codec's and the I_PCM reader's ms a frame on one thread,
    determinism and round-trip PSNR, and one annotate + encode of a
    relay frame."""
    import numpy as np

    jpeg, h264 = port["jpeg"], port["h264"]
    tex = _textured(1080, 1920, 0)
    blob = jpeg.encode(tex, INGEST_QUALITY)
    cam = next(iter(port["SyntheticSource"](1920, 1080, count=1).frames())).frame
    cam_blob = jpeg.encode(cam, INGEST_QUALITY)
    tex720 = _textured(720, 1280, 1)
    au = h264.encode_frames([tex720])
    row = {"phase": "ingest-codec", "quality": INGEST_QUALITY,
           "threads": 1,
           "encode_1080p_ms": _median_ms(lambda: jpeg.encode(tex, INGEST_QUALITY)),
           "decode_1080p_ms": _median_ms(lambda: jpeg.decode(blob)),
           "bytes_1080p": len(blob),
           "camera_encode_1080p_ms": _median_ms(
               lambda: jpeg.encode(cam, INGEST_QUALITY)),
           "camera_decode_1080p_ms": _median_ms(lambda: jpeg.decode(cam_blob)),
           "camera_bytes_1080p": len(cam_blob),
           "ipcm_decode_720p_ms": _median_ms(lambda: h264.decode_ipcm_au(au)),
           "ipcm_encode_720p_ms": _median_ms(
               lambda: h264.encode_frames([tex720]), 3),
           "ipcm_bytes_720p": len(au)}
    # deterministic: the same bytes decode to the same frame, the same
    # frame encodes to the same bytes
    back = jpeg.decode(blob)
    if (jpeg.encode(tex, INGEST_QUALITY) != blob
            or not np.array_equal(jpeg.decode(blob), back)
            or back.shape != tex.shape):
        raise AssertionError("ingest: the JPEG codec is not deterministic")
    ipcm = h264.decode_ipcm_au(au)
    if ipcm is None or ipcm.shape != tex720.shape \
            or not np.array_equal(h264.decode_ipcm_au(au), ipcm):
        raise AssertionError("ingest: decode_ipcm_au did not read its own AU")
    row["jpeg_psnr_db"] = _psnr(tex, back)
    row["ipcm_psnr_db"] = _psnr(tex720, ipcm)
    if row["jpeg_psnr_db"] < JPEG_PSNR_FLOOR or \
            row["ipcm_psnr_db"] < IPCM_PSNR_FLOOR:
        raise AssertionError(f"ingest: round trip under its floor: {row}")
    # one relay frame: annotate (a few labelled boxes) and encode
    ctx = port["FrameContext"](frame=cam, pts_ns=0, seq=0, stream_id="probe")
    for i in range(8):
        x0, y0 = 0.1 * i, 0.05 * i
        ctx.regions.append(port["Region"](x0, y0, x0 + 0.08, y0 + 0.2, 0.9, 1,
                                          "vehicle", object_id=i))
    relay = port["FrameRelay"]("probe")
    row["annotate_encode_1080p_ms"] = _median_ms(
        lambda: relay.push_bgr(port["annotate_frame"](ctx)))
    return row


def _encode_camera(port, codec: str, w: int, h: int, seed: int,
                   n: int) -> list[bytes]:
    """A camera's ``n`` frames, encoded: the synthetic moving square at
    ``w``×``h`` as q80 JPEGs or self-contained I_PCM access units."""
    frames = port["SyntheticSource"](w, h, count=n, seed=seed).frames()
    if codec == "jpeg":
        return [port["jpeg"].encode(ev.frame, INGEST_QUALITY) for ev in frames]
    return [port["h264"].encode_frames([ev.frame]) for ev in frames]


class _Cameras:
    """Emulated cameras on the port's RtspServer: mount ``cam<i>`` plays
    its pre-encoded frames at INGEST_FPS (``loop``: round and round)
    once :meth:`play` is called."""

    def __init__(self, port, cams, blobs, loop: bool = False):
        self.srv = port["RtspServer"](port=0, host="127.0.0.1")
        self.srv.start()
        self.relays = [self.srv.mount(f"cam{i}", codec=c)
                       for i, (c, _, _) in enumerate(cams)]
        self._go, self._stop = threading.Event(), threading.Event()
        self.threads = [threading.Thread(
            target=self._feed, args=(r, b, loop), daemon=True)
            for r, b in zip(self.relays, blobs)]
        for t in self.threads:
            t.start()

    def url(self, i: int) -> str:
        return f"rtsp://127.0.0.1:{self.srv.port}/cam{i}"

    def _feed(self, relay, blobs, loop: bool) -> None:
        self._go.wait()
        t = time.perf_counter()
        k = 0
        while not self._stop.is_set() and (loop or k < len(blobs)):
            relay.push_jpeg(blobs[k % len(blobs)])
            k += 1
            t += 1.0 / INGEST_FPS
            delay = t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)

    def await_clients(self, timeout: float = 60.0) -> None:
        deadline = time.perf_counter() + timeout
        while not all(r.has_clients for r in self.relays):
            if time.perf_counter() > deadline:
                raise AssertionError("ingest: a camera got no client")
            time.sleep(0.01)

    def play(self) -> float:
        self._go.set()
        return time.perf_counter()

    def stop(self) -> None:
        self._stop.set()
        self._go.set()
        for t in self.threads:
            t.join(timeout=10)
        self.srv.stop()


def _start_streams(registry, sources, publish) -> list[str]:
    """person_vehicle_bike instances on ``sources`` (a URI, or an
    injected source); their ids in order."""
    ids = []
    for src in sources:
        request = {"source": ({"uri": src, "type": "uri"}
                              if isinstance(src, str) else
                              {"type": "application"}),
                   "destination": {"metadata": {"type": "null"}},
                   "parameters": {"threshold": 0.2}}
        inst = registry.start_instance(
            *DETECT_PIPELINE, request, publish_fn=publish,
            source=None if isinstance(src, str) else src)
        ids.append(inst.id)
    return ids


def _ingest_cameras(torch, port, profile: bool) -> dict:
    """(b): INGEST_CAMS cameras through a PipelineRegistry with the
    shared demux (EVAM_RTSP_DEMUX_WORKERS=INGEST_DEMUX_WORKERS), then the
    frames it kept through AppSources: the same objects."""
    from concurrent.futures import ThreadPoolExecutor

    qg = port["qgemm"]
    t_enc = time.perf_counter()
    with ThreadPoolExecutor(len(INGEST_CAMS)) as pool:
        blobs = list(pool.map(
            lambda a: _encode_camera(port, *a[1], seed=a[0], n=INGEST_FRAMES),
            enumerate(INGEST_CAMS)))
    encode_s = time.perf_counter() - t_enc
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    settings = port["Settings"](pipelines_dir=str(ROOT / "pipelines"),
                                device="cuda",
                                rtsp_demux_workers=INGEST_DEMUX_WORKERS)
    preg = port["PipelineRegistry"](settings, hub=hub)
    cams = _Cameras(port, INGEST_CAMS, blobs)
    try:
        preg.preload("/".join(DETECT_PIPELINE))
        engine = hub.engine("detect", KEY)
        (warm,) = _await_warm("ingest", [engine])
        demux = preg.rtsp_demux
        threads = demux.stats()["threads"]
        if threads != 1 + INGEST_DEMUX_WORKERS:
            raise AssertionError(f"ingest: demux runs {threads} threads")

        lock = threading.Lock()
        seen: dict[str, list] = {}   # stream → [(objects, frame | None)]
        lat: dict[str, list[float]] = {}
        last = [0.0]

        def publish(ctx):
            now = time.perf_counter()
            with lock:
                rows = seen.setdefault(ctx.stream_id, [])
                rows.append((ctx.metadata["objects"],
                             ctx.frame if len(rows) < INGEST_KEEP else None))
                lat.setdefault(ctx.stream_id, []).append(now - ctx.ingest_t)
                last[0] = now

        _reset_launches(qg)
        fwd0 = _fwd(engine.stats_row())
        stage0 = engine.stats_row()
        # the seconds the demux's decode workers spend inside the decode
        # call, by codec (its stats()): their busy share says whether
        # they or the interpreter lock hold the frames back
        decode0 = demux.stats()["decode_s"]
        ids = _start_streams(preg, [cams.url(i) for i in range(len(INGEST_CAMS))],
                             publish)
        cams.await_clients()
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprofile

            prof = tprofile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = cams.play()
        for t in cams.threads:
            t.join(timeout=INGEST_FRAMES / INGEST_FPS + 60)
        # the cameras have sent everything: wait for the last publishes
        t_sent = time.perf_counter()
        while True:
            with lock:
                quiet = time.perf_counter() - max(last[0], t_sent)
            if quiet > 2.0:
                break
            time.sleep(0.1)
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        # the window ends here: a stream's last frame stays in flight
        # until the stream ends (the runner releases a frame when a later
        # one arrives), so what stopping the streams publishes is left out
        with lock:
            window_lat = {k: list(v) for k, v in lat.items()}
            published = {k: len(v) for k, v in seen.items()}
        wall = last[0] - t0
        dstats = demux.stats()
        window_decode_s = {k: v - decode0[k]
                           for k, v in dstats["decode_s"].items()}
        # each stream's drops by stage (the demux names a stream by its
        # instance id's first 8 characters)
        drops = {ps.stream_id: (ps.frames_dropped_decode,
                                ps.frames_dropped_downstream)
                 for ps in list(demux._streams)}
        stats = engine.stats_row()
        for iid in ids:
            preg.stop_instance(iid)
        for iid in ids:
            preg.get_instance(iid).wait(30)

        by_codec: dict[str, dict] = {}
        for i, (codec, w, h) in enumerate(INGEST_CAMS):
            d = by_codec.setdefault(codec, {
                "cameras": 0, "frames": 0, "lat": [], "size": f"{w}x{h}",
                "dropped_decode": 0, "dropped_downstream": 0})
            d["cameras"] += 1
            d["frames"] += published.get(ids[i], 0)
            d["lat"] += window_lat.get(ids[i], [])
            dec, down = drops.get(ids[i][:8], (0, 0))
            d["dropped_decode"] += dec
            d["dropped_downstream"] += down
        per_codec = {}
        for codec, d in by_codec.items():
            q = sorted(d.pop("lat"))
            if not q:
                raise AssertionError(f"ingest: no {codec} frame published")
            per_codec[codec] = {
                **d, "fps": d["frames"] / wall,
                "fps_per_camera": d["frames"] / wall / d["cameras"],
                "p50_ms": 1e3 * q[len(q) // 2],
                "p99_ms": 1e3 * q[min(len(q) - 1, int(0.99 * len(q)))]}
        short = [i for i in range(len(INGEST_CAMS))
                 if len(seen.get(ids[i], [])) < INGEST_KEEP]
        if short:
            _print({"phase": "ingest-cameras-short", "per_codec": per_codec,
                    "demux": dstats, "decode_s": window_decode_s,
                    "wall_s": wall})
            raise AssertionError(f"ingest: cameras {short} published under "
                                 f"{INGEST_KEEP} frames: "
                                 f"{[len(seen.get(ids[i], [])) for i in short]}")
        if dstats["decoded"] < sum(len(seen[i]) for i in ids):
            raise AssertionError(f"ingest: demux decoded {dstats}")

        # the same decoded frames through AppSources: the same objects
        apps = [port["AppSource"](maxsize=INGEST_KEEP + 1) for _ in ids]
        replay: dict[str, list] = {}

        def publish_app(ctx):
            with lock:
                replay.setdefault(ctx.stream_id, []).append(
                    ctx.metadata["objects"])

        app_ids = _start_streams(preg, apps, publish_app)
        for app, iid in zip(apps, ids):
            for objects, frame in seen[iid][:INGEST_KEEP]:
                app.push(frame)
            app.end()
        for iid in app_ids:
            inst = preg.get_instance(iid)
            inst.wait(120)
            if inst.state.value != "COMPLETED":
                raise AssertionError(f"ingest: AppSource stream {inst.status()}")
        pairs = [(seen[a][j][0], replay.get(b, [None] * INGEST_KEEP)[j])
                 for a, b in zip(ids, app_ids) for j in range(INGEST_KEEP)]
        if any(len(replay.get(b, [])) != INGEST_KEEP for b in app_ids):
            raise AssertionError("ingest: an AppSource stream published "
                                 f"{[len(replay.get(b, [])) for b in app_ids]}")
        equal = all(x == y for x, y in pairs)
        match = 1.0
        if not equal:
            # batch composition may move a bit: each demux object must
            # have a same-label AppSource object at IoU ≥ 0.9
            match = _objects_match_rate(pairs)
            if match < 0.99:
                raise AssertionError(f"ingest: AppSource objects match "
                                     f"{match:.4f} of the demux's")

        variants = dict(qg.variant_launches)
        forwards = _fwd(engine.stats_row()) - fwd0
        _check_detect_launches("ingest", variants, forwards)
        row = {"phase": "ingest-cameras", "encode_s": encode_s,
               "wall_s": wall, "per_codec": per_codec,
               "fps": sum(d["frames"] for d in per_codec.values()) / wall,
               "demux": dstats, "demux_threads": threads,
               "decode_s": window_decode_s,
               "decode_workers_busy": sum(window_decode_s.values())
               / (wall * INGEST_DEMUX_WORKERS),
               "forwards": forwards, "launches_per_forward":
                   variants["aligned"] / forwards,
               "stage_ms": stats["stage_ms"],
               "batches": stats["batches"] - stage0["batches"],
               "mean_occupancy": stats["mean_occupancy"],
               "graphs": warm["graphs"],
               "appsource_objects_equal": equal,
               "appsource_match_rate": match,
               "compared_frames": len(pairs)}
        if prof is not None:
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            row["device_busy_share"] = busy / wall
        _print(row)
        return variants
    finally:
        cams.stop()
        preg.stop_all()


def _objects_match_rate(pairs) -> float:
    """Of the objects on the left of each pair, the share that a
    same-label object on the right meets at IoU ≥ 0.9."""
    def box(o):
        b = o["detection"]["bounding_box"]
        return (b["x_min"], b["y_min"], b["x_max"], b["y_max"])

    def iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        union = ((a[2] - a[0]) * (a[3] - a[1])
                 + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / union if union > 0 else float(a == b)

    total = hit = 0
    for left, right in pairs:
        for o in left:
            total += 1
            hit += any(r["detection"]["label"] == o["detection"]["label"]
                       and iou(box(o), box(r)) >= 0.9 for r in right or [])
    return hit / total if total else 1.0


def _write_files(port, tmp: Path) -> dict[str, Path]:
    """An I_PCM ``.h264`` and an ``.mjpeg`` file of FILE_FRAMES synthetic
    frames each, written by the port."""
    h264_path = tmp / "cam.h264"
    port["h264"].write_annexb(str(h264_path), [
        ev.frame for ev in port["SyntheticSource"](
            1280, 720, count=FILE_FRAMES, seed=5).frames()])
    mjpeg_path = tmp / "cam.mjpeg"
    mjpeg_path.write_bytes(b"".join(
        port["jpeg"].encode(ev.frame, INGEST_QUALITY)
        for ev in port["SyntheticSource"](1920, 1080, count=FILE_FRAMES,
                                          seed=6).frames()))
    return {"h264": h264_path, "mjpeg": mjpeg_path}


def _ingest_serve(port) -> dict[str, int]:
    """(c): ``serve`` with ENABLE_RTSP, the shared demux and the decode
    pool: two camera streams, the first re-streamed annotated at
    ``cam0-out`` and read back with the port's RtspDemux; an ``.h264``
    and an ``.mjpeg`` file through the pool; SIGTERM. Returns the
    child's qgemm launches by variant."""
    import numpy as np

    golden = json.loads(GOLDEN.read_text())
    cams_spec = [INGEST_CAMS[0], INGEST_CAMS[-1]]
    blobs = [_encode_camera(port, c, w, h, seed=10 + i, n=32)
             for i, (c, w, h) in enumerate(cams_spec)]
    cams = _Cameras(port, cams_spec, blobs, loop=True)
    cams.play()
    rest_port, rtsp_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = _write_files(port, tmp)
        env = dict(os.environ, REST_PORT=str(rest_port), ENABLE_RTSP="1",
                   RTSP_PORT=str(rtsp_port),
                   EVAM_RTSP_DEMUX_WORKERS="2", EVAM_DECODE_POOL_WORKERS="2",
                   EVAM_PRECISION="int8", EVAM_QGEMM="pallas",
                   EVAM_ALLOW_RANDOM_WEIGHTS="1",
                   EVAM_PRELOAD="/".join(DETECT_PIPELINE),
                   MODELS_DIR=str(tmp / "models"),
                   EVAM_SCHED_CAPACITY_FPS=str(REST_CAPACITY_FPS))
        log_path = tmp / "serve.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        reader = None
        try:
            _await_health(base, proc, log_path, t0)
            up_s = time.perf_counter() - t0
            if f"rtsp://0.0.0.0:{rtsp_port}" not in log_path.read_text():
                raise AssertionError("ingest: serve's start-up line names "
                                     "no RTSP server")
            ids, outs = [], []
            for i in range(2):
                out = tmp / f"cam{i}.jsonl"
                body = {"source": {"uri": cams.url(i), "type": "uri"},
                        "destination": {"metadata": {"type": "file",
                                                     "path": str(out)}},
                        "parameters": {"threshold": 0.2}}
                if i == 0:
                    body["destination"]["frame"] = {"type": "rtsp",
                                                    "path": "cam0-out"}
                status, iid = _http(base, "POST", PIPELINE, body)
                if status != 200:
                    raise AssertionError(f"ingest: POST gave {status} {iid}")
                ids.append(iid)
                outs.append(out)
            # the annotated re-stream, read back over RTSP
            reader = port["RtspDemux"](decode_workers=1)
            stream = reader.add_stream(
                f"rtsp://127.0.0.1:{rtsp_port}/cam0-out")
            got, shapes = 0, set()
            t_rs = time.perf_counter()
            for ev in stream.frames():
                got += 1
                shapes.add(ev.frame.shape)
                if got >= RESTREAM_FRAMES:
                    break
            restream_fps = got / (time.perf_counter() - t_rs)
            stream.close()
            _, w0, h0 = cams_spec[0]
            if got < RESTREAM_FRAMES or shapes != {(h0, w0, 3)}:
                raise AssertionError(f"ingest: re-stream gave {got} frames "
                                     f"{shapes}")
            # the file streams through the decode pool
            file_ids = {}
            for kind, path in files.items():
                status, iid = _http(base, "POST", PIPELINE, {
                    "source": {"uri": str(path), "type": "uri"},
                    "destination": {"metadata": {
                        "type": "file", "path": str(tmp / f"{kind}.jsonl")}},
                    "parameters": {"threshold": 0.2}})
                if status != 200:
                    raise AssertionError(f"ingest: POST {kind} {status} {iid}")
                file_ids[kind] = iid
            done = _wait_states(base, list(file_ids.values()),
                                ("COMPLETED", "ERROR", "ABORTED"), 300)
            for kind, iid in file_ids.items():
                lines = (tmp / f"{kind}.jsonl").read_text().splitlines()
                if done[iid]["state"] != "COMPLETED" or \
                        len(lines) != FILE_FRAMES:
                    raise AssertionError(f"ingest: {kind} file {done[iid]}, "
                                         f"{len(lines)} lines")
            # the camera streams' lines in the golden's shape
            n_lines = []
            for out in outs:
                lines = [json.loads(x) for x in out.read_text().splitlines()]
                errors = [e for msg in lines for e in _line_errors(msg, golden)]
                if not lines or errors:
                    raise AssertionError(f"ingest: {out.name}: {len(lines)} "
                                         f"lines, {errors[:3]}")
                n_lines.append(len(lines))
            _, health = _http(base, "GET", "/healthz")
            if health["decode_pool"]["decoded"] < 2 * FILE_FRAMES or \
                    health["rtsp_demux"]["streams"] != 2:
                raise AssertionError(f"ingest: /healthz {health}")
            # stop the live streams, so no forward runs between reading
            # the forwards and reading the launches
            for iid in ids:
                _http(base, "DELETE", f"{PIPELINE}/{iid}")
            _wait_states(base, ids, ("ABORTED", "ERROR", "COMPLETED"), 60)
            _, engines = _http(base, "GET", "/engines")
            forwards = sum(_fwd(v) for v in engines.values())
            launches = _kernel_launches(base)
            _check_detect_launches("ingest serve", launches, forwards)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
            if code != 0:
                raise AssertionError(f"ingest: serve exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            _print({"phase": "ingest-serve", "up_s": up_s,
                    "camera_lines": n_lines, "restream_frames": got,
                    "restream_fps": restream_fps,
                    "file_frames": {k: FILE_FRAMES for k in files},
                    "decode_pool": health["decode_pool"],
                    "rtsp_demux": health["rtsp_demux"],
                    "forwards": forwards, "qgemm_launches": launches,
                    "exit_code": code, "stop_s": time.perf_counter() - t1})
            return launches
        finally:
            if reader is not None:
                reader.stop()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            cams.stop()


def phase_ingest(torch, port, profile: bool = False) -> dict:
    """The main path fed by RTSP cameras and files (see ``_ingest_codec``,
    ``_ingest_cameras`` and ``_ingest_serve``). Returns the qgemm
    launches by variant."""
    t0 = time.perf_counter()
    _print(_ingest_codec(port))
    cams = _ingest_cameras(torch, port, profile)
    serve = _ingest_serve(port)
    _print({"phase": "ingest", "wall_s": time.perf_counter() - t0})
    return {v: cams[v] + serve[v] for v in ("aligned", "masked")}


# --------------------------------------------------------------- webrtc

#: VP8 frames each media viewer of the webrtc phase must receive
WEBRTC_FRAMES = 24
#: JPEGs the ``play`` viewer must receive
WEBRTC_PLAY_FRAMES = 8
#: the reconstruction's PSNR floor (dB) on the textured frame at the
#: encoder's Q_INDEX (the CPU tests measure 38.9 dB at 640×360)
VP8_PSNR_FLOOR = 35.0
#: the webrtc phase's camera: 512² synthetic frames paced at 30 fps
WEBRTC_SOURCE = {"uri": "synthetic://512x512@30?count=1000000", "type": "uri",
                 "realtime": True}


def _openssl_info() -> dict:
    """Which libssl and libcrypto the media plane loaded, what
    ``find_library`` answers, ``ldd`` of Python's ``_ssl`` where it
    answers None, and whether the ``openssl`` CLI is on PATH."""
    import ctypes.util
    import shutil

    from evam_tpu_torch.publish.rtc import openssl

    openssl.ssl()
    row = {"find_library_ssl": ctypes.util.find_library("ssl"),
           "find_library_crypto": ctypes.util.find_library("crypto"),
           "loaded": dict(openssl.loaded),
           "openssl_cli": shutil.which("openssl")}
    if None in (row["find_library_ssl"], row["find_library_crypto"]):
        import _ssl

        out = subprocess.run(["ldd", _ssl.__file__], capture_output=True,
                             text=True, timeout=60).stdout
        row["ldd__ssl"] = [x.strip() for x in out.splitlines()
                           if "ssl" in x or "crypto" in x]
    return row


def _planes_psnr(a, b) -> float:
    import numpy as np

    return _psnr(np.concatenate([p.reshape(-1) for p in a]),
                 np.concatenate([p.reshape(-1) for p in b]))


def _webrtc_host() -> dict:
    """(a): the VP8 encoder's ms and bytes a frame (keyframe, and an
    inter frame of the same scene) at 640×360 and 1280×720 on one
    thread, the reconstruction's PSNR, SRTP protect µs a packet, one
    in-memory DTLS handshake's ms, and the OpenSSL the machine has."""
    from evam_tpu_torch.publish.rtc import dtls, srtp, vp8

    row = {"phase": "webrtc-host", "threads": 1, "q_index": vp8.Q_INDEX,
           "openssl": _openssl_info()}
    for w, h in ((640, 360), (1280, 720)):
        tex = _textured(h, w, 2)
        enc = vp8.Vp8Encoder(w, h)
        key = enc.encode(tex)
        psnr = _planes_psnr(enc.source_planes(tex), enc.reconstruction())
        delta = enc.encode_frame(tex, keyframe=False)
        row[f"{w}x{h}"] = {
            "key_ms": _median_ms(lambda: enc.encode(tex)),
            "delta_ms": _median_ms(lambda: enc.encode_frame(tex, False)),
            "key_bytes": len(key), "delta_bytes": len(delta),
            "psnr_db": psnr}
        enc.close()
        if psnr < VP8_PSNR_FLOOR:
            raise AssertionError(f"webrtc: VP8 PSNR {psnr:.2f} dB at {w}x{h} "
                                 f"under {VP8_PSNR_FLOOR}")
    tx = srtp.SrtpSender(os.urandom(16), os.urandom(14))
    rtp = bytes([0x80, 96]) + bytes(10) + os.urandom(1188)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        tx.protect(rtp)
    row["srtp_protect_us"] = 1e6 * (time.perf_counter() - t0) / n
    row["srtp_packet_bytes"] = len(rtp)
    with tempfile.TemporaryDirectory() as d:
        cert, key_pem, _ = dtls.generate_certificate(d)
        t0 = time.perf_counter()
        srv = dtls.DtlsEndpoint(cert, key_pem, server=True)
        cli = dtls.DtlsEndpoint(cert, key_pem, server=False)
        for _ in range(60):
            cli.handshake_step()
            srv.handshake_step()
            for x in cli.take_datagrams():
                srv.put_datagram(x)
            for x in srv.take_datagrams():
                cli.put_datagram(x)
            if srv.finished and cli.finished:
                break
        row["dtls_handshake_ms"] = 1e3 * (time.perf_counter() - t0)
        if not (srv.finished and cli.finished) or \
                srv.srtp_keys()[:2] != cli.srtp_keys()[2:]:
            raise AssertionError("webrtc: the DTLS handshake failed")
        srv.close()
        cli.close()
    return row


def _join(url: str, stream: str, cert_dir: Path):
    """A media viewer (the port's primitives in the client role) that
    watches ``stream`` through the relay: (viewer, its websocket, the
    offer's perf_counter)."""
    from evam_tpu_torch.publish.rtc import ws as wslib
    from evam_tpu_torch.publish.rtc.viewer import Viewer

    viewer = Viewer(cert_dir)
    conn = wslib.connect(url)
    t_offer = time.perf_counter()
    conn.send(json.dumps({"type": "watch", "stream": stream,
                          "sdp": viewer.offer}))
    msg = json.loads(conn.recv(60))
    if msg.get("type") != "answer":
        raise AssertionError(f"webrtc: watch {stream} answered {msg}")
    viewer.accept(msg["sdp"])
    viewer.connect()
    return viewer, conn, t_offer


def _receive(viewers, frames: int, timeout: float = 60.0) -> None:
    """Each viewer polls on a thread of its own until it holds
    ``frames`` whole frames."""
    errors = []

    def run(v):
        deadline = time.perf_counter() + timeout
        while len(v.frames()) < frames:
            if time.perf_counter() > deadline:
                errors.append(f"{len(v.frames())} frames")
                return
            v.recv_for(0.25)

    threads = [threading.Thread(target=run, args=(v,)) for v in viewers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    if errors:
        raise AssertionError(f"webrtc: viewers got {errors} of {frames}")


def _viewer_row(viewer, t_offer: float) -> dict:
    got = viewer.frames()
    span = viewer.arrivals[-1] - viewer.arrivals[0]
    return {"frames": len(got), "fps": (len(got) - 1) / span if span else None,
            "bytes_per_frame": sum(len(p) for _, p in got) / len(got),
            "offer_to_first_frame_s": viewer.arrivals[0] - t_offer,
            "rejected_srtp": viewer.rejected}


def _await(pred, timeout: float, what: str) -> None:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            raise AssertionError(f"webrtc: timed out waiting for {what}")
        time.sleep(0.02)


def _webrtc_request(out: Path, peer: str) -> dict:
    return {"source": dict(WEBRTC_SOURCE),
            "destination": {"metadata": {"type": "file", "path": str(out)},
                            "frame": {"type": "webrtc", "peer-id": peer}},
            "parameters": {"threshold": 0.2}}


def _webrtc_key(port, preg, srv, tmp: Path, golden: dict) -> dict:
    """(b), key mode: two media viewers and one ``play`` viewer on one
    stream through the relay."""
    import numpy as np

    from evam_tpu_torch.publish.rtc import vp8
    from evam_tpu_torch.publish.rtc import ws as wslib

    url = f"ws://127.0.0.1:{srv.port}"
    out = tmp / "cam0.jsonl"
    iid = preg.start_instance(*DETECT_PIPELINE, _webrtc_request(out, "cam0")).id
    _await(lambda: "cam0" in srv.services and "cam0" in preg.webrtc_signalers,
           30, "cam0's registration")
    sig = preg.webrtc_signalers["cam0"]
    relay = sig.relay
    pushed: list[bytes] = []
    push_jpeg = relay.push_jpeg

    def record(blob):
        pushed.append(blob)
        push_jpeg(blob)

    relay.push_jpeg = record
    joined = [_join(url, "cam0", tmp / f"v{i}") for i in range(2)]
    viewers = [v for v, _, _ in joined]
    player = wslib.connect(url)
    player.send(json.dumps({"type": "play", "stream": "cam0"}))
    jpegs: list[bytes] = []

    def play():
        deadline = time.perf_counter() + 60
        while len(jpegs) < WEBRTC_PLAY_FRAMES and time.perf_counter() < deadline:
            msg = player.recv(1.0)
            if isinstance(msg, bytes):
                jpegs.append(msg)

    play_thread = threading.Thread(target=play)
    play_thread.start()
    _receive(viewers, WEBRTC_FRAMES)
    play_thread.join(90)
    if len(jpegs) < WEBRTC_PLAY_FRAMES:
        raise AssertionError(f"webrtc: the play viewer got {len(jpegs)} JPEGs")
    shapes = {port["jpeg"].decode(b).shape for b in jpegs}
    if shapes != {(512, 512, 3)}:
        raise AssertionError(f"webrtc: play JPEGs decode to {shapes}")
    clients = relay._clients
    encodes = sig._vp8.encodes
    n_pushed = len(pushed)
    rows = [_viewer_row(v, t) for v, _, t in joined]
    got = [[p for _, p in v.frames()] for v in viewers]
    # bye (the media viewers leave) and stop (the player's) release the
    # relay's three clients
    player.send(json.dumps({"type": "stop", "stream": "cam0"}))
    for _, conn, _ in joined:
        conn.close()
    _await(lambda: relay._clients == 0, 30, "the relay's clients to go")
    player.close()
    for v in viewers:
        v.close()
    preg.stop_instance(iid)
    preg.get_instance(iid).wait(30)
    if clients != 3 or any(r["rejected_srtp"] for r in rows):
        raise AssertionError(f"webrtc: {clients} relay clients, {rows}")
    info = [vp8.parse_vp8_header(p) for g in got for p in g]
    if not all(i["keyframe"] and (i["width"], i["height"]) == (640, 360)
               for i in info):
        raise AssertionError("webrtc: key mode sent a frame that is not a "
                             "640×360 keyframe")
    # each payload is the port's encoder run again on a frame the relay
    # carried (its JPEG decoded by the port's codec)
    want = {p for g in got for p in g}
    enc = vp8.Vp8Encoder(640, 360)
    for blob in pushed:
        want.discard(enc.encode(port["jpeg"].decode(blob)))
        if not want:
            break
    if want:
        raise AssertionError(f"webrtc: {len(want)} payloads match no "
                             "re-encoded relay frame")
    # one shared encode per relay frame, whatever the viewers
    if not 0 < encodes <= n_pushed:
        raise AssertionError(f"webrtc: {encodes} encodes for {n_pushed} "
                             "relay frames")
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    errors = [e for m in lines for e in _line_errors(m, golden)]
    if not lines or errors:
        raise AssertionError(f"webrtc: {len(lines)} lines, {errors[:3]}")
    return {"viewers": rows, "play_jpegs": len(jpegs),
            "shared_encodes": encodes, "relay_frames": n_pushed,
            "delivered_frames": sum(len(g) for g in got),
            "distinct_payloads": len({p for g in got for p in g}),
            "lines": len(lines),
            "mean_payload_bytes": float(np.mean([len(p) for g in got for p in g]))}


def _webrtc_delta(port, preg, srv, tmp: Path) -> dict:
    """(b), delta mode: one viewer; delta frames after the keyframe, and
    a PLI answered by a forced keyframe."""
    from evam_tpu_torch.publish.rtc import rtcp, vp8
    from evam_tpu_torch.publish.rtc.viewer import SSRC

    url = f"ws://127.0.0.1:{srv.port}"
    preg.settings.webrtc_video_mode = "delta"
    iid = preg.start_instance(*DETECT_PIPELINE,
                              _webrtc_request(tmp / "cam1.jsonl", "cam1")).id
    _await(lambda: "cam1" in srv.services and "cam1" in preg.webrtc_signalers,
           30, "cam1's registration")
    sig = preg.webrtc_signalers["cam1"]
    viewer, conn, t_offer = _join(url, "cam1", tmp / "v-delta")
    _receive([viewer], WEBRTC_FRAMES)
    flags = [vp8.parse_vp8_header(p)["keyframe"] for _, p in viewer.frames()]
    if not flags[0] or all(flags):
        raise AssertionError(f"webrtc: delta mode sent {flags}")
    (sess,) = sig.sessions.values()
    n0 = len(flags)
    viewer.send_feedback(rtcp.pli(SSRC, sess.ssrc))
    t_pli = time.perf_counter()
    deadline = t_pli + 30
    while sess.keyframes_forced < 1 or not any(
            vp8.parse_vp8_header(p)["keyframe"]
            for _, p in viewer.frames()[n0:]):
        if time.perf_counter() > deadline:
            raise AssertionError("webrtc: no keyframe after the PLI")
        viewer.recv_for(0.1)
    pli_key_s = time.perf_counter() - t_pli
    row = _viewer_row(viewer, t_offer)
    got = [p for _, p in viewer.frames()]
    conn.close()
    _await(lambda: sig.relay._clients == 0, 30, "the delta viewer's bye")
    viewer.close()
    preg.stop_instance(iid)
    preg.get_instance(iid).wait(30)
    preg.settings.webrtc_video_mode = "key"
    return {"viewer": row, "keyframes": sum(flags), "frames": len(flags),
            "plis": sess.plis_received, "keyframes_forced": sess.keyframes_forced,
            "pli_to_keyframe_s": pli_key_s,
            "key_bytes": [len(p) for p, k in zip(got, flags) if k][:1],
            "mean_delta_bytes": (sum(len(p) for p, k in zip(got, flags) if not k)
                                 / max(1, len(flags) - sum(flags)))}


def _webrtc_serve(port, srv) -> dict[str, int]:
    """(c): ``serve`` as a child with ENABLE_WEBRTC and the relay; one
    viewer receives frames; SIGTERM → exit 0. Returns the child's qgemm
    launches by variant."""
    url = f"ws://127.0.0.1:{srv.port}"
    rest_port = _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        env = dict(os.environ, REST_PORT=str(rest_port), ENABLE_WEBRTC="1",
                   WEBRTC_SIGNALING_SERVER=url, EVAM_PRECISION="int8",
                   EVAM_QGEMM="pallas", EVAM_ALLOW_RANDOM_WEIGHTS="1",
                   EVAM_PRELOAD="/".join(DETECT_PIPELINE),
                   MODELS_DIR=str(tmp / "models"),
                   EVAM_SCHED_CAPACITY_FPS=str(REST_CAPACITY_FPS))
        log_path = tmp / "serve.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        viewer = conn = None
        try:
            _await_health(base, proc, log_path, t0)
            up_s = time.perf_counter() - t0
            status, iid = _http(base, "POST", PIPELINE,
                                _webrtc_request(tmp / "cam2.jsonl", "cam2"))
            if status != 200:
                raise AssertionError(f"webrtc: serve POST gave {status} {iid}")
            _await(lambda: "cam2" in srv.services, 30, "serve's registration")
            viewer, conn, t_offer = _join(url, "cam2", tmp / "v")
            _receive([viewer], WEBRTC_FRAMES)
            row = _viewer_row(viewer, t_offer)
            _http(base, "DELETE", f"{PIPELINE}/{iid}")
            _wait_states(base, [iid], ("ABORTED", "ERROR", "COMPLETED"), 60)
            _, engines = _http(base, "GET", "/engines")
            forwards = sum(_fwd(v) for v in engines.values())
            launches = _kernel_launches(base)
            _check_detect_launches("webrtc serve", launches, forwards)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
            if code != 0:
                raise AssertionError(f"webrtc: serve exit {code} on SIGTERM: "
                                     f"{log_path.read_text()[-2000:]}")
            _print({"phase": "webrtc-serve", "up_s": up_s, "viewer": row,
                    "forwards": forwards, "qgemm_launches": launches,
                    "exit_code": code, "stop_s": time.perf_counter() - t1})
            return launches
        finally:
            if conn is not None:
                conn.close()
            if viewer is not None:
                viewer.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_webrtc(torch, port) -> dict:
    """WebRTC egress of person_vehicle_bike (hub A, INT8, pallas, 512²,
    width 32): (a) ``_webrtc_host``; (b) a PipelineRegistry with
    ENABLE_WEBRTC and the port's signalling server on 127.0.0.1, in key
    mode (``_webrtc_key``) and delta mode (``_webrtc_delta``); (c)
    ``_webrtc_serve``. Returns the qgemm launches by variant."""
    from evam_tpu_torch.publish.rtc.signaling import SignalingServer

    t0 = time.perf_counter()
    _print(_webrtc_host())
    qg = port["qgemm"]
    golden = json.loads(GOLDEN.read_text())
    srv = SignalingServer("127.0.0.1", 0).start()
    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    hub = _default_hub(port, registry)
    settings = port["Settings"](
        pipelines_dir=str(ROOT / "pipelines"), device="cuda",
        enable_webrtc=True, webrtc_signaling_server=f"ws://127.0.0.1:{srv.port}")
    preg = port["PipelineRegistry"](settings, hub=hub)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            preg.preload("/".join(DETECT_PIPELINE))
            engine = hub.engine("detect", KEY)
            _await_warm("webrtc", [engine])
            _reset_launches(qg)
            fwd0 = _fwd(engine.stats_row())
            key = _webrtc_key(port, preg, srv, tmp, golden)
            delta = _webrtc_delta(port, preg, srv, tmp)
            variants = dict(qg.variant_launches)
            forwards = _fwd(engine.stats_row()) - fwd0
            _check_detect_launches("webrtc", variants, forwards)
            if preg.webrtc_signalers:
                raise AssertionError(f"webrtc: signalers left running: "
                                     f"{list(preg.webrtc_signalers)}")
            _print({"phase": "webrtc-registry", "key": key, "delta": delta,
                    "forwards": forwards, "launches_per_forward":
                        variants["aligned"] / forwards})
        serve = _webrtc_serve(port, srv)
    finally:
        preg.stop_all()
        srv.stop()
    _print({"phase": "webrtc", "wall_s": time.perf_counter() - t0})
    return {v: variants[v] + serve[v] for v in ("aligned", "masked")}


#: the train phase: steps per run, clips in its batch (16 frames each),
#: the small config's card-vs-CPU tolerances (float32, TF32 off: cuDNN
#: and cuBLAS sum in other orders than the CPU)
TRAIN_STEPS, TRAIN_CLIPS = 10, 4
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-3, 1e-6
TRAIN_SMALL = dict(num_classes=8, embed_dim=32, depth=1, heads=4,
                   encoder_width=4, frame_size=(32, 32), clip_len=4)


def _train_run(torch, port, cfg, clips, labels) -> dict:
    """TRAIN_STEPS steps of one trainer on cuda:0 at one rank."""
    import numpy as np

    tr = port["train"]
    mesh = port["build_train_mesh"]((1, 1, 1))
    trainer = tr.build_action_trainer(mesh, cfg, device="cuda")
    state = trainer.init_state(0)
    c, lbl = trainer.shard_batch(clips, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, c, lbl)
        losses.append(float(m["loss"]))  # synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} do not fall")
    step_ms = statistics.median(ms[1:])
    return {"losses": losses, "first_step_ms": ms[0], "ms_per_step": step_ms,
            "clips_per_s": len(clips) / (step_ms / 1e3),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "params": sum(p.numel() for p in state.model.parameters())}


def phase_train(torch, port, smi: str) -> dict:
    """The parallel training path at full width on the card (one rank),
    and the small config on the card against the CPU."""
    import numpy as np

    tr = port["train"]
    qg = port["qgemm"]
    _reset_launches(qg)
    full = tr.ActionTrainConfig()
    if (full.num_classes, full.embed_dim, full.depth, full.heads,
            full.encoder_width, full.frame_size, full.clip_len,
            full.remat_encoder) != (400, 512, 4, 8, 32, (224, 224), 16, True):
        raise AssertionError(f"train: not the full-width config: {full}")
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (TRAIN_CLIPS, full.clip_len, 224, 224, 3),
                         np.uint8)
    labels = rng.integers(0, full.num_classes, (TRAIN_CLIPS,))
    row = {"phase": "train", "card": smi, "clips": TRAIN_CLIPS,
           "frames_per_clip": full.clip_len, "steps": TRAIN_STEPS}
    row["ring"] = _train_run(torch, port, full, clips, labels)
    row["moe"] = _train_run(torch, port,
                            dataclasses.replace(full, moe_experts=4),
                            clips, labels)
    _print({"phase": "train-full-width", "card": smi, "ring": row["ring"],
            "moe": row["moe"]})
    torch.cuda.empty_cache()

    # the small config from one seed on the card and on the CPU
    cfg = tr.ActionTrainConfig(**TRAIN_SMALL)
    small_clips = rng.integers(0, 255, (4, 4, 32, 32, 3), np.uint8)
    small_labels = rng.integers(0, 8, (4,))
    mesh = port["build_train_mesh"]((1, 1, 1))
    got = {}
    for dev in ("cpu", "cuda"):
        trainer = tr.build_action_trainer(mesh, cfg, device=dev)
        state = trainer.init_state(0)
        m = trainer.loss_and_grads(
            state, *trainer.shard_batch(small_clips, small_labels))
        got[dev] = (float(m["loss"]),
                    {n: p.grad.detach().cpu()
                     for n, p in state.model.named_parameters()})
    loss_diff = abs(got["cpu"][0] - got["cuda"][0])
    # each tensor's gradient within TRAIN_GRAD_RTOL of its largest
    # magnitude, plus TRAIN_GRAD_ATOL for the attention's key biases,
    # whose exact gradient is zero (rounding noise on both sides)
    worst, worst_name = -1.0, None
    for n, g in got["cpu"][1].items():
        excess = float((got["cuda"][1][n] - g).abs().max()) / (
            TRAIN_GRAD_RTOL * float(g.abs().max()) + TRAIN_GRAD_ATOL)
        if excess > worst:
            worst, worst_name = excess, n
    row["small_card_vs_cpu"] = {
        "loss_cpu": got["cpu"][0], "loss_card": got["cuda"][0],
        "loss_abs_diff": loss_diff, "loss_atol": TRAIN_LOSS_ATOL,
        "grad_rtol": TRAIN_GRAD_RTOL, "grad_atol": TRAIN_GRAD_ATOL,
        "worst_grad_over_tolerance": worst, "worst_grad": worst_name,
        "tensors": len(got["cpu"][1])}
    if loss_diff > TRAIN_LOSS_ATOL or worst > 1.0:
        raise AssertionError(f"train: card and CPU disagree: "
                             f"{row['small_card_vs_cpu']}")
    row["qgemm_launches"] = qg.launches
    if qg.launches:
        raise AssertionError(f"train: {qg.launches} qgemm launches; K1 is "
                             "not on the training path")
    row["collectives"] = ("none on the card: NCCL takes one GPU a rank and "
                          "this machine has one; the dryrun phase runs them "
                          "on CPU gloo ranks")
    _print(row)
    return row


def phase_dryrun() -> dict:
    """``dryrun_multichip(8)`` on CPU gloo ranks (not a card result)."""
    from evam_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    lines = dryrun_multichip(8)
    if len(lines) != 4 or not all(ln.startswith("dryrun_multichip:")
                                  for ln in lines):
        raise AssertionError(f"dryrun: {lines}")
    row = {"phase": "dryrun", "platform": "cpu (8 gloo ranks; no card)",
           "seconds": time.perf_counter() - t0, "lines": lines}
    _print(row)
    return row


# ------------------------------------------------------------- accuracy

#: the accuracy phase's reduced detector and fit (the reference's recipe,
#: tests/test_accuracy.py and tools/accuracy_device.py): SSD 96², width
#: 16, 1200 Adam steps over 128 scenes; the full-width fit (the first
#: ZOO_SPECS entry, 512², width 32) takes ACC_FULL_STEPS
ACC_INPUT = (96, 96)
ACC_WIDTH = 16
ACC_STEPS = 1200
ACC_SCENES = 128
ACC_FULL_STEPS = 1200
#: held-out scenes: the reference test's seed, 8 for the step checks and
#: the first 6 of them for the served file
ACC_SEED = 99
ACC_HOLDOUT = 8
ACC_SERVED = 6
#: the reference test's limits: the fit's last loss; float32 recall and
#: precision (:100); the U/V swap's recall ceiling (:119); the served
#: recall (:145); INT8 recall and precision (:343); and how much INT8
#: recall may lose at full width against float32
ACC_LOSS_MAX = 0.5
ACC_F32 = (0.75, 0.7)
ACC_SWAP_MAX = 0.5
ACC_SERVED_MIN = 0.65
ACC_INT8 = (0.7, 0.6)
ACC_FULL_INT8_LOSS = 0.05
#: the published labels' ids (labels.PERSON_VEHICLE_BIKE)
ACC_LABEL_IDS = {"person": 1, "vehicle": 2, "bike": 3}
#: the classes whose colour a U/V swap changes: vehicle (blue → red) and
#: bike (red → blue). A person's green keeps its chroma nearly (U 82 → 70,
#: V 70 → 82), and 12 of the 21 held-out boxes are persons, so the
#: reference's overall limit reads how many persons a fit keeps (0.52
#: and 0.43 in two fits on the card, with none of the 9 recoloured
#: boxes kept in either; PERF.md, PR 19). The control holds the overall
#: recall to the reference's limit and the recoloured boxes' recall to
#: the same limit.
ACC_SWAP_CLASSES = (2, 3)


def _acc_holdout(port, n: int):
    """The reference test's held-out 1080p scenes and their i420 wire."""
    import numpy as np

    rng = np.random.default_rng(ACC_SEED)
    scenes = [port["accuracy"].render_scene(rng, hw=(1080, 1920))
              for _ in range(n)]
    return scenes, np.stack([port["color"].bgr_to_i420_host(s.frame)
                             for s in scenes])


def _acc_detect(torch, port, model, wire):
    """The detect step the reference test builds (16 detections, score
    0.3, i420) on ``wire``, on the model's device → packed rows."""
    step = port["build_detect_step"](model, max_detections=16,
                                     score_threshold=0.3, wire_format="i420")
    with torch.inference_mode():
        return step(torch.from_numpy(wire).to(model.device)).cpu().numpy()


def _acc_report(port, packed, scenes) -> dict:
    rep = port["accuracy"].evaluate_packed(packed, scenes)
    return {k: rep[k] for k in ("recall", "precision", "gt", "detections")}


def _acc_vs_cpu(port, packed_card, packed_cpu) -> dict:
    """The card's packed rows against the plain CPU path's on the same
    weights: the largest difference of the box and score fields (as
    tools/accuracy_device.py prints it; a non-finite one as a string)
    and the share of the CPU's detections the card matched."""
    import numpy as np

    d = float(np.abs(packed_card[..., :5] - packed_cpu[..., :5]).max())
    return {"max_abs_diff_vs_cpu": d if math.isfinite(d) else str(d),
            "matched_vs_cpu": min(_match_rate(packed_cpu[i], packed_card[i])
                                  for i in range(len(packed_cpu)))}


def _acc_fit(torch, port, registry, steps: int, where: str, key: str = KEY,
             **fit_kw):
    """fit_detector on the card (fit_classifier for CLS_KEY), with
    ``fit_kw`` (the detector's ``n_scenes`` ACC_SCENES unless given):
    the fitted state, and its row (ms a step, seconds, the loss history,
    peak memory)."""
    acc = port["accuracy"]
    model = registry.get(key)
    if key == CLS_KEY:
        fit = acc.fit_classifier
    else:
        fit = acc.fit_detector
        fit_kw.setdefault("n_scenes", ACC_SCENES)
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    state, history = fit(model, steps=steps, device="cuda", timings=t,
                         **fit_kw)
    row = {"input_hw": model.spec.input_size, "width": model.spec.width,
           "steps": steps,
           **{k.removeprefix("n_"): v for k, v in fit_kw.items()},
           "fit_s": time.perf_counter() - t0, "data_s": t["data_s"],
           "steps_s": t["steps_s"], "ms_per_step": 1e3 * t["steps_s"] / steps,
           "loss_history": history,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if not all(math.isfinite(x) for x in history):
        raise AssertionError(f"accuracy {where}: the fit diverged: {history}")
    return state, row


def _acc_load(port, models_dir, dtype: str, device: str, small: bool):
    """The fitted detector from ``models_dir`` (no random weights)."""
    over = (dict(input_overrides={KEY: ACC_INPUT},
                 width_overrides={KEY: ACC_WIDTH}) if small else {})
    model = port["ModelRegistry"](
        models_dir=models_dir, dtype=dtype, device=device,
        allow_random_weights=False, **over).get(KEY)
    if model.weight_source != "msgpack":
        raise AssertionError(f"accuracy: {dtype} on {device} loaded "
                             f"{model.weight_source} weights")
    return model


def _acc_int8(torch, port, model, wire, where: str) -> tuple[object, dict]:
    """One INT8 detect forward on the card through K1, the counts set to
    0 just before it: packed rows and its launches by variant (10 in
    all, asserted)."""
    qg = port["qgemm"]
    if port["qlinear"].QGEMM_BACKEND != "pallas" or not model.module.quant:
        raise AssertionError(f"accuracy {where}: INT8 is not on the kernel")
    _reset_launches(qg)
    packed = _acc_detect(torch, port, model, wire)
    variants = dict(qg.variant_launches)
    if qg.launches != 10 or sum(variants.values()) != 10:
        raise AssertionError(f"accuracy {where}: {qg.launches} qgemm "
                             "launches for one INT8 forward, expected 10")
    return packed, variants


def _acc_recipe(torch, port, root: Path) -> dict:
    """(a): the reference's recipe at 96², width 16 on the card."""
    reg = port["ModelRegistry"](
        dtype="float32", device="cuda", allow_random_weights=True,
        input_overrides={KEY: ACC_INPUT}, width_overrides={KEY: ACC_WIDTH})
    state, fit = _acc_fit(torch, port, reg, ACC_STEPS, "(a)")
    if fit["loss_history"][-1] >= ACC_LOSS_MAX:
        raise AssertionError(f"accuracy (a): the fit did not converge: {fit}")
    port["accuracy"].save_fitted(state, KEY, root)
    scenes, wire = _acc_holdout(port, ACC_HOLDOUT)
    row = {"fit": fit}

    m32 = _acc_load(port, root, "float32", "cuda", small=True)
    packed = _acc_detect(torch, port, m32, wire)
    row["float32"] = _acc_report(port, packed, scenes)
    cpu = _acc_detect(torch, port, _acc_load(port, root, "float32", "cpu",
                                             small=True), wire)
    row["float32"].update(_acc_vs_cpu(port, packed, cpu))
    # the negative control: U and V planes swapped (a colour-order bug)
    u = 1080 // 4  # rows of each chroma plane in the i420 layout
    swapped = wire.copy()
    swapped[:, 1080:1080 + u] = wire[:, 1080 + u:1080 + 2 * u]
    swapped[:, 1080 + u:1080 + 2 * u] = wire[:, 1080:1080 + u]
    rep = port["accuracy"].evaluate_packed(
        _acc_detect(torch, port, m32, swapped), scenes)
    gt = sum(int(lbl) in ACC_SWAP_CLASSES for sc in scenes for lbl in sc.labels)
    missed = sum(m["label"] in ACC_SWAP_CLASSES for m in rep["misses"])
    row["uv_swapped"] = {
        **{k: rep[k] for k in ("recall", "precision", "gt", "detections")},
        "recoloured_gt": gt, "recoloured_recall": (gt - missed) / max(gt, 1)}

    m8 = _acc_load(port, root, "int8", "cuda", small=True)
    packed8, row["variants"] = _acc_int8(torch, port, m8, wire, "(a)")
    row["int8"] = _acc_report(port, packed8, scenes)
    cpu8 = _acc_detect(torch, port, _acc_load(port, root, "int8", "cpu",
                                              small=True), wire)
    row["int8"].update(_acc_vs_cpu(port, packed8, cpu8))
    f32, swap, i8 = row["float32"], row["uv_swapped"], row["int8"]
    if f32["recall"] < ACC_F32[0] or f32["precision"] < ACC_F32[1]:
        raise AssertionError(f"accuracy (a): float32 below the reference "
                             f"test's limits: {row}")
    if (swap["recall"] >= ACC_SWAP_MAX or swap["recoloured_gt"] == 0
            or swap["recoloured_recall"] >= ACC_SWAP_MAX):
        raise AssertionError(f"accuracy (a): the U/V swap kept recall "
                             f"{swap['recall']} ({swap['recoloured_recall']} "
                             f"of the recoloured boxes): {row}")
    if i8["recall"] < ACC_INT8[0] or i8["precision"] < ACC_INT8[1]:
        raise AssertionError(f"accuracy (a): INT8 below the reference "
                             f"test's limits: {row}")
    return row


def _bb(obj: dict):
    """A published object's box [1, 4] (normalized corners)."""
    import numpy as np

    bb = obj["detection"]["bounding_box"]
    return np.asarray([[bb["x_min"], bb["y_min"], bb["x_max"], bb["y_max"]]],
                      np.float32)


def _acc_recovered(port, lines: list[dict], scenes) -> tuple[int, int]:
    """(hits, ground-truth boxes) of published lines, by the reference
    test's ``_recovered`` rule: a box is recovered by an object of its
    label at IoU ≥ 0.5 (greedy per ground-truth box)."""
    iou = port["accuracy"]._pairwise_iou
    hits = total = 0
    for scene, msg in zip(scenes, lines):
        dets = [(_bb(obj), ACC_LABEL_IDS.get(obj["detection"]["label"], -1))
                for obj in msg["objects"]]
        for gt_box, gt_label in zip(scene.boxes, scene.labels):
            total += 1
            for det, lid in dets:
                if lid == int(gt_label) and iou(det, gt_box[None])[0, 0] >= 0.5:
                    hits += 1
                    break
    return hits, total


def _acc_serve_file(port, registry, root: Path, tmp: Path, scenes,
                    pipeline: tuple[str, str], parameters: dict,
                    where: str) -> tuple[list[dict], dict, dict, float]:
    """``scenes`` in an ``.mjpeg`` file (the port's JPEG codec), served
    through ``PipelineRegistry.start_instance`` on an EngineHub of
    ``registry`` (max_batch 8, eager) into a file, as the reference test
    serves them, the qgemm counts set to 0 just before → (published
    lines, the hub's engine rows, qgemm launches by variant, wall s)."""
    video = tmp / "gt.mjpeg"
    video.write_bytes(b"".join(port["jpeg"].encode(s.frame)
                               for s in scenes))
    hub = port["EngineHub"](registry, device="cuda", max_batch=8,
                            deadline_ms=4.0)
    settings = port["Settings"](pipelines_dir=str(ROOT / "pipelines"),
                                state_dir=str(tmp / "state"),
                                models_dir=str(root), device="cuda")
    preg = port["PipelineRegistry"](settings, hub=hub)
    out = tmp / "meta.jsonl"
    out.unlink(missing_ok=True)
    qg = port["qgemm"]
    _reset_launches(qg)
    t0 = time.perf_counter()
    try:
        inst = preg.start_instance(*pipeline, {
            "source": {"uri": str(video), "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": parameters})
        deadline = time.perf_counter() + 120
        while (time.perf_counter() < deadline
               and inst.state.value not in ("COMPLETED", "ERROR")):
            time.sleep(0.1)
        if inst.state.value != "COMPLETED":
            raise AssertionError(f"{where}: the instance ended "
                                 f"{inst.state.value}: {inst.error}")
        rows = hub.stats()
    finally:
        preg.stop_all()
        hub.stop()
    variants = dict(qg.variant_launches)
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    return lines, rows, variants, time.perf_counter() - t0


def _acc_served(torch, port, root: Path, tmp: Path) -> dict:
    """(b): ACC_SERVED held-out scenes in an ``.mjpeg`` file, served at
    INT8 through ``PipelineRegistry.start_instance`` into a file, as the
    reference test serves them."""
    scenes, _ = _acc_holdout(port, ACC_SERVED)
    registry = port["ModelRegistry"](
        models_dir=root, dtype="int8", device="cuda",
        allow_random_weights=False, input_overrides={KEY: ACC_INPUT},
        width_overrides={KEY: ACC_WIDTH})
    if registry.get(KEY).weight_source != "msgpack":
        raise AssertionError("accuracy (b): not the fitted weights")
    lines, rows, variants, wall = _acc_serve_file(
        port, registry, root, tmp, scenes, DETECT_PIPELINE,
        {"threshold": 0.3}, "accuracy (b)")
    forwards = sum(_fwd(r) for k, r in rows.items()
                   if k.startswith("detect:"))
    hits, total = _acc_recovered(port, lines, scenes)
    row = {"frames": len(scenes), "lines": len(lines), "recovered": hits,
           "gt": total, "recall": hits / max(total, 1), "forwards": forwards,
           "qgemm_launches": sum(variants.values()), "variants": variants,
           "wall_s": wall}
    if len(lines) != len(scenes):
        raise AssertionError(f"accuracy (b): {len(lines)} lines for "
                             f"{len(scenes)} frames")
    if row["recall"] < ACC_SERVED_MIN:
        raise AssertionError(f"accuracy (b): served recall below "
                             f"{ACC_SERVED_MIN}: {row}")
    if row["qgemm_launches"] != 10 * forwards or forwards == 0:
        raise AssertionError(f"accuracy (b): {row['qgemm_launches']} qgemm "
                             f"launches for {forwards} forwards")
    return row


def _acc_full_width(torch, port, root: Path) -> dict:
    """(c): the same fit at the served configuration (512², width 32),
    served at float32 and at INT8 through K1 on the held-out scenes."""
    reg = port["ModelRegistry"](dtype="float32", device="cuda",
                                allow_random_weights=True)
    state, fit = _acc_fit(torch, port, reg, ACC_FULL_STEPS, "(c)")
    if fit["input_hw"] != (512, 512) or fit["width"] != 32:
        raise AssertionError(f"accuracy (c): fitted {fit['input_hw']} width "
                             f"{fit['width']}, not the full-width model")
    port["accuracy"].save_fitted(state, KEY, root)
    scenes, wire = _acc_holdout(port, ACC_HOLDOUT)
    row = {"fit": fit}
    m32 = _acc_load(port, root, "float32", "cuda", small=False)
    row["float32"] = _acc_report(port, _acc_detect(torch, port, m32, wire),
                                 scenes)
    m8 = _acc_load(port, root, "int8", "cuda", small=False)
    packed8, row["variants"] = _acc_int8(torch, port, m8, wire, "(c)")
    row["int8"] = _acc_report(port, packed8, scenes)
    row["int8_recall_loss"] = row["float32"]["recall"] - row["int8"]["recall"]
    if row["int8_recall_loss"] > ACC_FULL_INT8_LOSS:
        raise AssertionError(f"accuracy (c): INT8 lost more than "
                             f"{ACC_FULL_INT8_LOSS} recall: {row}")
    return row


def phase_accuracy(torch, port, smi: str) -> dict:
    """Ground truth on the card: the reference's detector fit, the
    served file, and the full-width fit (``_acc_recipe``, ``_acc_served``,
    ``_acc_full_width``; each sets the qgemm counts to 0 before its INT8
    run and reads them after). Returns the qgemm launches by variant."""
    t0 = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        small, full = tmp / "models_96", tmp / "models_512"
        rows["recipe"] = _acc_recipe(torch, port, small)
        _print({"phase": "accuracy-recipe", "card": smi, **rows["recipe"]})
        rows["served"] = _acc_served(torch, port, small, tmp)
        _print({"phase": "accuracy-served", "card": smi, **rows["served"]})
        rows["full-width"] = _acc_full_width(torch, port, full)
        _print({"phase": "accuracy-full-width", "card": smi,
                **rows["full-width"]})
    variants = {v: sum(r["variants"][v] for r in rows.values())
                for v in ("aligned", "masked")}
    _print({"phase": "accuracy", "card": smi,
            "seconds": time.perf_counter() - t0,
            "qgemm_launches": sum(variants.values()), "variants": variants})
    return variants


# ---------------------------------------------------------------- attrs

#: the attrs phase: the reference's TestFusedClassifyAccuracy recipe
#: (tests/test_accuracy.py:220-238): the SSD as in the accuracy phase
#: (ACC_INPUT, ACC_WIDTH, ACC_STEPS over ACC_SCENES) but on ``color_attr``
#: scenes, and the classifier at 48², width 16, 900 steps over 768 crops;
#: the full-width fits (the ZOO_SPECS sizes: SSD 512², classifier 72²,
#: width 32) take ATTR_FULL_STEPS
ATTR_CLS_INPUT = (48, 48)
ATTR_CLS_WIDTH = 16
ATTR_CLS_STEPS = 900
ATTR_CROPS = 768
ATTR_FULL_STEPS = (ACC_STEPS, ATTR_CLS_STEPS)
#: the reference test's limits: the fits' last losses (:228, :239), the
#: fused attribute recall over at least ATTR_MIN_GT vehicles (:277-278)
ATTR_LOSS_MAX = (0.6, 0.2)
ATTR_RECALL_MIN = 0.6
ATTR_MIN_GT = 4
#: held-out scenes (:249-276): 16 from seed 123, 10 more when they hold
#: fewer than ATTR_MIN_GT vehicles
ATTR_SEED = 123
ATTR_HOLDOUT = 16
ATTR_MORE = 10
#: the negative control (:280-332): 8 scenes from seed 321, every
#: ground-truth vehicle box unshifted and shifted right by 0.6 of its
#: width; colours kept unshifted ≥ 0.7, shifted ≤ 0.5, over ≥ 3 vehicles
ATTR_SHIFT_SEED = 321
ATTR_SHIFT_SCENES = 8
ATTR_SHIFT = 0.6
ATTR_SHIFT_LIMITS = (0.7, 0.5)
ATTR_SHIFT_MIN_GT = 3
#: the served file's attribute recall: 0.1 under the wire path's, as the
#: reference's served detect limit sits under its wire limit (:145, :100)
ATTR_SERVED_MIN = 0.5
#: the label id the fused step classifies (labels.PERSON_VEHICLE_BIKE)
VEHICLE = 2
#: both fitted models' sizes at (a)'s configuration
ATTR_SMALL = dict(input_overrides={KEY: ACC_INPUT, CLS_KEY: ATTR_CLS_INPUT},
                  width_overrides={KEY: ACC_WIDTH, CLS_KEY: ATTR_CLS_WIDTH})


def _attr_holdout(port) -> list[tuple[list, object]]:
    """(a)'s held-out ``color_attr`` scenes and their i420 wire, in
    groups as the reference test runs them: ATTR_HOLDOUT scenes, and
    ATTR_MORE more from the same generator when the first hold fewer
    than ATTR_MIN_GT vehicles."""
    import numpy as np

    acc, color = port["accuracy"], port["color"]
    rng = np.random.default_rng(ATTR_SEED)

    def group(n):
        scenes = [acc.render_scene(rng, hw=(1080, 1920), color_attr=True)
                  for _ in range(n)]
        return scenes, np.stack([color.bgr_to_i420_host(s.frame)
                                 for s in scenes])

    groups = [group(ATTR_HOLDOUT)]
    if _vehicles(groups[0][0]) < ATTR_MIN_GT:
        groups.append(group(ATTR_MORE))
    return groups


def _vehicles(scenes) -> int:
    return sum(int(lbl) == VEHICLE for s in scenes for lbl in s.labels)


def _attr_load(port, root: Path, dtype: str, device: str, small: bool):
    """The fitted (detector, classifier) from ``root`` in a fresh
    registry (no random weights)."""
    reg = port["ModelRegistry"](models_dir=root, dtype=dtype, device=device,
                                allow_random_weights=False,
                                **(ATTR_SMALL if small else {}))
    det, cls = reg.get(KEY), reg.get(CLS_KEY)
    if {det.weight_source, cls.weight_source} != {"msgpack"}:
        raise AssertionError(f"attrs: {dtype} on {device} loaded "
                             f"{det.weight_source} / {cls.weight_source}")
    return det, cls


def _attr_fused(torch, port, det, cls, groups) -> list:
    """The reference test's fused step (16 detections, ROI budget 8,
    score 0.3, i420, vehicles only) on each group's wire → packed rows
    [B, 16, 7 + 11] per group."""
    step = port["build_detect_classify_step"](
        det, cls, max_detections=16, roi_budget=ROI_BUDGET,
        score_threshold=0.3, wire_format="i420", allowed_label_ids=(VEHICLE,))
    with torch.inference_mode():
        return [step(torch.from_numpy(wire).to(det.device)).cpu().numpy()
                for _, wire in groups]


def _attr_report(port, groups, packed) -> dict:
    """``evaluate_attrs`` over every group, summed as the reference
    test sums its two reports."""
    hits = gt = 0
    for (scenes, _), rows in zip(groups, packed):
        rep = port["accuracy"].evaluate_attrs(rows, scenes)
        hits += round(rep["attr_recall"] * rep["gt"])
        gt += rep["gt"]
    return {"attr_recall": hits / max(gt, 1), "hits": hits, "gt": gt}


def _attr_vs_cpu(packed_card: list, packed_cpu: list) -> dict:
    """The card's fused rows against the plain CPU path's: the detection
    fields as ``_acc_vs_cpu``, and the probability blocks' largest
    difference over the rows both sides agree on (valid flag and label
    equal, box within 1e-3)."""
    import numpy as np

    card, cpu = np.concatenate(packed_card), np.concatenate(packed_cpu)
    row = _acc_vs_cpu(None, card, cpu)
    same = ((card[..., 6] == cpu[..., 6]) & (card[..., 5] == cpu[..., 5])
            & (np.abs(card[..., :4] - cpu[..., :4]).max(-1) <= 1e-3))
    row["matched_vs_cpu_mean"] = float(np.mean(
        [_match_rate(cpu[i], card[i]) for i in range(len(cpu))]))
    row["rows_same"] = float(same.mean())
    row["prob_max_abs_diff_vs_cpu"] = (
        float(np.abs(card[..., 7:] - cpu[..., 7:])[same].max())
        if same.any() else None)
    return row


def _attr_launched(qg, forwards: int, per: int, where: str) -> dict:
    """The qgemm launches by variant since the counts were set to 0,
    asserted ``per`` a forward."""
    variants = dict(qg.variant_launches)
    if qg.launches != per * forwards or sum(variants.values()) != qg.launches:
        raise AssertionError(f"attrs {where}: {qg.launches} qgemm launches "
                             f"for {forwards} forwards, expected {per} each")
    return variants


def _attr_int8_fused(torch, port, det, cls, groups, where: str):
    """The fused step at INT8 through K1, the counts set to 0 just before
    it: packed rows and its launches by variant (13 a forward)."""
    qg = port["qgemm"]
    if (port["qlinear"].QGEMM_BACKEND != "pallas" or not det.module.quant
            or not cls.module.quant):
        raise AssertionError(f"attrs {where}: INT8 is not on the kernel")
    _reset_launches(qg)
    packed = _attr_fused(torch, port, det, cls, groups)
    return packed, _attr_launched(qg, len(groups), 13, where)


def _attr_boxes(scenes, shift: float):
    """Every scene's ground-truth vehicle boxes, shifted right by
    ``shift`` of their width (clamped at 1, as the reference's control),
    padded to the ROI budget → (boxes [B, ROI_BUDGET, 4], [(scene, row,
    colour), ...])."""
    import numpy as np

    boxes = np.zeros((len(scenes), ROI_BUDGET, 4), np.float32)
    where = []
    for i, s in enumerate(scenes):
        r = 0
        for box, label, attr in zip(s.boxes, s.labels, s.attrs):
            if int(label) != VEHICLE:
                continue
            dx = shift * (box[2] - box[0])
            boxes[i, r] = (min(box[0] + dx, 1.0), box[1],
                           min(box[2] + dx, 1.0), box[3])
            where.append((i, r, int(attr)))
            r += 1
    return boxes, where


def _attr_gt_crops(torch, port, cls, wire, scenes, shifts) -> list[int]:
    """Colours the classifier recovers from the ground-truth vehicle
    boxes through ``build_classify_step`` (i420), one forward per shift
    → hits per shift."""
    step = port["build_classify_step"](cls, roi_budget=ROI_BUDGET,
                                       wire_format="i420")
    n_colors = dict(cls.spec.heads)["color"]
    frames = torch.from_numpy(wire).to(cls.device)
    hits = []
    for shift in shifts:
        boxes, where = _attr_boxes(scenes, shift)
        with torch.inference_mode():
            probs = step(frames, torch.from_numpy(boxes).to(cls.device))
        probs = probs.cpu().numpy()
        hits.append(sum(int(probs[i, r, :n_colors].argmax()) == a
                        for i, r, a in where))
    return hits


def _attr_control_scenes(port):
    """(b)'s scenes and their i420 wire."""
    import numpy as np

    rng = np.random.default_rng(ATTR_SHIFT_SEED)
    scenes = [port["accuracy"].render_scene(rng, hw=(1080, 1920),
                                            color_attr=True)
              for _ in range(ATTR_SHIFT_SCENES)]
    return scenes, np.stack([port["color"].bgr_to_i420_host(s.frame)
                             for s in scenes])


def _attr_fit_pair(torch, port, root: Path, small: bool, steps, where: str):
    """Both fits on the card (``color_attr`` scenes for the SSD), written
    by ``save_fitted`` into ``root`` → their rows."""
    reg = port["ModelRegistry"](dtype="float32", device="cuda",
                                allow_random_weights=True,
                                **(ATTR_SMALL if small else {}))
    det_state, det = _acc_fit(torch, port, reg, steps[0], where,
                              color_attr=True)
    cls_state, cls = _acc_fit(torch, port, reg, steps[1], where, CLS_KEY,
                              n_crops=ATTR_CROPS)
    port["accuracy"].save_fitted(det_state, KEY, root)
    port["accuracy"].save_fitted(cls_state, CLS_KEY, root)
    return det, cls


def _attr_recipe(torch, port, root: Path, groups) -> dict:
    """(a): the reference's recipe at 96² / 48², width 16 on the card."""
    det_fit, cls_fit = _attr_fit_pair(torch, port, root, True,
                                      (ACC_STEPS, ATTR_CLS_STEPS), "(a)")
    row = {"detector_fit": det_fit, "classifier_fit": cls_fit,
           "frames": sum(len(sc) for sc, _ in groups)}
    for fit, limit in zip((det_fit, cls_fit), ATTR_LOSS_MAX):
        if fit["loss_history"][-1] >= limit:
            raise AssertionError(f"attrs (a): a fit did not converge below "
                                 f"{limit}: {row}")
    det, cls = _attr_load(port, root, "float32", "cuda", small=True)
    packed = _attr_fused(torch, port, det, cls, groups)
    row["float32"] = _attr_report(port, groups, packed)
    cpu = _attr_fused(torch, port, *_attr_load(port, root, "float32", "cpu",
                                               small=True), groups)
    row["float32"].update(_attr_vs_cpu(packed, cpu))
    det8, cls8 = _attr_load(port, root, "int8", "cuda", small=True)
    packed8, row["variants"] = _attr_int8_fused(torch, port, det8, cls8,
                                                groups, "(a)")
    row["int8"] = _attr_report(port, groups, packed8)
    cpu8 = _attr_fused(torch, port, *_attr_load(port, root, "int8", "cpu",
                                                small=True), groups)
    row["int8"].update(_attr_vs_cpu(packed8, cpu8))
    for prec in ("float32", "int8"):
        rep = row[prec]
        if rep["gt"] < ATTR_MIN_GT or rep["attr_recall"] < ATTR_RECALL_MIN:
            raise AssertionError(f"attrs (a): {prec} attribute recall below "
                                 f"the reference test's limit: {row}")
    return row


def _attr_control(torch, port, root: Path) -> dict:
    """(b): the negative control at INT8 through K1 (3 a forward)."""
    scenes, wire = _attr_control_scenes(port)
    _, cls8 = _attr_load(port, root, "int8", "cuda", small=True)
    qg = port["qgemm"]
    _reset_launches(qg)
    ok, shifted = _attr_gt_crops(torch, port, cls8, wire, scenes,
                                 (0.0, ATTR_SHIFT))
    variants = _attr_launched(qg, 2, 3, "(b)")
    total = _vehicles(scenes)
    row = {"vehicles": total, "unshifted": ok / max(total, 1),
           "shifted": shifted / max(total, 1), "variants": variants}
    if (total < ATTR_SHIFT_MIN_GT or row["unshifted"] < ATTR_SHIFT_LIMITS[0]
            or row["shifted"] > ATTR_SHIFT_LIMITS[1]):
        raise AssertionError(f"attrs (b): the shift control failed: {row}")
    return row


def _attr_served(torch, port, root: Path, tmp: Path, groups) -> dict:
    """(c): (a)'s held-out scenes served at INT8 as vehicle_attributes."""
    scenes = [s for sc, _ in groups for s in sc]
    registry = port["ModelRegistry"](models_dir=root, dtype="int8",
                                     device="cuda", allow_random_weights=False,
                                     **ATTR_SMALL)
    lines, rows, variants, wall = _acc_serve_file(
        port, registry, root, tmp, scenes, CLS_PIPELINE,
        {"detection-threshold": 0.3}, "attrs (c)")
    kinds = {k.split(":")[0] for k, r in rows.items() if _fwd(r)}
    forwards = sum(_fwd(r) for r in rows.values())
    hits = 0
    iou = port["accuracy"]._pairwise_iou
    for scene, msg in zip(scenes, lines):
        objs = [o for o in msg["objects"]
                if o["detection"]["label_id"] == VEHICLE and "color" in o]
        for box, label, attr in zip(scene.boxes, scene.labels, scene.attrs):
            if int(label) != VEHICLE:
                continue
            hits += any(
                o["color"]["label_id"] == int(attr)
                and iou(_bb(o), box[None])[0, 0] >= 0.5 for o in objs)
    total = _vehicles(scenes)
    row = {"frames": len(scenes), "lines": len(lines), "recovered": hits,
           "gt": total, "recall": hits / max(total, 1), "forwards": forwards,
           "engines": sorted(kinds), "qgemm_launches": sum(variants.values()),
           "variants": variants, "wall_s": wall}
    if len(lines) != len(scenes):
        raise AssertionError(f"attrs (c): {len(lines)} lines for "
                             f"{len(scenes)} frames")
    if kinds != {"detect_classify"} or row["qgemm_launches"] != 13 * forwards:
        raise AssertionError(f"attrs (c): engines {kinds}, "
                             f"{row['qgemm_launches']} qgemm launches for "
                             f"{forwards} forwards (13 each)")
    if row["recall"] < ATTR_SERVED_MIN:
        raise AssertionError(f"attrs (c): served attribute recall below "
                             f"{ATTR_SERVED_MIN}: {row}")
    return row


def _attr_full_width(torch, port, root: Path, groups) -> dict:
    """(d): both fits at the served configuration; the ground-truth box
    crops of (b) and the fused step of (a) at float32 and at INT8."""
    det_fit, cls_fit = _attr_fit_pair(torch, port, root, False,
                                      ATTR_FULL_STEPS, "(d)")
    sizes = (det_fit["input_hw"], det_fit["width"], cls_fit["input_hw"],
             cls_fit["width"])
    if sizes != ((512, 512), 32, (72, 72), 32):
        raise AssertionError(f"attrs (d): fitted {sizes}, not the served "
                             "configuration")
    row = {"detector_fit": det_fit, "classifier_fit": cls_fit}
    scenes, wire = _attr_control_scenes(port)
    total = _vehicles(scenes)
    qg = port["qgemm"]
    det, cls = _attr_load(port, root, "float32", "cuda", small=False)
    _reset_launches(qg)
    (gt_hits,) = _attr_gt_crops(torch, port, cls, wire, scenes, (0.0,))
    row["float32"] = {"gt_box_accuracy": gt_hits / max(total, 1),
                      "gt_box_hits": gt_hits, "vehicles": total,
                      **_attr_report(port, groups, _attr_fused(
                          torch, port, det, cls, groups))}
    if qg.launches:
        raise AssertionError(f"attrs (d): {qg.launches} qgemm launches at "
                             "float32")
    det8, cls8 = _attr_load(port, root, "int8", "cuda", small=False)
    _reset_launches(qg)
    (gt_hits8,) = _attr_gt_crops(torch, port, cls8, wire, scenes, (0.0,))
    cls_variants = _attr_launched(qg, 1, 3, "(d) classify")
    packed8, row["variants"] = _attr_int8_fused(torch, port, det8, cls8,
                                                groups, "(d)")
    for v, n in cls_variants.items():
        row["variants"][v] += n
    row["int8"] = {"gt_box_accuracy": gt_hits8 / max(total, 1),
                   "gt_box_hits": gt_hits8, "vehicles": total,
                   **_attr_report(port, groups, packed8)}
    f32, i8 = row["float32"], row["int8"]
    if i8["gt_box_hits"] < f32["gt_box_hits"] - 1 or i8["hits"] < f32["hits"] - 1:
        raise AssertionError(f"attrs (d): INT8 lost more than one vehicle "
                             f"against float32: {row}")
    return row


def phase_attrs(torch, port, smi: str) -> dict:
    """The classifier's ground truth on the card: the reference's fused
    recipe, its shifted-crop control, the served file and the full-width
    fits (``_attr_recipe``, ``_attr_control``, ``_attr_served``,
    ``_attr_full_width``; each sets the qgemm counts to 0 before its
    INT8 runs and reads them after). Returns the qgemm launches by
    variant."""
    t0 = time.perf_counter()
    rows = {}
    groups = _attr_holdout(port)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        small, full = tmp / "models_small", tmp / "models_full"
        rows["recipe"] = _attr_recipe(torch, port, small, groups)
        _print({"phase": "attrs-recipe", "card": smi, **rows["recipe"]})
        rows["control"] = _attr_control(torch, port, small)
        _print({"phase": "attrs-control", "card": smi, **rows["control"]})
        rows["served"] = _attr_served(torch, port, small, tmp, groups)
        _print({"phase": "attrs-served", "card": smi, **rows["served"]})
        rows["full-width"] = _attr_full_width(torch, port, full, groups)
        _print({"phase": "attrs-full-width", "card": smi,
                **rows["full-width"]})
    variants = {v: sum(r["variants"][v] for r in rows.values())
                for v in ("aligned", "masked")}
    _print({"phase": "attrs", "card": smi,
            "seconds": time.perf_counter() - t0,
            "qgemm_launches": sum(variants.values()), "variants": variants})
    return variants


# ------------------------------------------------------------- temporal

#: the temporal phase: the reference's TestTemporalAccuracy recipe
#: (tests/test_accuracy.py:387-412): the encoder at 48², width 8 (embed
#: 512), the decoder at width 8 (dim 128, depth 4, 8 heads) and AclNet at
#: width 8, float32, fitted with fit_action's and fit_audio's own
#: defaults (600 and 400 steps); the full-width fits (the ZOO_SPECS
#: sizes) take the same steps, the action fit's odd clips rendered at
#: TEMP_FULL_SOURCE_HW (the reference's 2:3 source shape, a shrink to
#: 224²)
TEMP_SMALL = dict(input_overrides={ENC_KEY: (48, 48)},
                  width_overrides={ENC_KEY: 8, DEC_KEY: 8, AUDIO_KEY: 8})
TEMP_STEPS = (600, 400)
TEMP_FULL_SOURCE_HW = (256, 384)
#: (encoder input, encoder width, embed, decoder dim, AclNet width) of
#: the two configurations
TEMP_SIZES = {True: ((48, 48), 8, 512, 128, 8),
              False: ((224, 224), 32, 512, 512, 32)}
#: the reference test's limits: the fits' last losses (:394, :397), and
#: the classes of 4 recovered through the clip path (:457) and the
#: window path (:533)
TEMP_LOSS_MAX = (0.6, 0.3)
TEMP_MIN_RECOVERED = 3
#: the clip path's clips (:432-435): seed 42, 16 frames at 64×96; the
#: order control's clip (:479-480): seed 11, class 0 at 48², and its
#: seeded permutations (:485-491)
TEMP_CLIP_SEED, TEMP_CLIP_HW = 42, (64, 96)
TEMP_ORDER_SEED, TEMP_PERMS = 11, 8
#: the window path (:507-523): 2 s of each tone at amplitude 0.5 in
#: CHUNK_SAMPLES chunks, windows every half second
TEMP_TONE_S = 2
TEMP_AUDIO_PARAMS = {"threshold": 0.0, "sliding-window": 0.5}


def _temp_registry(port, device: str, dtype: str, small: bool,
                   models_dir=None):
    """A registry at the small or the full-width configuration: seeded
    random weights without ``models_dir``, else its fitted files only."""
    return port["ModelRegistry"](
        models_dir=models_dir, dtype=dtype, device=device,
        allow_random_weights=models_dir is None,
        **(TEMP_SMALL if small else {}))


def _temp_models(where: str, registry, small: bool, fitted: bool):
    """The encoder, decoder and AclNet of ``registry``, their sizes
    checked against the configuration (and their weights the fitted
    files when ``fitted``)."""
    enc, dec, aud = (registry.get(k) for k in (ENC_KEY, DEC_KEY, AUDIO_KEY))
    sizes = (enc.spec.input_size, enc.spec.width, enc.module.embed_dim,
             dec.module.pos_embed.shape[-1], aud.spec.width)
    if sizes != TEMP_SIZES[small]:
        raise AssertionError(f"temporal {where}: models of {sizes}, not "
                             f"{TEMP_SIZES[small]}")
    if fitted and {m.weight_source for m in (enc, dec, aud)} != {"msgpack"}:
        raise AssertionError(f"temporal {where}: not the fitted weights")
    return enc, dec, aud


def _temp_fits(torch, port, root: Path, small: bool, where: str) -> dict:
    """fit_action and fit_audio on the card, written by ``save_fitted``
    into ``root`` → their rows (ms a step, seconds, the loss history,
    peak memory)."""
    acc = port["accuracy"]
    enc, dec, aud = _temp_models(
        where, _temp_registry(port, "cuda", "float32", small), small, False)
    action_kw = {} if small else {"source_hw": TEMP_FULL_SOURCE_HW}
    rows = {}
    for name, fit, args, n, kw in (
            ("action", acc.fit_action, (enc, dec), TEMP_STEPS[0], action_kw),
            ("audio", acc.fit_audio, (aud,), TEMP_STEPS[1], {})):
        torch.cuda.reset_peak_memory_stats()
        t = {}
        t0 = time.perf_counter()
        state, history = fit(*args, steps=n, device="cuda", timings=t, **kw)
        rows[name] = {
            "steps": n, **kw, "fit_s": time.perf_counter() - t0,
            "data_s": t["data_s"], "steps_s": t["steps_s"],
            "ms_per_step": 1e3 * t["steps_s"] / n, "loss_history": history,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if not all(math.isfinite(x) for x in history):
            raise AssertionError(f"temporal {where}: the {name} fit "
                                 f"diverged: {history}")
        if name == "action":
            for key, part in zip((ENC_KEY, DEC_KEY), state):
                acc.save_fitted(part, key, root)
        else:
            acc.save_fitted(state, AUDIO_KEY, root)
    return rows


def _temp_run(port, hub, pipeline: tuple[str, str], params: dict,
              events) -> list[dict]:
    """``events`` through a pipeline of ``pipelines/`` on ``hub``, its
    stages built as the server builds them, driven by a StreamRunner →
    the published metadata, in order."""
    outputs: list[dict] = []
    stages = _pipeline_stages(port, hub, params, pipeline)(
        "synthetic://acc", lambda ctx: outputs.append(ctx.metadata))
    runner = port["StreamRunner"]("acc", stages, "synthetic://acc")
    runner.run(iter(events))
    if runner.errors:
        raise AssertionError(f"{pipeline}: {runner.errors} frame errors")
    return outputs


def _temp_hub(port, root: Path, dtype: str, small: bool, where: str):
    """An eager EngineHub of max_batch 16 and a 4 ms deadline (the
    reference test's) over the fitted files at ``dtype``."""
    registry = _temp_registry(port, "cuda", dtype, small, root)
    _temp_models(where, registry, small, True)
    return port["EngineHub"](registry, device="cuda", max_batch=16,
                             deadline_ms=4.0)


def _temp_clips(port, root: Path, dtype: str, small: bool) -> dict:
    """The clip path (:426-457): one 16-frame TEMP_CLIP_HW clip of each
    class through action_recognition/general: exactly the 16th frame
    carries a 400-long tensor, whose argmax is the class recovered."""
    import numpy as np

    where = f"clips {dtype}"
    hub = _temp_hub(port, root, dtype, small, where)
    rng = np.random.default_rng(TEMP_CLIP_SEED)
    argmax = []
    t0 = time.perf_counter()
    try:
        for cls in range(len(port["accuracy"].TEMPORAL_CLASSES)):
            clip = port["accuracy"].render_temporal_clip(rng, cls,
                                                         TEMP_CLIP_HW, 16)
            out = _temp_run(port, hub, ACTION_PIPELINE, {}, (
                port["FrameEvent"](frame=f, pts_ns=i * 33, seq=i)
                for i, f in enumerate(clip)))
            acted = [i for i, m in enumerate(out) if m.get("tensors")]
            if len(out) != 16 or acted != [15]:
                raise AssertionError(f"temporal {where}: {len(out)} lines, "
                                     f"tensors on frames {acted}")
            data = out[15]["tensors"][0]["data"]
            if len(data) != 400 or not all(map(math.isfinite, data)):
                raise AssertionError(f"temporal {where}: a tensor of "
                                     f"{len(data)} values")
            argmax.append(int(np.argmax(data)))
    finally:
        hub.stop()
    return {"precision": dtype, "argmax": argmax,
            "recovered": sum(g == c for c, g in enumerate(argmax)),
            "wall_s": time.perf_counter() - t0}


def _tone(port, cls: int):
    """TEMP_TONE_S seconds of the class's tone at amplitude 0.5 (int16)."""
    import numpy as np

    t = np.arange(TEMP_TONE_S * 16000, dtype=np.float64) / 16000.0
    return np.clip(0.5 * np.sin(2 * np.pi * port["accuracy"].TONE_FREQS[cls]
                                * t) * 32767, -32768, 32767).astype(np.int16)


def _temp_windows(port, root: Path, dtype: str, small: bool) -> dict:
    """The window path (:498-533): each tone in CHUNK_SAMPLES chunks
    through audio_detection/environment (TEMP_AUDIO_PARAMS); the majority
    label id of its windows is the class recovered."""
    where = f"windows {dtype}"
    hub = _temp_hub(port, root, dtype, small, where)
    labels = []
    t0 = time.perf_counter()
    try:
        for cls in range(len(port["accuracy"].TONE_FREQS)):
            wave = _tone(port, cls)
            out = _temp_run(port, hub, AUDIO_PIPELINE, TEMP_AUDIO_PARAMS, (
                port["FrameEvent"](frame=None, audio=wave[i:i + CHUNK_SAMPLES],
                                   pts_ns=i, seq=i // CHUNK_SAMPLES)
                for i in range(0, len(wave), CHUNK_SAMPLES)))
            ids = [m["tensors"][0]["label_id"] for m in out
                   if m.get("tensors")]
            if not ids:
                raise AssertionError(f"temporal {where}: no window "
                                     "classified")
            labels.append(ids)
    finally:
        hub.stop()
    majority = [max(set(ids), key=ids.count) for ids in labels]
    return {"precision": dtype, "window_labels": labels, "majority": majority,
            "recovered": sum(g == c for c, g in enumerate(majority)),
            "wall_s": time.perf_counter() - t0}


def _temp_order(torch, port, root: Path) -> dict:
    """The order control (:461-496) at float32: a class-0 clip's 16
    embeddings (the encode step on BGR frames) into the decoder, as they
    come and in TEMP_PERMS seeded permutations; a decoder that ignores
    its positional embedding answers them all alike."""
    import numpy as np

    enc, dec, _ = _temp_models("order", _temp_registry(
        port, "cuda", "float32", True, root), True, True)
    enc_step = port["build_action_encode_step"](enc, "bgr")
    dec_step = port["build_action_decode_step"](dec)
    clip = port["accuracy"].render_temporal_clip(
        np.random.default_rng(TEMP_ORDER_SEED), 0, (48, 48), 16)
    emb = enc_step(torch.from_numpy(clip).cuda())               # [16, D]
    ordered = int(dec_step(emb[None])[0].argmax())
    permuted = []
    for seed in range(TEMP_PERMS):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(16))
        permuted.append(int(dec_step(emb[perm.cuda()][None])[0].argmax()))
    row = {"ordered": ordered, "permuted": permuted,
           "changed": sum(p != ordered for p in permuted)}
    if not row["changed"]:
        raise AssertionError(f"temporal (a): the decoder's answer is "
                             f"permutation-invariant: {row}")
    return row


def _temp_vs_cpu(torch, port, root: Path) -> dict:
    """The fitted float32 models on the card against the same files on
    the CPU: the encode step's embeddings of one clip of each class at
    48², the decoder's probabilities on the CPU's embeddings, and
    AclNet's on the first second of each tone (``_card_vs_cpu``)."""
    import numpy as np

    models = {dev: _temp_models(f"{dev} models", _temp_registry(
        port, dev, "float32", True, root), True, True)
        for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(TEMP_CLIP_SEED)
    clips = torch.from_numpy(np.stack([
        port["accuracy"].render_temporal_clip(rng, c, (48, 48), 16)
        for c in range(4)]))
    emb = {dev: torch.stack([port["build_action_encode_step"](
        m[0], "bgr")(c.to(dev)) for c in clips]) for dev, m in models.items()}
    windows = torch.from_numpy(np.stack([_tone(port, c)[:WINDOW_SAMPLES]
                                         for c in range(4)]))
    out = {}
    for dev, (_, dec, aud) in models.items():
        out[dev] = (port["build_action_decode_step"](dec)(emb["cpu"].to(dev)),
                    port["build_audio_step"](aud)(windows.to(dev)))
    rows = [_card_vs_cpu(torch, "temporal-check", "embeddings", emb["cpu"],
                         emb["cuda"], top1=False),
            _card_vs_cpu(torch, "temporal-check", "decoder probabilities",
                         out["cpu"][0], out["cuda"][0]),
            _card_vs_cpu(torch, "temporal-check", "aclnet probabilities",
                         out["cpu"][1], out["cuda"][1])]
    return {r["output"]: r["max_abs_diff"] for r in rows}


def _temp_recipe(torch, port, root: Path) -> dict:
    """(a): the reference's recipe and limits on the card."""
    row = {"fits": _temp_fits(torch, port, root, True, "(a)")}
    for (name, fit), limit in zip(row["fits"].items(), TEMP_LOSS_MAX):
        if fit["loss_history"][-1] >= limit:
            raise AssertionError(f"temporal (a): the {name} fit did not "
                                 f"converge below {limit}: {row}")
    for dtype in ("float32", "int8"):
        row[f"clips_{dtype}"] = _temp_clips(port, root, dtype, True)
        row[f"windows_{dtype}"] = _temp_windows(port, root, dtype, True)
    row["order"] = _temp_order(torch, port, root)
    row["card_vs_cpu_max_abs_diff"] = _temp_vs_cpu(torch, port, root)
    for path in ("clips", "windows"):
        f32, i8 = (row[f"{path}_{d}"]["recovered"] for d in ("float32", "int8"))
        if f32 < TEMP_MIN_RECOVERED:
            raise AssertionError(f"temporal (a): {f32} of 4 classes through "
                                 f"the {path} path at float32: {row}")
        if i8 < f32 - 1:
            raise AssertionError(f"temporal (a): INT8 recovered {i8} "
                                 f"{path} classes against float32's {f32}")
    return row


def _temp_full_width(torch, port, root: Path) -> dict:
    """(b): both fits at the registry's own sizes, the clip and window
    paths at float32 and at INT8 (no limit of the reference at this
    size: the losses must fall, INT8 within one class of float32)."""
    row = {"fits": _temp_fits(torch, port, root, False, "(b)")}
    for name, fit in row["fits"].items():
        if not fit["loss_history"][-1] < fit["loss_history"][0]:
            raise AssertionError(f"temporal (b): the {name} fit's loss did "
                                 f"not fall: {fit['loss_history']}")
    for dtype in ("float32", "int8"):
        row[f"clips_{dtype}"] = _temp_clips(port, root, dtype, False)
        row[f"windows_{dtype}"] = _temp_windows(port, root, dtype, False)
    for path in ("clips", "windows"):
        f32, i8 = (row[f"{path}_{d}"]["recovered"] for d in ("float32", "int8"))
        if i8 < f32 - 1:
            raise AssertionError(f"temporal (b): INT8 recovered {i8} "
                                 f"{path} classes against float32's {f32}")
    return row


def phase_temporal(torch, port, smi: str) -> dict:
    """The action and audio ground truth on the card: the reference's
    recipe with its limits, its order control and the card against the
    CPU (``_temp_recipe``), then the full-width fits
    (``_temp_full_width``). K1 is not on this path: the qgemm counts are
    set to 0 before the phase and must read 0 after it."""
    t0 = time.perf_counter()
    qg = port["qgemm"]
    _reset_launches(qg)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rows["recipe"] = _temp_recipe(torch, port, tmp / "models_small")
        _print({"phase": "temporal-recipe", "card": smi, **rows["recipe"]})
        rows["full-width"] = _temp_full_width(torch, port,
                                              tmp / "models_full")
        _print({"phase": "temporal-full-width", "card": smi,
                **rows["full-width"]})
    if qg.launches:
        raise AssertionError(f"temporal: {qg.launches} qgemm launches")
    row = {"phase": "temporal", "card": smi,
           "seconds": time.perf_counter() - t0, "qgemm_launches": qg.launches}
    _print(row)
    return row


# ------------------------------------------------------------------ aot

#: the aot phase: frames of its one served stream, its in-process
#: child's ladder top, and the rungs of the fallback ladder the child
#: walks on the engines' library, in order
AOT_FRAMES = 8
AOT_MAX_BATCH = 8
AOT_RUNGS = ("crc", "version", "deserialize", "execute")
#: the batcher's warmup log line: eager and capture seconds by bucket
_WARM_LOG_RE = re.compile(r"engine (\S+) warmed \d+ buckets .*eager and "
                          r"capture seconds by bucket (\{.*\})")


def _nvcc_recorder(home: Path, log: Path, real: str) -> Path:
    """A CUDA_HOME whose ``bin/nvcc`` runs the real compiler and appends
    one JSON line per call to ``log`` (start, seconds, exit code, the
    source it compiled). ``ops/kernels.py`` takes nvcc from CUDA_HOME
    first, so the line count is the child's nvcc runs."""
    script = home / "bin" / "nvcc"
    script.parent.mkdir(parents=True)
    script.write_text(
        f"#!{sys.executable}\n"
        "import json, subprocess, sys, time\n"
        "t0 = time.time()\n"
        f"rc = subprocess.call([{real!r}] + sys.argv[1:])\n"
        f"with open({str(log)!r}, 'a') as fh:\n"
        "    fh.write(json.dumps({'t0': t0, 's': time.time() - t0, 'rc': rc,\n"
        "        'src': [a for a in sys.argv[1:] if a.endswith('.cu')]})\n"
        "        + '\\n')\n"
        "sys.exit(rc)\n")
    script.chmod(0o755)
    return home


def _nvcc_builds(port, log: Path) -> dict[str, list[float]]:
    """Library → the seconds of each nvcc build the recorder saw
    (``--version`` calls, which compile nothing, are left out)."""
    lib_of = {src: name for name, src in port["kernels"].SOURCES.items()}
    out: dict[str, list[float]] = {}
    if log.exists():
        for line in log.read_text().splitlines():
            call = json.loads(line)
            for src in call["src"]:
                out.setdefault(lib_of[Path(src).name], []).append(call["s"])
    return out


def _aot_serve(port, tmp: Path, label: str, env_extra: dict) -> dict:
    """One ``python3 -m evam_tpu_torch.cli.main serve`` child with its
    own empty compile directory (``EVAM_COMPILE_CACHE_DIR``) and nvcc
    recorder, person_vehicle_bike preloaded (INT8, K1): seconds from
    spawn to /healthz 200 and to the first published line of one
    8-frame stream, nvcc seconds per library, each engine's eager and
    capture seconds per bucket (its warmup log line), /engines and the
    /healthz ``aot`` block (the golden's shape), the published objects
    and the K1 launches from /metrics."""
    rest_port = _free_port()
    base = f"http://127.0.0.1:{rest_port}"
    cc = tmp / f"cc-{label}"
    nvcc_log = tmp / f"nvcc-{label}.jsonl"
    home = _nvcc_recorder(tmp / f"cuda-{label}", nvcc_log,
                          port["kernels"]._nvcc())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EVAM_AOT")}
    env.update(REST_PORT=str(rest_port), EVAM_PRECISION="int8",
               EVAM_QGEMM="pallas", EVAM_ALLOW_RANDOM_WEIGHTS="1",
               EVAM_PRELOAD="/".join(DETECT_PIPELINE),
               MODELS_DIR=str(tmp / "models"), EVAM_COMPILE_CACHE_DIR=str(cc),
               CUDA_HOME=str(home), **env_extra)
    log_path = tmp / f"serve-{label}.log"
    golden = json.loads((ROOT / "tests" / "golden"
                         / "route_healthz.json").read_text())
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        _await_health(base, proc, log_path, t0)
        up_s = time.perf_counter() - t0
        out = tmp / f"aot-{label}.jsonl"
        status, iid = _http(base, "POST", PIPELINE,
                            _stream_body(out, AOT_FRAMES, 0))
        if status != 200:
            raise AssertionError(f"aot ({label}): POST gave {status} {iid}")
        while not (out.exists() and out.read_text().strip()):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(f"aot ({label}): no line published: "
                                     f"{log_path.read_text()[-2000:]}")
            time.sleep(0.005)
        first_line_s = time.perf_counter() - t0
        state = _wait_states(base, [iid], ("COMPLETED", "ERROR", "ABORTED"),
                             300)[iid]
        lines = [json.loads(ln) for ln in out.read_text().splitlines()]
        if state["state"] != "COMPLETED" or len(lines) != AOT_FRAMES:
            raise AssertionError(f"aot ({label}): {state}, {len(lines)} lines")
        _, engines = _http(base, "GET", "/engines")
        status, health = _http(base, "GET", "/healthz")
        if status != 200 or canonical(health) != golden:
            raise AssertionError(f"aot ({label}): /healthz {status} is not "
                                 f"the golden's shape: {health}")
        launches = _kernel_launches(base)
        forwards = sum(_fwd(v) for v in engines.values())
        if launches != {"aligned": 10 * forwards, "masked": 0}:
            raise AssertionError(f"aot ({label}): qgemm launches {launches} "
                                 f"for {forwards} forwards")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=30)
        if code != 0:
            raise AssertionError(f"aot ({label}): exit {code} on SIGTERM: "
                                 f"{log_path.read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log_path.read_text()
    return {"healthz_s": up_s, "first_line_s": first_line_s,
            "nvcc_s": _nvcc_builds(port, nvcc_log),
            "warm_s": {m.group(1): json.loads(m.group(2))
                       for m in _WARM_LOG_RE.finditer(text)},
            "engines": {k: {"buckets": v["buckets"],
                            "compiled_programs": v["compiled_programs"],
                            "compile_s": v["compile_s"], "aot": v["aot"]}
                        for k, v in engines.items()},
            "aot": health["aot"], "launches": launches,
            "built": sorted(p.name for p in cc.glob("lib*.so")),
            "objects": [ln["objects"] for ln in lines],
            "compile_dir": cc}


def _aot_k1(torch, port) -> dict:
    """(f) K1 from the store-loaded library at the ten shapes of one
    SSD forward (8 images, bf16): codes, row scales and outputs equal
    to the plain version's."""
    qg, ql = port["qgemm"], port["qlinear"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in MAIN_SHAPES:
        m *= IMAGES
        x = torch.randn((m, k), generator=gen, device="cuda").mul_(2.0)
        x = x.to(torch.bfloat16)
        wq, w_scale = ql.quantize_weight(
            torch.randn((k, n), generator=gen, device="cuda") * 0.2)
        wq = wq.T.contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda") * 0.1
        out, codes, scales = qg.qgemm(x, wq, w_scale, bias, return_codes=True)
        ref = qg.qgemm_reference(x, wq, w_scale, bias)
        ref_codes, ref_scales = qg.quantize_rows(x)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(codes, ref_codes)
                and torch.equal(scales, ref_scales)):
            raise AssertionError(
                f"aot (f): K1 from the stored library differs at "
                f"{m}x{k}x{n}: max abs err {(out - ref).abs().max().item()}")
    return {"shapes": len(MAIN_SHAPES), "max_abs_err": 0.0}


def _aot_spin_up(torch, port) -> dict:
    """(g) A supervisor rebuild (the engine phase's stub wedge) and a
    fleet ``scale_up`` on this card: every bucket of the rebuilt engine
    and of the new shard a hit (aot.hits == compiled_programs)."""
    import numpy as np

    registry = port["ModelRegistry"](device="cuda", allow_random_weights=True)
    wire = port["wire_frame"](next(port["SyntheticSource"](
        512, 512, count=1, seed=5).frames()).frame, (512, 512), "i420")
    hub = _default_hub(port, registry, max_batch=AOT_MAX_BATCH,
                       stall_timeout_s=ENGINE_STALL_S, first_batch_grace=2.0,
                       restart_backoff_s=0.05)
    fleet_hub = port["EngineHub"](
        registry, device="cuda", devices=["cuda:0", "cuda:0"],
        fleet="sharded", fleet_max_shards=2, fleet_initial_shards=1,
        max_batch=2 * AOT_MAX_BATCH, stall_timeout_s=ENGINE_STALL_S,
        first_batch_grace=2.0, warmup=True)
    out: dict = {}
    try:
        eng = hub.engine("detect", KEY)
        eng.warm_async(frames=np.zeros_like(wire))
        _await_warm("aot (g)", [eng])
        out["rebuild"] = _wedge_and_recover(torch, port, hub, eng)
        row = eng.stats_row()
        live = eng._engine.stats_row()
        if not (live["aot"]["hits"] == live["compiled_programs"]
                == len(eng.buckets) and row["aot"]["hits"]
                == row["compiled_programs"] == 2 * len(eng.buckets)
                and row["compile_s"] == 0.0):
            raise AssertionError(f"aot (g): supervisor rebuild row {row}")
        out["rebuild"].update(buckets=eng.buckets, row_aot=row["aot"],
                              rebuilt_aot=live["aot"])
        fleet = fleet_hub.engine("detect", KEY)
        fleet.warm_async(frames=np.zeros_like(wire))
        _await_warm("aot (g) fleet", [e for _, _, e in fleet.shard_rows()])
        t0 = time.perf_counter()
        label = fleet.scale_up()
        spin_s = time.perf_counter() - t0
        rows = {lb: e.stats_row() for lb, _, e in fleet.shard_rows()}
        new = rows.get(label or "")
        if label is None or new is None or not (
                new["aot"]["hits"] == new["compiled_programs"]
                == len(new["buckets"]) > 0 and new["compile_s"] == 0.0):
            raise AssertionError(f"aot (g): scale_up gave {label}: {rows}")
        for s in range(4):
            fleet.submit(frames=wire, stream=f"aot{s}").result(timeout=60)
        out["scale_up"] = {"shard": label, "spin_up_s": spin_s,
                           "rows": {lb: {"aot": r["aot"],
                                         "compiled_programs":
                                             r["compiled_programs"],
                                         "batches": r["batches"]}
                                    for lb, r in rows.items()}}
    finally:
        hub.stop()
        fleet_hub.stop()
    return out


def _aot_ladder(port, cache, nvcc_log: Path) -> dict:
    """(d) The fallback ladder on the engines' library (the small one:
    each rebuild is short): each rung mangles its entry, then
    ``kernels.open_library`` walks the ladder. The rung is counted in
    ``summary()`` and in the metric; crc, deserialize and execute
    discard the entry, version keeps it; nvcc rebuilds the library
    (its compile-directory copy removed first), the store takes it
    back, and it serves (its self-test)."""
    from evam_tpu_torch.aot import cache as aot_cache
    from evam_tpu_torch.engine import streams

    kernels, metrics = port["kernels"], port["metrics"]
    name = "engine_cuda"
    key = kernels.aot_key(name)
    entry = cache._path(key)
    qgemm_payload = aot_cache._unpack_entry(
        cache._path(kernels.aot_key("qgemm")).read_bytes())[1]
    rows = {}
    for rung in AOT_RUNGS:
        if rung == "crc":
            blob = entry.read_bytes()
            entry.write_bytes(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
        elif rung == "version":
            header, payload = aot_cache._unpack_entry(entry.read_bytes())
            header["driver"] = "0.0.0-another-driver"
            entry.write_bytes(aot_cache._pack_entry(header, payload))
        elif rung == "deserialize":
            cache.store(key, b"not a shared library" * 64, engine=name)
        else:  # a valid library whose self-test fails: K1's, not ours
            cache.store(key, qgemm_payload, engine=name)
        kernels.library_path(name).unlink(missing_ok=True)
        before = cache.summary()["misses"][rung]
        metric = metrics.get_counter(
            "evam_aot_cache_misses", labels={"engine": name, "reason": rung})
        builds = len(_nvcc_builds(port, nvcc_log).get(name, []))
        discarded = []
        cache._discard = lambda path, seen=discarded: (
            seen.append(path), aot_cache.AotCache._discard(path))
        try:
            t0 = time.perf_counter()
            lib = kernels.open_library(name)
            seconds = time.perf_counter() - t0
        finally:
            del cache._discard
        streams.self_test(lib)
        header, payload = aot_cache._unpack_entry(entry.read_bytes())
        row = {"summary": cache.summary()["misses"][rung] - before,
               "metric": metrics.get_counter(
                   "evam_aot_cache_misses",
                   labels={"engine": name, "reason": rung}) - metric,
               "discarded": discarded == [entry],
               "rebuilds": len(_nvcc_builds(port, nvcc_log).get(name, []))
               - builds, "seconds": seconds}
        if (row["summary"], row["metric"], row["discarded"], row["rebuilds"]) \
                != (1, 1.0, rung != "version", 1) \
                or payload != kernels.library_path(name).read_bytes() \
                or {k: header.get(k) for k in aot_cache.env_fingerprint()} \
                != aot_cache.env_fingerprint():
            raise AssertionError(f"aot (d): rung {rung}: {row}")
        rows[rung] = row
    # and the recovered entry serves: a hit, no nvcc
    hits = cache.summary()["hits"]
    builds = len(_nvcc_builds(port, nvcc_log).get(name, []))
    streams.self_test(kernels.open_library(name))
    if cache.summary()["hits"] != hits + 1 or len(
            _nvcc_builds(port, nvcc_log).get(name, [])) != builds:
        raise AssertionError("aot (d): the recovered entry did not serve")
    return rows


def _aot_evict(port, cache, root: Path) -> dict:
    """(e) Eviction under a small EVAM_AOT_MAX_BYTES: the two libraries'
    payloads stored oldest first into a store capped below the newest;
    the oldest entry goes and the newest survives."""
    from evam_tpu_torch.aot import cache as aot_cache

    kernels = port["kernels"]
    payloads = {n: aot_cache._unpack_entry(cache._path(
        kernels.aot_key(n)).read_bytes())[1] for n in ("engine_cuda", "qgemm")}
    cap = port["Settings"].from_env(env={"EVAM_AOT_MAX_BYTES": str(
        len(payloads["engine_cuda"]) + 4096)}).aot.max_bytes
    small = aot_cache.AotCache(root, cap)
    keys = {}
    for i, (n, payload) in enumerate(payloads.items()):
        keys[n] = kernels.aot_key(n)
        small.store(keys[n], payload, engine=n)
        os.utime(small._path(keys[n]), (1e9 + i, 1e9 + i))
    s = small.summary()
    if (s["entries"], s["evictions"]) != (1, 1) or small._path(
            keys["engine_cuda"]).exists() or not small._path(
            keys["qgemm"]).exists():
        raise AssertionError(f"aot (e): {s}")
    return {"max_bytes": cap, "entries": s["entries"], "bytes": s["bytes"],
            "evictions": s["evictions"], "survivor": "qgemm"}


def aot_child(spec: str) -> int:
    """The aot phase's in-process half, in a fresh process whose
    EVAM_AOT_DIR already holds both libraries (``spec``: JSON with
    ``dir``, ``nvcc_log``, ``evict_dir``): (f), (g), (d), (e). Prints
    one JSON line; K1's served launches of (g) in it."""
    args = json.loads(spec)
    faulthandler.dump_traceback_later(args["timeout"], exit=True)
    import torch

    port = _import_port()
    from evam_tpu_torch import aot

    cache = aot.active()
    if cache is None or cache.root != Path(args["dir"]):
        raise AssertionError(f"aot child: the cache is {cache}")
    t0 = time.perf_counter()
    port["qgemm"]._lib()  # K1's library: a hit, self-tested
    load_s = time.perf_counter() - t0
    s = cache.summary()
    if s["hits"] != 1 or any(s["misses"].values()):
        raise AssertionError(f"aot child: K1's load gave {s}")
    row = {"phase": "aot-inprocess", "k1_load_s": load_s,
           "k1": _aot_k1(torch, port)}
    _reset_launches(port["qgemm"])
    row["spin_up"] = _aot_spin_up(torch, port)
    row["variants"] = dict(port["qgemm"].variant_launches)
    row["ladder"] = _aot_ladder(port, cache, Path(args["nvcc_log"]))
    row["evict"] = _aot_evict(port, cache, Path(args["evict_dir"]))
    row["summary"] = cache.summary()
    _print(row)
    return 0


def phase_aot(torch, port, smi: str) -> dict[str, int]:
    """The AOT cache (``evam_tpu_torch/aot/``) on the card: (a) the
    start-up of a ``serve`` child with EVAM_AOT off and an empty compile
    directory, measured; (b) a cold child with EVAM_AOT=1 and a fresh
    shared EVAM_AOT_DIR (one ``absent`` miss per library, the entries
    the libraries it built, nvcc ran); (c) a warm child on the same
    store and another empty compile directory (a hit per library, no
    miss, no nvcc run and nothing built, /engines hits ==
    compiled_programs, the objects (b) published bit for bit); then, in
    a fresh process on the same store, (f) K1 from the stored library
    at the ten SSD shapes, (g) a supervisor rebuild and a fleet
    scale_up all hits, (d) the ladder's four rungs counted and
    recovered, (e) eviction. Returns the served K1 launches of (a), (b),
    (c) and (g) by variant."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        shared = tmp / "aot"
        on = {"EVAM_AOT": "1", "EVAM_AOT_DIR": str(shared)}
        runs = {"startup": _aot_serve(port, tmp, "a", {}),
                "cold": _aot_serve(port, tmp, "b", on),
                "warm": _aot_serve(port, tmp, "c", on)}
        libs = sorted(port["kernels"].SOURCES)
        a, b, c = runs["startup"], runs["cold"], runs["warm"]
        for label, run in runs.items():
            _print({"phase": f"aot-{label}", "card": smi,
                    **{k: v for k, v in run.items()
                       if k not in ("objects", "compile_dir")}})
        if a["aot"]["enabled"] or sorted(a["nvcc_s"]) != libs:
            raise AssertionError(f"aot (a): {a['aot']}, nvcc {a['nvcc_s']}")
        none = dict.fromkeys(("absent", "version", "crc", "deserialize",
                              "execute"), 0)
        if (b["aot"]["misses"] != {**none, "absent": len(libs)}
                or b["aot"]["hits"] or b["aot"]["entries"] != len(libs)
                or sorted(b["nvcc_s"]) != libs):
            raise AssertionError(f"aot (b): {b['aot']}, nvcc {b['nvcc_s']}")
        from evam_tpu_torch.aot.cache import _unpack_entry

        stored = sorted(_unpack_entry(p.read_bytes())[1]
                        for p in shared.glob("*.aotx"))
        built = sorted(p.read_bytes()
                       for p in b["compile_dir"].glob("lib*.so"))
        if stored != built:
            raise AssertionError("aot (b): the entries are not the libraries "
                                 "the child built")
        if (c["aot"]["hits"] != len(libs) or c["aot"]["misses"] != none
                or c["nvcc_s"] or c["built"] or not all(
                    e["aot"]["hits"] == e["compiled_programs"] > 0
                    and e["compile_s"] == 0.0 for e in c["engines"].values())):
            raise AssertionError(f"aot (c): {c['aot']}, nvcc {c['nvcc_s']}, "
                                 f"built {c['built']}, {c['engines']}")
        if c["objects"] != b["objects"]:
            raise AssertionError("aot (c): the warm child's objects differ "
                                 "from the cold child's")
        nvcc_log = tmp / "nvcc-child.jsonl"
        home = _nvcc_recorder(tmp / "cuda-child", nvcc_log,
                              port["kernels"]._nvcc())
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("EVAM_AOT")}
        env.update(on, EVAM_COMPILE_CACHE_DIR=str(tmp / "cc-child"),
                   CUDA_HOME=str(home))
        spec = json.dumps({"dir": str(shared), "nvcc_log": str(nvcc_log),
                           "evict_dir": str(tmp / "evict"), "timeout": 280})
        res = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.aot_child(sys.argv[1]))", spec],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"aot child: exit {res.returncode}\n"
                                 f"{res.stderr[-4000:]}\n{res.stdout[-2000:]}")
        child = json.loads(res.stdout.strip().splitlines()[-1])
        _print({**child, "card": smi})
    row = {"phase": "aot", "card": smi, "seconds": time.perf_counter() - t_phase,
           "healthz_s": {k: r["healthz_s"] for k, r in runs.items()},
           "first_line_s": {k: r["first_line_s"] for k, r in runs.items()},
           "objects_equal": True}
    _print(row)
    served = [r["launches"] for r in runs.values()] + [child["variants"]]
    return {v: sum(d[v] for d in served) for v in ("aligned", "masked")}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after the slice run, profile a shorter one")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "rest" in phases and "slice" not in phases:
        ap.error("the rest phase checks its objects against the slice phase")

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "evam_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    # a hang says where it is: every thread's stack on stderr, then exit
    # 1, inside the 1200 s the script is given
    faulthandler.dump_traceback_later(1140, exit=True)
    sys.path.insert(0, str(ROOT))
    # the slice's configuration, set before the port reads its knobs
    os.environ["EVAM_PRECISION"] = "int8"
    os.environ["EVAM_QGEMM"] = "pallas"
    port = _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs a compute capability 9.0 device, got {cap}",
              file=sys.stderr)
        return 1
    smi = _nvidia_smi()
    _print({"phase": "device", "name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = port["kernels"].build()
    # the host encode's library too: every serving phase calls it
    native = port["native"].build()
    _print({"phase": "build", "seconds": time.perf_counter() - t0,
            "kernels": {k: v["seconds"] for k, v in built.items()},
            "native_s": native["seconds"], "native": native["path"]})

    kernel = {"name": "qgemm", "route": "cuda",
              "source": "evam_tpu_torch/csrc/qgemm.cu",
              "replaces": "evam_tpu/ops/pallas_qgemm.py:33",
              "launches": None, "max_abs_err": None, "ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None, "device_ms": None, "bound_share": None,
              "launches_by_variant": None, "forward": None}
    if "qgemm" in phases:
        fused = phase_qgemm(torch, port)["fused"]
        kernel.update({k: fused[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "bound_share")})
        kernel["forward"] = (f"one fused detect+classify forward of {IMAGES} "
                             f"frames: {len(MAIN_SHAPES)} SSD calls and "
                             f"{len(CLS_SHAPES)} classifier calls on "
                             f"{IMAGES * ROI_BUDGET} crops")
    served = []  # qgemm launches by variant, one entry per serving phase
    if "reference" in phases:
        phase_reference(torch, port)
    if "weights" in phases:
        phase_weights(torch, port)
    if "slice" in phases:
        res = phase_slice(torch, port, profile=args.profile)
        if res["input_hw"] != (512, 512) or res["width"] != 32:
            raise AssertionError(f"slice ran {res['input_hw']} width "
                                 f"{res['width']}, not the full-width model")
        served.append({"aligned": res["launches"], "masked": 0})
        _memory(torch, "slice", t_start)
    if "classify" in phases:
        res_cls = phase_classify(torch, port)
        if res_cls["models"] != (512, 512, 32, 72, 72, 32,
                                 (("color", 7), ("type", 4))):
            raise AssertionError(f"classify ran {res_cls['models']}, not the "
                                 "full-width models")
        served.append(res_cls["variants"])
        _memory(torch, "classify", t_start)
    if "engine" in phases:
        served.append(phase_engine(torch, port)["variants"])
        _memory(torch, "engine", t_start)
    if "track" in phases:
        served.append(phase_track(torch, port))
        _memory(torch, "track", t_start)
    if "gate" in phases:
        served.append(phase_gate(torch, port, res["fps"] if "slice" in phases
                                 else None))
        _memory(torch, "gate", t_start)
    if "ragged" in phases:
        served.append(phase_ragged(torch, port)["variants"])
        _memory(torch, "ragged", t_start)
    if "sched" in phases:
        served.append(phase_sched(torch, port))
        _memory(torch, "sched", t_start)
    if "tune" in phases:
        served.append(phase_tune(torch, port))
        _memory(torch, "tune", t_start)
    if "native" in phases:
        served.append(phase_native(torch, port, native)["variants"])
        _memory(torch, "native", t_start)
    if "fleet" in phases:
        served.append(phase_fleet(torch, port)["variants"])
        _memory(torch, "fleet", t_start)
    # the action and audio pipelines launch no kernel of this repo
    # (asserted inside): they add nothing to the kernels line
    if "action" in phases:
        phase_action(torch, port)
        _memory(torch, "action", t_start)
    if "audio" in phases:
        phase_audio(torch, port)
        _memory(torch, "audio", t_start)
    # the IR engines launch it zero times (asserted inside)
    if "ir" in phases:
        phase_ir(torch, port)
        _memory(torch, "ir", t_start)
    if "rest" in phases:
        served.append(phase_rest(torch, port, res["s0_objects"]))
        _memory(torch, "rest", t_start)
    if "serve" in phases:
        served.append(phase_serve())
    if "eii" in phases:
        served.append(phase_eii(torch, port))
        _memory(torch, "eii", t_start)
    if "trace" in phases:
        served.append(phase_trace(torch, port))
        _memory(torch, "trace", t_start)
    if "chaos" in phases:
        served.append(phase_chaos(torch, port))
        _memory(torch, "chaos", t_start)
    if "ingest" in phases:
        served.append(phase_ingest(torch, port, profile=args.profile))
        _memory(torch, "ingest", t_start)
    if "webrtc" in phases:
        served.append(phase_webrtc(torch, port))
        _memory(torch, "webrtc", t_start)
    # the training path launches K1 zero times (asserted inside)
    if "train" in phases:
        phase_train(torch, port, smi)
        _memory(torch, "train", t_start)
    if "dryrun" in phases:
        phase_dryrun()
    # ground truth at float32 and at INT8 through K1 (its launches count)
    if "accuracy" in phases:
        served.append(phase_accuracy(torch, port, smi))
        _memory(torch, "accuracy", t_start)
    if "attrs" in phases:
        served.append(phase_attrs(torch, port, smi))
        _memory(torch, "attrs", t_start)
    # the action and audio fits launch K1 zero times (asserted inside)
    if "temporal" in phases:
        phase_temporal(torch, port, smi)
        _memory(torch, "temporal", t_start)
    # the AOT cache: serve children and an in-process child on the
    # store (K1's served launches of each count)
    if "aot" in phases:
        served.append(phase_aot(torch, port, smi))
        _memory(torch, "aot", t_start)
    _print({"phase": "total", "seconds": time.perf_counter() - t_start})
    if served:
        kernel["launches_by_variant"] = {
            v: sum(d[v] for d in served) for v in ("aligned", "masked")}
        kernel["launches"] = sum(kernel["launches_by_variant"].values())
    torch.cuda.synchronize()
    _print({"kernels": [kernel]})
    print(smi, flush=True)
    _print({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
