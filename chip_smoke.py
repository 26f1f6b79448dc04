#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env    — card name, card count, ``nvidia-smi`` name and power limit.
            No card: exit 1 before anything else.
2. build  — one ``nvcc`` per kernel, all started at once, builds
            ``lease_validate``, ``flash_attention`` and ``ssd_scan`` from
            ``src/repro_torch/kernels/csrc``; wall seconds, and each
            kernel's nvcc seconds and ptxas report (registers, shared
            memory, spills); then ``build_prefill_tc``: the registers and
            spills of each ``prefill_tc`` instantiation, (Dk, Dv) in
            (64, 64), (80, 80), (128, 128), (192, 128); and
            ``build_backward_tc``: those of the tc backward's ``dkdv_tc``
            (``dkdv_tc2`` at (192, 128)) and ``dq_tc`` at the same pairs,
            none spilling; ``build_simt``: those of the simt forward's 8
            and the simt backward's 3 + 5 instantiations (split-TF32
            ``mma.sync``), none spilling; ``build_ssd_simt``: those of the
            SSD simt forward's state and chunk kernels and its backward's
            own and chunk kernels (2 + 2 + 4 + 4), none spilling.
3. kernel — the kernel against its plain PyTorch version, bitwise, at the
            simulator's shapes (1,140,088 items, B in {8, 16}, R = 32,
            W = 16, plus a lock-free W = 1 case) and at a wide shape
            (B = 1024, R = 256, W = 64, 2^20 items).  ``ms`` is the time
            per call as a caller sees it (CUDA events around many calls,
            host launch cost included), ``graph_ms`` the device time per
            call (many calls replayed from one CUDA graph); the bound is
            the bytes at 3.35 TB/s; ``floor_ms`` / ``floor_graph_ms`` the
            same two times of an empty kernel through the same ctypes
            launch (the design's floor); ``launches`` counts the kernel
            calls the case made (check, timing and graph capture).
   kernel_drain — the ``drain`` variant (one launch: flush the dirty
            pairs, class-owner write check, certify) against
            ``ref.lease_drain_ref``, bitwise on ok and on the flushed table,
            at the main path's shapes (TPC-C's 1,140,088 items and class
            map, B in {8, 16}, R = 32, W = 16, B x W dirty items); per-call
            wall (launch + wait), device time by CUDA-graph replay, the
            plain version and the bound.  Then a
            whole drain as the cluster calls it (``validate_batch``),
            per-drain host wall for four routes in
            turns: ``per_item``, the route before the drain variant
            (per-item locks on the card, flush, ``gather``, ``.cpu()``),
            ``drain``, the floor and the CPU twin.
            After phase 5 (a profiler session may leave hooks behind),
            ``kernel_drain_ops``: device operations per drain under
            ``torch.profiler`` for the two card routes.
4. main   — the Lilac-TM commit path: LILAC-TM-ST on TPC-C at the TPC-C
            specification's cardinalities (8 warehouses, 1,140,088 items,
            version tables on the card), 300 ms of simulated time.  Every
            batched drain must have launched ``drain`` once (and ``gather``
            never); the same run on the CPU must give byte-identical
            replica stores and identical metrics.  ``validate_s`` is the
            wall inside ``validate_batch``; ``drain_plans`` counts the
            drains by the launch plan their (B, n_dirty) takes, beside the
            largest B and n_dirty of the run.
5. forced — Bank at SimConfig defaults with every drain through the kernel
            and every lease settle through the device ops, a node failure
            at 120 ms; cuda against cpu, byte-identical; the same drain
            checks; the settle's calls and host wall on each device.
6. kernel_flash — the flash kernel against ``ref.sdpa_ref`` on the card,
            each case printing the variant that ran (``prefill_tc``,
            ``decode_split`` or ``simt``, which the launcher picks from the
            dtype and shapes): glm4-9b prefill (B = 4, S = 2048, Hq = 32,
            Hkv = 2, D = 128, causal, bf16), glm4-9b decode (Sq = 1
            against a 2080-slot ring, per-row valid lengths, unwritten tail
            at 2^30; timed over 8 distinct caches, 68 MB, in rotation so L2
            is cold as it is for the model's 40 layers, and over one cache,
            ``*_warm``), the reference's test grid (tests/test_kernels.py)
            and the variants' edges (a ragged last tile, no causal mask, a
            window, 64 decode rows, one valid key, f32 decode at D 64),
            deepseek-v2's MLA prefill (B = 2, S = 2048, Hq = Hkv =
            128, Dk = 192, Dv = 128, causal, bf16: ``prefill_tc``) and
            prefill_tc's edges at those dims (a ragged Sq, kv padding, a
            window, softcap, GQA 2, no causal mask), MLA's multi-token
            serving step (B = 2, 3 rows over 2048 keys, bf16, the lse on:
            ``simt``'s one-warp tile, ``mla_multi_step``), and ``simt`` at
            MLA's shape in f32 (``simt_mla_f32``, simt's record); hubert-xlarge's
            encoder shape (B = 4, S = 2048, Hq = Hkv = 16, Dk = Dv = 80,
            bidirectional, bf16: ``prefill_tc<80,80>``, its 64-column
            panels padded to 128 with zeros) and its edges at D 80 (causal,
            ragged S, GQA 4, a window, kv padding, softcap), and the same
            encoder shape in f32 (``simt``); gemma3-27b's own shapes (1 x
            4096, Hq 32, Hkv 16, D 128: a local layer's 1024-key window,
            a global layer, a local decode step in a 4128-slot ring); f32
            within 2e-5, bf16 within atol 1e-3 + rtol 1.6e-2 (two bf16
            ulps: every variant computes in fp32 and rounds the output
            once, prefill_tc with P.V on bf16 hi + lo parts of P).  Per
            case: ``ms`` (CUDA events), ``graph_ms`` (CUDA-graph replay),
            ``plain_ms``, ``bound_ms``/``bound_by`` (FLOPs of the visible
            pairs at 989 TFLOP/s bf16, or in f32 as split-TF32, three TF32
            products at 495 TFLOP/s each, with ``bound_fp32_ms`` beside at
            the fp32 CUDA cores' 67 TFLOP/s; bytes of q, the output and the
            keys some row sees, at 3.35 TB/s), an f32 case SDPA's backend
            by name (``library_backend``), for
            ``prefill_tc`` ``floor_ms`` (its P.V on P's two bf16 parts:
            the FLOPs of (Dk + 2 Dv) per visible pair, Dk in k-steps of 16
            and Dv in 64-column panels: 80 + 2 x 128 at D 80) and
            ``library_ms``: ``scaled_dot_product_attention`` with
            ``enable_gqa=True`` at the same shape (without a mask where
            causality alone hides keys), a yardstick the port never calls
            (null for softcap, which it cannot compute).
7. kernel_ssd — the SSD kernel against ``ref.ssd_ref``, each case
            printing the variant that ran (``tc`` or ``simt``, which the
            launcher picks from the dtype and shapes): mamba2-780m's
            prefill shape (B = 4, S = 2048, H = 48, P = 64, N = 128,
            chunk = 256, bf16, nonzero h0), zamba2-1.2b's (H = 64, N =
            64, the same otherwise), both again in f32 (``simt`` at a
            model's full width; its record's head case, an f32 case's
            bound split-TF32's with ``bound_fp32_ms``, the fp32 CUDA
            cores', beside it), the reference's grid and an
            odd head count (H = 5, P = 32, chunk 32) in f32 and bf16
            (``simt``), and tc's edges in bf16 (H 5, no h0, a ragged S,
            chunks 64 and 128, N 64, B x H below 132); y within 2e-5 of
            max|y| (1e-2 in bf16), the state at atol 2e-3 / rtol 1e-4; the
            same fields, ``library_ms`` null (no PyTorch call computes the
            scan), and for ``tc`` ``floor_ms``, the least time of this
            design's own traffic and tensor work.  Then tc's two kernels
            one at a time at mamba2-780m's shape against ``ref.ssd_states``
            and ``ref.ssd_outputs`` (``kernel_ssd_phases``).
8. glm4   — glm4-9b at full width and depth (40 layers, d_model 4096,
            bf16 weights from a seeded ``torch.Generator``): prefill 4 x
            2048 tokens, move the cache into a 2080-slot ring, 16
            ``decode_step``s with ``[B]`` positions; once with
            ``use_kernel="auto"`` (counts reset just before, flash launches
            must be 40 + 16 x 40: prefill_tc 40, decode_split 640, simt 0) and once with ``"ref"`` on the card, each
            after an untimed warm-up run at the same shapes.
            Logits agree within 6% of the largest logit; the share of
            greedy tokens that agree, wall seconds, tokens per second and
            peak memory are printed, and a ``torch.profiler`` trace of one
            more prefill and one more decode step with the kernels gives
            device busy time and the largest device ops.
9. mamba2 — the same for mamba2-780m (48 layers, d_model 1536); ssd
            launches must be 48 (one per layer, at prefill), all ``tc``.
8b. mixtral — the same for mixtral-8x7b at full width, 8 of its 32
            layers (one card holds 23.7 GB of them), batch 1 x 8192 (the
            4096-key window masks), a 8224-slot ring: flash ``prefill_tc``
            8, ``decode_split`` 128, ``simt`` 0.
8c. deepseek — deepseek-v2 at full width, 4 of its 60 layers (the dense
            first layer and 3 MoE layers, 26.6 GB), 2 x 2048, a 2080-slot
            ring: ``prefill_tc`` 4 (MLA's prefill), nothing else (MLA's
            decode is absorbed einsums).  In both MoE phases each run
            records its routing: a token whose experts differ between the
            kernel and the plain run must be a near-tie (``NEAR_TIE`` or
            twice the runs' own probability noise), and its rows are left
            out of the comparison (``routing_flips``, ``rows_flipped``).
            Launches are checked per arch against ``expected_launches``.
8d-8h. zamba2, minitron, gemma3, qwen2vl, hubert — the rest of the model
            stack at full width and depth, the same way: zamba2-1.2b (38
            layers: 32 Mamba2 and 6 sites of its one shared attention
            block, each with its own KV ring) 4 x 2048, ring 2080: ssd
            ``tc`` 32, ``prefill_tc`` 6 at (64, 64), ``decode_split`` 96;
            minitron-4b 4 x 2048: ``prefill_tc`` 32, ``decode_split`` 512;
            gemma3-27b, all 62 layers (54 GB of bf16 weights), 1 x 4096 so
            the 1024-key window masks, ring 4128: ``prefill_tc`` 62,
            ``decode_split`` 992; its seeded weights make the logits
            chaotic in bf16 (a plain run with one prompt embedding one
            bf16 step larger moves them as far as the kernels do, printed
            as ``plain_bumped_*``), so gemma3 is held layer by layer: each
            layer's prefill and decode output, and its attention term
            before the post-norm and the residual add, through the kernels
            within 6% of the plain one's largest value, from the same
            input (``compare: layerwise``); qwen2-vl-2b 4 x 2048 from ``embeds``, a
            32 x 32 patch image at t = 0 and then 1024 text positions
            (``[3, B, S]`` M-RoPE positions), 16 tokens decoded:
            ``prefill_tc`` 28, ``decode_split`` 448; hubert-xlarge, the
            encoder's forward over 4 x 2048 frame embeddings:
            ``prefill_tc`` 48 at (80, 80), frames/s.  ``simt`` 0 on each.
10. held  — all nine models at full width, 2 layers (6 for zamba2 and
            gemma3, which reach a shared site and a global layer there),
            64-token prompt and 4 decode steps (hubert: its forward;
            gemma3 also layer by layer), on ``cuda`` and on ``cpu``
            through the
            port, the same bf16 weights: logits within 6e-2 (atol and rtol,
            the CPU tests' bf16 tolerance against the reference), near-tie
            routing flips left out as above.  The CPU port is what the
            tests hold to JAX, so this ties the card to it.
10b. moe_routed — one full-width MoE layer of each MoE arch at 4096 and
            16 tokens: ``moe_apply`` (routed) against ``moe_ref`` (dense),
            within 2e-2 of max |y|; the rows routed to each expert, each
            path's time (CUDA events) and device operations per call.
10c. serve_real — ``launch.serve.serve_real`` at the reference launch's
            ``--backend real`` defaults (2 pods, 16 sessions, 64 requests
            of 4 tokens, locality 0.8, 256-slot rings, seed 0) on the card
            for mixtral-8x7b (8 layers), deepseek-v2 (4 layers) and
            zamba2-1.2b (all 38: a migrated session carries 32 Mamba
            states and 6 shared sites' K/V): every
            request decoded, every migrated column ``nbytes_session()``
            bytes and bitwise equal on the destination, ``decode_split``
            launches one a decode step per attention layer or shared site
            (deepseek: none); ms
            per engine step, decoded tokens/s, µs a migration.
10d. serve_real_held — the same loop at 2 layers (zamba2: 6), cut to
            32 of its 64 requests, on cuda and on cpu:
            engine metrics equal key for key but ``plan_block_s``, the
            first step's logits within 6e-2.

11. serve — the serving path of ``benchmarks/serve_locality.py``
            through the port's ``repro_torch.launch.serve.run_point`` (its
            recipe; the card's machine has no JAX) at its defaults:
            mixtral-8x7b's KV sizes, 8 pods, 256 sessions, 80 steps,
            every GRID (policy,
            arbitration) pair x localities {0.0, 0.5, 0.9} x seeds 0-2, on
            cuda and on cpu, identical (run_point's keys,
            ``EngineMetrics.as_dict()`` without the wall-clock
            ``plan_block_s``, the router's metrics).  Once at the
            certifier's default (batches below 8 settle on the host) and
            once with ``StepCertifier(jax_min=1)``: every certification
            batch through ``validate_batch``'s drain route, each a
            ``drain`` launch (W = 0, no class view), ``gather`` never;
            drains by launch plan, largest B and n_dirty.  Then the drain
            kernel at the serving shape against its twin
            (``kernel_drain`` lines ``serve_B*``).  ``tokens_per_s`` here
            is SimBackend's priced TPU pod, not the card's speed.
12. serve_plan — ``benchmarks/planner.py``'s sweep with the planner on
            (96 sessions, 160 steps, SERVE_PLAN_DEFAULTS, localities {0.0,
            0.7, 0.9}, seeds 0-2), async and sync plan epochs, cuda
            identical to cpu in each mode; planned moves at 0.9.  Then
            ``launch.serve.main`` with the planner on, cuda against cpu.
13. plan_score — the scorer at 2^17 classes x 16 nodes on the card,
            bitwise equal to ``score_moves_np``; sync, kick and harvest ms
            around host work as ``overlap_cell`` times them; the bound.
14. sim_plan — phase 4's TPC-C run with ``SimConfig.plan``
            (SIM_PLAN_DEFAULTS) on cuda and cpu: byte-identical, planner
            epochs and prefetches issued, every drain through ``drain``.

Runtime analysis (``repro_torch.analysis``) on the card:

15. main_sanitized — phase 4's run with ``sanitize=True`` on cuda:
            stores and metrics byte-identical to phase 4's cuda run, every
            drain through ``drain`` and checked by ``check_write_locks``
            against the lease layer's owners recomputed on the host (write
            slots checked), ``verify_full`` on every live replica, the
            device tables equal to the host versions; then on the cpu,
            with equal sanitizer counters and check counts.  ``run_s``
            sanitized beside the unsanitized run's.
16. forced_sanitized — phase 5's run cut to 600 of its 2000 simulated
            ms (node 3 still fails at 120 ms; a plain cuda run at that
            length is the one it is held to), the same way: every settle on the
            device ops and each ``enabled_mask`` verdict held to the
            sequential ``is_enabled`` (``enabled_checks``).  Phases 5 and
            16 print the settle's calls and host wall on both devices
            (``settle_ops_s``: ``ops.settle_lease_batch``, synchronised;
            ``settle_s``: the whole device-path settle with its copies).
17. serve_sanitized — phase 11's runs at ``jax_min`` 1 with
            ``sanitize=True`` on cuda, each equal to the unsanitized cuda
            run key for key; every forward the drain kernel passes checked
            at its session's owner (``owner_checked``).
18. explore — the explorer's smoke grid (``run_smoke``, the POR check
            included) on cuda and on cpu: violation-free, each cell's
            ExploreStats equal across the devices, runs/s on each.
19. explore_kernel — ``KERNEL_CELL``: smoke-bank batched/drain with
            ``jax_min`` 1, exhaustive (window 0.4 ms, 600 schedules), every
            drain of every schedule through ``drain`` and every settle on
            the device; ExploreStats equal to the cpu's; drain launches,
            per-drain wall, runs/s, staging areas made and alive.
20. mutants — all 12 mutants of ``MUTANT_INVARIANTS`` re-found on cuda
            with their invariants; and the drain kernel's two write-lock
            violations (a drain handed stale class owners; a verdict
            passing a write to a class leased elsewhere) named
            ``write-locks``.

Single-device training (``repro_torch.train``, ``launch.train``):

21. kernel_grad — the backward kernels through the autograd Functions
            at the training shapes, each case's backward variant as
            ``backward_variant()`` names it: attention at zamba2's (B 2,
            S 2048, H 32, D 64, causal, bf16), glm4's (128, 128) over GQA
            groups of 16 (the group split over ``dkdv_tc`` blocks),
            hubert's (80, 80) bidirectional, deepseek-v2's MLA (192, 128)
            at 1 x 1024 and at train_mla's 2 x 2048, 128 heads (its dK and
            dV from ``dkdv_tc2``'s two warpgroups; beside SDPA's backward,
            the backend it takes named, and the registers and spills of
            ``dkdv_tc2`` and ``dq_tc`` there) and a window of 512 with a
            softcap of 50 on ``tc`` (``flash_backward_tc.cuh``); zamba2's
            in f32 on ``simt`` (``flash_backward.cuh``, split-TF32; beside
            SDPA's backward and its backend, its bound split-TF32's with
            ``bwd_bound_fp32_ms``, the fp32 CUDA cores', beside); the SSD at
            zamba2's (H 64, N 64) and
            mamba2's (H 48, N 128), bf16, on ``tc``
            (``ssd_backward_tc.cuh``) and zamba2's in f32 on ``simt``
            (``ssd_backward.cuh``, split-TF32; its bound split-TF32's with
            the fp32 cores' beside), with h0 and the final state's
            gradient.  Each: one backward launch of its variant and no
            plain version called; the gradients within 2e-2 (bf16) or 2e-5
            / 1e-4 (f32, attention / SSD) of each input's largest, against
            the fp32 plain backward (``ref.sdpa_bwd_ref`` /
            ``ssd_bwd_ref``), against ``tc``'s plain twin
            (``ref.sdpa_bwd_tc_ref`` / ``ssd_bwd_tc_ref``) and against
            autograd of the plain forward (the f32 SSD: the kernel and both
            plain sides each against an fp64 evaluation of
            ``ssd_bwd_ref``, as dA's f32 evaluations differ from each
            other by up to the limit); two calls equal bits;
            attention's lse within 1e-4 of the plain one and the output's
            bits equal without it (both timed).  The backward's ms and
            device ms and its bound; beside a ``tc`` case the ``simt``
            kernels at the same shape (asked for by name); at zamba2's
            shapes also the plain backward's and the twin's, forward +
            backward against the old recompute
            (autograd of the plain forward) and, for attention,
            ``scaled_dot_product_attention``'s backward and forward +
            backward (a yardstick the port never calls).
22. train — ``launch.train.main`` at zamba2-1.2b's full width and depth
            (1.27 B parameters, fp32 masters and AdamW moments, bf16
            compute), 4 steps of 2 x 2048 tokens, counts reset just
            before; once with remat none and once with ``--remat full``.
            Every loss finite; per step 6 ``prefill_tc`` and 32 ``tc``
            launches (under full remat the 36 body layers' forwards run
            again in the backward: 12 and 62) and 6 flash and 32 SSD
            backward launches, every one ``tc``, no plain version called;
            step wall after the first,
            tokens/s, peak memory.
    train_profile — one more step under ``torch.profiler``: device busy,
            idle share, the largest device ops, the share of busy time in
            the Functions' backward kernels; a third step's host waits
            recorded (phase 30: none in the kernels' modules); then the
            step's gradients,
            every leaf finite and non-zero (the shared block's attention
            weights and every Mamba layer's ``w_in`` among them).
23. train_held — zamba2-1.2b at full width cut to 6 layers (one shared
            site), 1 x 2048 tokens: the train step's loss and gradients on
            the card (kernels) and on the CPU (plain versions) from the
            same fp32 masters; loss within 1e-2 relative, every gradient
            leaf's relative L2 error within 5e-2; on the card one backward
            launch a Function and no plain version called.
23b. train_mla — deepseek-v2-236b at full width cut to its first layer
            (MLA and the 12288-wide dense MLP: 1.39 B parameters, fp32
            masters), 4 steps of 2 x 2048 tokens through
            ``train_step.make_train_step`` (``launch.train`` has no depth
            flag): every loss finite; per step one ``prefill_tc<192,128>``
            with the lse and one ``flash_attention.backward.tc``, no other
            flash or SSD launch, no plain version called; step wall after
            the first, tokens/s, peak memory; one more step profiled:
            device busy, idle share, the MLA backward's device ms and its
            share of busy.
23c. train_mla_held — the same config at 1 x 512 tokens: loss and every
            gradient leaf on the card against the CPU, from the same
            masters and batch, as train_held holds zamba2's.

The mesh (``repro_torch.dist``, ``launch.mesh``; on one card a world of
one NCCL rank, whose collectives still run):

24. mesh_moe — one MoE layer of mixtral-8x7b and of deepseek-v2-236b at
            full width, 1 x 2048 tokens, through ``moe_sharded`` and
            ``moe_sharded_a2a`` at capacity factor 8 (nothing drops),
            each within 2e-2 of max |y| of the routed no-mesh
            ``moe_apply`` (near-tie rows left out; none expected); the
            time of a call and its host waits on the device on each
            path.  ``mesh_moe_gloo``: whether gloo
            takes CUDA tensors, and if it does the a2a path as 4 gloo
            ranks on the one card (mixtral at ep 4, tp 1; deepseek-v2's
            widths with 2 experts at ep 2, tp 2), held to the same oracle.
25. mesh_train — ``launch.train.main`` on the mesh (phase 22's run
            without ``--no-mesh``), 2 steps: its losses equal phase 22's
            first two within 1e-6 relative, the same launches a step; step
            wall and peak memory beside phase 22's.
26. mesh_decode — ``decode_split``'s log-sum-exp output against the
            plain version's (fp32, 2e-5) at glm4-9b's and gemma3-27b's
            decode shapes, f32 and bf16, with the output at its present
            tolerance, timed with and without it; then real-decode serving
            (SERVE_REAL) of zamba2-1.2b at 38 layers without a mesh, on
            the mesh ``launch.serve --seq-axis 1`` builds (no seq axis on
            a world of one) and on a (1, 1, 1) seq mesh (the decode over
            its ring's one chunk, merged by the log-sum-exp through an
            all-gather): the metrics of both mesh runs equal the
            meshless run's key for key, every decode through
            ``decode_split`` (the seq mesh's with the log-sum-exp); one
            decode step of 16 slots on each: host waits and ms.  Then
            deepseek-v2's MLA (its first layer, full width) takes steps of
            96 and 3 tokens into a latent cache on the seq mesh and
            without one: the seq mesh's expanded path runs
            ``prefill_tc<192,128>`` and then ``simt``, each with the rows'
            lse, and merges its one chunk; logits equal bit for bit
            (``mesh_decode_mla_multi``).
26b. mesh_tp — the dense stack tensor-parallel over 4 gloo ranks that
            share the card, a (1, 4) mesh (NCCL takes one rank a card):
            glm4-9b at full width and depth in bf16 (8 of its 32 q heads
            a rank, its 2 kv heads gathered), 1 x 2048 then 8 decode
            steps into a 2080-slot ring, and zamba2-1.2b (its Mamba heads
            split, 2 x 2048 then 4 steps); each rank's blocks drawn with
            ``init_params(mesh=)``.  Per rank: parameter bytes against its
            local shapes' sum (and the whole tree's), peak memory, the
            kernels' launches, the collectives by op, and the first
            ``prefill_tc``, ``decode_split`` and ``ssd_scan.tc`` calls
            held to their plain versions on the same inputs at the
            rank's shapes (as phase 28 holds them); rank 0's logits held
            to the single-device run of the same seed within 6% of the
            largest logit, beside the same gap with the plain versions
            on both sides and the single device's kernels against its
            plain versions.  Walls are recorded; no speed is claimed
            (the ranks share the SMs).

The batched sweep, the analytic estimates and the examples (after the mesh
phases' process group is gone), then the dry run:

26d. mesh_mla_seq — the MLA steps of phase 26 (96 then 3 tokens) into a
            256-slot latent cache cut over 4 gloo ranks that share the
            card, a (1, 4, 1) seq mesh: each rank's chunk through
            ``prefill_tc<192,128>`` and then ``simt`` with the rows' lse,
            the four chunks merged; ranks whose chunk a row cannot see
            write a lse at most NEG_INF / 2 there, weight 0 in the merge
            (both kernels, checked);
            rank 0's logits within 6% of the largest logit of the same
            steps without a mesh.
27. vec_sim — ``core.vec_sim`` over the grid of ``benchmarks/run.py``'s
            sweep (localities 0, 0.3, 0.6, 0.9, 1.0 x 4 seeds x ALC~, FGL~,
            LILAC~) and a wide grid (101 localities x 64 seeds x the 3
            variants: 19,392 points), 512 rounds, 4 nodes, 64 classes, each
            on cuda and on cpu from the same host draws: every point's
            totals and the means bit-equal; wall and points/s a device;
            then the four trends of tests/test_jax_sim.py on the card.
28. estimates_anchor — ``launch.estimates`` against real steps at full
            width and depth on the kernels, the grid's shapes with the batch
            cut through ``input_specs(batch_override=)``: glm4-9b
            ``prefill_32k`` at batch 1 (``prefill_tc<128,128>`` at S =
            32768), glm4-9b ``decode_32k`` at batch 16 (a 32768-slot ring
            filled at init, 21.5 GB of KV beside 18.8 GB of weights; 6 steps
            at position 32767, ``decode_split`` over the whole ring) and
            mamba2-780m ``prefill_32k`` at batch 4 (``ssd_scan.tc`` at S =
            32768).  Each: peak memory against ``estimate(..., n_chips=1,
            tp=1, param_bytes=2).residency_bytes``, the step's time against
            ``roofline_terms`` of 2·N·D (``model_flops`` / 3, as the
            reference's dry run takes an inference step) and the estimate's
            traffic, as a share of that bound, and of a bound that adds
            attention's own FLOPs; one more step under ``torch.profiler``;
            launches checked.  Each kernel's call in the first layer of the
            untimed run is held to its plain version on the same inputs:
            ``prefill_tc`` on its first 256 and last 512 query rows against
            all 32768 keys, ``decode_split`` on every row over the whole
            ring, ``ssd_scan.tc`` at 4 x 32768 (128 chunks; y and the final
            state, batch row by batch row).
29. examples — ``examples/torch/{quickstart,serve_migration,train_100m,
            failover_recovery}.py`` as subprocesses on the card, all at
            once (each with every kernel count at 0, printing its counts
            after; train_100m cut to 100 of its 300 steps), beside
            quickstart's part 1 on ``--device cpu``: each exits 0 and
            part 1 prints the same lines on both devices.
26c. dryrun — ``launch.dryrun``'s counting pass on the host, in a
            subprocess started beside phase 29 (which claims no time):
            ``count_serve`` of the mesh_tp cells on a fake (1, 4) mesh,
            whose collective records must equal the
            ranks' (its predicted peak a rank beside theirs), the three
            anchors of phase 28 on a mesh of one (predicted peaks beside
            the measured ones) and glm4-9b ``train_4k`` on pod16x16 with
            its host seconds.
30. lint — ``python -m repro_torch.analysis.lint --no-baseline`` over
            ``src/repro_torch`` in a process of its own: exit code 0, 8
            rules, 0 violations, the allows by rule, host seconds.  Then
            the host's waits on the card recorded above (``sync_sites``:
            PyTorch's sync debug mode, the innermost frame of the port at
            each warning) in one call each of: glm4-9b's, mixtral's and
            deepseek-v2's prefill and decode step, mamba2's prefill,
            zamba2's and gemma3's decode step (phases 8-8h), one engine
            step of each serve_real arch, one device settle and one drain
            of the forced run (phase 5), one certifier drain through the
            kernel (phase 11, ``jax_min`` 1) and one scoring with its
            harvest (phase 13): the sites by call with their counts, and
            the lines ``host-sync`` flags that ran in a call without a
            wait there (``flagged_quiet``).  A site that is not a line
            ``host-sync`` flags fails the run.  A wait inside a ctypes
            library (the drain's) warns under neither.

The last three lines are the ``nvidia-smi`` line, the kernels record (one
entry per lease_validate, flash and SSD variant; ``lease_validate.drain``
and each flash variant count their launches on every path that reaches
them, by path in ``launches_by_path``: the runtime-analysis paths 15, 16,
17 and 19 for the drain, the model phases 8-9, 8b-8h, serve_real, the
train phases and the mesh phases 25-26b for flash, mamba2, zamba2, the
train phases and phases 25, 26b for the SSD (26b's counts summed over its
four ranks); phases 28-29 add
``anchor_*`` and ``examples_*`` paths to every kernel that counts by path,
zeros included; ``decode_split`` also ``lse_launches`` and the ``lse``
cases of phase 26; one entry per backward kernel and variant
(``flash_attention.backward.tc`` / ``.simt``, ``ssd_scan.backward.tc`` /
``.simt``), both timed at phase 21's zamba2 case (``simt`` asked for by
name there), its launches by training path: train, train_remat_full,
train_held, train_mla, train_mla_held, mesh_train and
examples_train_100m), and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor-core fp32 rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS_PER_S = 495e12      # H100 SXM dense TF32 tensor-core rate
# f32 work the least time it could take on the card: split-TF32, three
# TF32 products for each fp32 one (~22 of fp32's 24 bits, as the simt
# kernels and PyTorch's memory-efficient SDPA for float take it)
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
VALID_POS_LIMIT = 2 ** 29      # kv positions at or above it are padding
MODEL_TOL = 0.06               # auto vs ref logits, share of max |logit|
# flash kernel against ref.sdpa_ref: f32 at the reference's 2e-5; bf16 at
# two bf16 ulps (2^-6 of the value) plus 1e-3.  Both sides compute in fp32
# from the same bf16 inputs and round the output once: decode_split and
# simt keep fp32 throughout, prefill_tc runs P.V on P's bf16 hi + lo parts
# (~16 bits of P; a single bf16 P misses this limit in early causal rows)
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 1.6e-2)}
HELD_TOL = 6e-2                # cuda vs cpu logits, atol and rtol
MOE_TOL = 2e-2                 # routed vs dense MoE, share of max |y|
# bf16 keeps 8 significant bits: two router probabilities closer than this
# (or than twice the largest change the two runs show on the rows that
# routed alike) can change order between two runs that round differently
# (kernel and plain attention, the card and the CPU).  Such a token takes
# another expert; its compared rows are left out, and a flip at a wider
# gap fails
NEAR_TIE = 1e-2

# TPC-C Standard Specification rev. 5.11, clause 1.2 / 4.3.3.1
TPCC_SPEC = dict(n_customers=30000, n_stock=100000, n_catalog=100000)


def ptxas_kernels(info: dict, marker: str) -> list:
    """Registers and spill bytes of each entry function whose mangled
    name holds ``marker``, from a library's ``ptxas -v`` lines; ``dims``
    are the integer template arguments, ``dtype`` a leading element type
    (float or bf16) where the template has one."""
    out, cur = [], None
    for ln in info.get("ptxas", []):
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.search(rf"{marker}I(f|13__nv_bfloat16)?((?:Li\d+E)*)E",
                             m.group(1))
            cur = None if args is None else dict(
                dims=[int(x) for x in re.findall(r"Li(\d+)E", args[2])])
            if cur is not None and args[1]:
                cur["dtype"] = "float32" if args[1] == "f" else "bfloat16"
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# the SSD simt kernels (split-TF32 mma.sync): marker -> instantiations
SSD_SIMT_KERNELS = {"4simt12state_kernel": 2, "4simt12chunk_kernel": 2,
                    "8backward10own_kernel": 4, "8backward12chunk_kernel": 4}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph
    and replayed, so the host's launch cost drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


# -- phase 3: kernel against its plain version -------------------------------

def make_inputs(rng: np.random.Generator, n: int, b: int, r: int, w: int,
                *, lock_frac: float = 0.05, stale_frac: float = 0.02,
                empty_rows: int = 1, lock_free: bool = False):
    """Certification inputs shaped like a drain: -1-padded rows of varying
    length, a few all-padded rows, ~2% stale reads and ~5% locked items."""
    store = rng.integers(0, 1 << 20, n).astype(np.int32)
    locks = (rng.random(n) < lock_frac).astype(np.int32)
    items = rng.integers(0, n, (b, r)).astype(np.int32)
    lens = rng.integers(1, r + 1, b)
    lens[:empty_rows] = 0
    items[np.arange(r)[None, :] >= lens[:, None]] = -1
    vers = store[np.maximum(items, 0)]
    stale = rng.random((b, r)) < stale_frac
    vers = np.where(stale, vers + 1, vers).astype(np.int32)
    if lock_free:
        witems = np.full((b, 1), -1, np.int32)
    else:
        witems = rng.integers(0, n, (b, w)).astype(np.int32)
        wlens = rng.integers(1, w + 1, b)
        wlens[:empty_rows] = 0
        witems[np.arange(w)[None, :] >= wlens[:, None]] = -1
    return store, items, vers, locks, witems


def bound_ms(items: np.ndarray, witems: np.ndarray) -> tuple:
    """Least time for the work: each row input read once, each distinct
    gathered table entry once, the output once; compares at the scalar
    rate.  Returns (ms, "bytes" | "operations")."""
    b = items.shape[0]
    distinct = np.unique(items[items >= 0]).size \
        + np.unique(witems[witems >= 0]).size
    n_bytes = 4 * (2 * items.size + witems.size) + 4 * distinct + b
    n_ops = int((items >= 0).sum() + (witems >= 0).sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_case(name: str, rng, n, b, r, w, iters: int, **kw) -> dict:
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref
    from repro_torch.kernels.lease_validate import lease_validate

    launches_before = lv.launches
    host = make_inputs(rng, n, b, r, w, **kw)
    store, items, vers, locks, witems = (torch.from_numpy(a).cuda()
                                         for a in host)
    ok = lease_validate(store, items, vers, locks, witems)
    torch.cuda.synchronize()
    locks_bool = locks > 0
    want = ref.lease_validate_ref(store, items, vers, locks_bool, witems)
    err = int((ok.to(torch.int32) - want.to(torch.int32)).abs().max())
    check(torch.equal(ok, want), f"{name}: kernel disagrees with "
          f"ref.lease_validate_ref ({int((ok != want).sum())} rows)")
    kernel = lambda: lease_validate(store, items, vers, locks, witems)
    plain = lambda: ref.lease_validate_ref(store, items, vers, locks_bool,
                                           witems)
    bms, by = bound_ms(host[1], host[4])
    # the design's floor: an empty kernel through the same ctypes launch
    empty = lambda: lv.empty_validate(store.device)
    out = dict(case=name, n_items=n, B=b, R=r, W=int(witems.shape[1]),
               passing=int(ok.sum()), max_abs_err=err,
               ms=time_ms(kernel, iters), plain_ms=time_ms(plain, iters),
               graph_ms=graph_ms(kernel), plain_graph_ms=graph_ms(plain),
               floor_ms=time_ms(empty, iters), floor_graph_ms=graph_ms(empty),
               bound_ms=bms, bound_by=by,
               launches=lv.launches - launches_before)
    emit("kernel", **out)
    return out


# -- phase 3b: the drain variant, and a certification drain's routes --------

def tpcc_item_classes() -> tuple:
    """TPC-C's item -> class map at the specification's cardinalities, as
    the cluster builds it: (item_cc int32 [1,140,088], n_classes)."""
    import repro_torch.core as T

    lay = T.TpccLayout(n_nodes=4, **TPCC_SPEC)
    ccmap = T.TpccConflictMap(lay)
    item_cc = np.fromiter((ccmap.of_item(i) for i in range(lay.n_items)),
                          np.int32, count=lay.n_items)
    return item_cc, ccmap.n_classes


def drain_inputs(rng, n, b, r, w, n_classes, n_dirty) -> dict:
    """One drain shaped like the main path's: make_inputs' rows, n_dirty
    written items (repeats allowed) some of which the rows read, each at
    its new version or the one before the flush, and class owners split
    between unowned, this node (1) and another."""
    table, items, vers, _, witems = make_inputs(rng, n, b, r, w)
    dirty = rng.integers(0, n, n_dirty).astype(np.int32)
    versions = table.copy()
    versions[dirty] = rng.integers(1 << 20, 1 << 21, n_dirty)
    hit = (items >= 0) & (rng.random(items.shape) < 0.1)
    items[hit] = dirty[rng.integers(0, n_dirty, int(hit.sum()))]
    slot = np.maximum(items, 0)
    fresh = rng.random(items.shape) < 0.8
    vers = np.where(hit, np.where(fresh, versions[slot], table[slot]),
                    vers).astype(np.int32)
    owners = rng.choice(np.array([-1, 1, 2], np.int32), n_classes,
                        p=[0.5, 0.45, 0.05])
    return dict(table=table, dirty_idx=dirty, dirty_ver=versions[dirty],
                owners=owners, node=1, read_items=items,
                read_versions=vers, write_items=witems)


def stage(staging, case: dict) -> None:
    b, r = case["read_items"].shape
    v = staging.begin(case["dirty_idx"].size, b, r,
                      case["write_items"].shape[1], case["owners"].size,
                      case["node"])
    for name in ("dirty_idx", "dirty_ver", "owners", "read_items",
                 "read_versions", "write_items"):
        getattr(v, name)[:] = case[name]


def drain_bound_ms(case: dict) -> tuple:
    """Least time for a drain's work: each input read once (dirty pairs,
    owners, rows), each distinct table entry and item class gathered once,
    each distinct dirty item written once, ok written once; one compare a
    slot at the scalar rate.  Returns (ms, "bytes" | "operations")."""
    items, witems = case["read_items"], case["write_items"]
    n_bytes = (8 * case["dirty_idx"].size + 4 * case["owners"].size
               + 4 * (2 * items.size + witems.size)
               + 4 * np.unique(items[items >= 0]).size
               + 4 * np.unique(witems[witems >= 0]).size
               + 4 * np.unique(case["dirty_idx"]).size + items.shape[0])
    n_ops = int((items >= 0).sum() + (witems >= 0).sum()
                + case["dirty_idx"].size)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wall_us(fn, iters: int, warmup: int = 50) -> float:
    """Mean host wall per call of ``fn``, which waits for its own work."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def drain_case(name: str, rng, n, b, r, w, item_cc, n_classes,
               n_dirty) -> dict:
    """The drain kernel against ``ref.lease_drain_ref`` on the card,
    bitwise on ok and on the flushed table; then the per-call wall (launch
    + wait), the device time (CUDA-graph replay without the wait), the
    plain version and the bound."""
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    case = drain_inputs(rng, n, b, r, w, n_classes, n_dirty)
    cc = torch.from_numpy(item_cc).to(dev)
    staging = lv.DrainStaging(dev)
    stage(staging, case)
    on = {k: torch.from_numpy(case[k]).to(dev) for k in (
        "dirty_idx", "dirty_ver", "owners", "read_items", "read_versions",
        "write_items")}
    want_table = torch.from_numpy(case["table"]).to(dev)
    want = ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], cc, on["owners"],
        case["node"], on["read_items"], on["read_versions"],
        on["write_items"]).cpu().numpy()
    table = torch.from_numpy(case["table"]).to(dev)
    got = lv.lease_drain(table, staging, cc).copy()
    err = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
    check(np.array_equal(got, want), f"{name}: drain disagrees with "
          f"ref.lease_drain_ref on ok ({int((got != want).sum())} rows)")
    check(torch.equal(table, want_table), f"{name}: drain flushed another "
          f"table than ref.lease_drain_ref")
    # the same drain again and again: re-flushing equal pairs is idempotent
    kernel = lambda: lv.lease_drain(table, staging, cc)
    plain = lambda: ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], cc, on["owners"],
        case["node"], on["read_items"], on["read_versions"],
        on["write_items"])
    bms, by = drain_bound_ms(case)
    before = lv.launches
    out = dict(case=name, n_items=n, B=b, R=r, W=w, n_classes=n_classes,
               n_dirty=n_dirty, passing=int(want.sum()), max_abs_err=err,
               ms=wall_us(kernel, 2000) / 1e3,
               graph_ms=graph_ms(lambda: lv.lease_drain(
                   table, staging, cc, wait=False)),
               plain_ms=time_ms(plain, 500),
               plain_graph_ms=graph_ms(plain), bound_ms=bms, bound_by=by,
               library_ms=None, calls=lv.launches - before)
    emit("kernel_drain", **out)
    return out


def device_ops(prof) -> list:
    """The averaged device operations of a ``torch.profiler`` run: kernels,
    copies and fills.  The device-side copy of each host range (a
    ``gpu_user_annotation``, such as the model path's ``repro.*`` ranges)
    is left out: its time is the span of the kernels under it, which are
    counted themselves."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def device_ops_per_call(fn, calls: int = 20) -> dict:
    """Device operations (kernels, copies, fills) per call of ``fn`` under
    ``torch.profiler``, by name, and their device time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in device_ops(prof)]
    return dict(ops_per_call=sum(c for _, c, _ in rows) / calls,
                device_us_per_call=sum(t for _, _, t in rows) / calls,
                ops={k[:70]: c / calls for k, c, _ in rows})


def drain_routes(rng, item_cc, n_classes, b: int, drains: int, *,
                 profile: bool = False) -> dict:
    """Per-drain host wall of a whole certification drain as the cluster
    calls it, at the main path's shapes (TPC-C's items and class map, B
    transactions of up to 32 reads and 16 writes, the previous drain's
    writes pending), for four routes on the same drains in turns:

    - ``per_item``: the route before the drain variant: per-item locks
      derived on the card from the class owners (``Cluster._write_locks``
      as it was, int64 item -> class), then ``validate_batch(locks=...)``
      (``device_versions`` flush, pageable copies, ``gather``, ``.cpu()``);
    - ``drain``: ``validate_batch(class_locks=...)``, one launch and wait;
    - ``floor``: an empty kernel through the same ctypes launch and wait;
    - ``cpu``: ``validate_batch(class_locks=...)`` on a CPU store (the twin).

    With ``profile``, instead: the device operations per drain of the two
    card routes under ``torch.profiler`` (run after the cluster phases: a
    profiler session may leave its tracing hooks behind).
    """
    import torch

    from repro_torch.core import stm
    from repro_torch.kernels import lease_validate as lv

    dev = torch.device("cuda")
    n = item_cc.size
    stores = {k: stm.VersionedStore(n, device=d)
              for k, d in (("per_item", "cuda"), ("drain", "cuda"),
                           ("cpu", "cpu"))}
    cc64 = torch.from_numpy(item_cc.astype(np.int64)).to(dev)
    cc32 = torch.from_numpy(item_cc).to(dev)
    cc_cpu = torch.from_numpy(item_cc)
    node = 1
    owners = rng.choice(np.array([-1, 1, 2], np.int32), n_classes,
                        p=[0.5, 0.45, 0.05])

    def txns_for(store):
        out = []
        for k in range(b):
            t = stm.Transaction(txid=k + 1, origin=0)
            for item in rng.integers(0, n, int(rng.integers(1, 33))):
                t.log_read(int(item), int(store.versions[item]))
            for item in rng.integers(0, n, int(rng.integers(1, 17))):
                t.write_set[int(item)] = 1.0
            out.append(t)
        return out

    def per_item(store, txns):
        owners_dev = torch.from_numpy(owners).to(dev)
        owner = owners_dev[cc64]
        locks = ((owner >= 0) & (owner != node)).to(torch.int32)
        return stm.validate_batch(store, txns, locks=locks)

    routes = {
        "per_item": per_item,
        "drain": lambda store, txns: stm.validate_batch(
            store, txns, class_locks=stm.ClassLocks(cc32, owners, node)),
        "cpu": lambda store, txns: stm.validate_batch(
            store, txns, class_locks=stm.ClassLocks(cc_cpu, owners, node)),
    }
    if profile:
        out = {}
        for k in ("per_item", "drain"):
            def one(k=k):
                txns = txns_for(stores[k])
                stores[k].apply_batch([t.write_set for t in txns],
                                      [len(txns)] * len(txns))
                routes[k](stores[k], txns)
            out[k] = device_ops_per_call(one)
        emit("kernel_drain_ops", B=b, **out)
        return out
    walls = {k: [] for k in ("per_item", "drain", "floor", "cpu")}
    version = 1
    for i in range(drains):
        # the same transactions and the same pending writes for each route
        txns = txns_for(stores["drain"])
        writes = [t.write_set for t in txns]
        version += 1
        for store in stores.values():
            store.apply_batch(writes, [version] * len(writes))
        verdicts = []
        for k in ("per_item", "drain", "floor", "cpu"):
            t0 = time.perf_counter()
            if k == "floor":
                lv.empty_drain(dev)
            else:
                verdicts.append(routes[k](stores[k], txns))
            walls[k].append((time.perf_counter() - t0) * 1e6)
        check(all(np.array_equal(verdicts[0], v) for v in verdicts),
              f"drain routes disagree at B={b}, drain {i}")
    for k, store in stores.items():
        check(np.array_equal(store.device_versions().cpu().numpy(),
                             store.versions.astype(np.int32)),
              f"{k} route's device table differs from its host versions")
    warm = 20
    out = dict(B=b, drains=drains - warm, **{
        f"{k}_us": float(np.mean(v[warm:])) for k, v in walls.items()},
        **{f"{k}_median_us": float(np.median(v[warm:]))
           for k, v in walls.items()})
    emit("kernel_drain", routes=True, **out)
    return out


def kernel_drain_phase() -> tuple:
    """The drain at the main path's shapes: bitwise against its twin and
    timed (``drain_case``), then the four routes per drain.  Returns the
    cases and TPC-C's class map (for ``drain_routes(profile=True)``)."""
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    item_cc, n_classes = tpcc_item_classes()
    n = item_cc.size
    emit("kernel_drain", tpcc_map_s=time.perf_counter() - t0, n_items=n,
         n_classes=n_classes)
    cases = [drain_case(f"main_B{b}", rng, n, b, 32, 16, item_cc, n_classes,
                        b * 16) for b in (8, 16)]
    for b in (8, 16):
        drain_routes(rng, item_cc, n_classes, b, 320)
    return cases, item_cc, n_classes


# -- phases 4-5: the simulator on cuda and on cpu ----------------------------

class DrainStats:
    """The batched drains one path makes through ``module.validate_batch``
    while the ``with`` block runs: transactions and drains, the wall inside
    the calls, the drains by launch plan (``variant()``'s, from the packed
    (B, n_dirty); the wrapper raises if the launcher took another) and the
    largest B and n_dirty."""

    def __init__(self, module) -> None:
        self.module = module
        self.txns = self.drains = 0
        self.validate_s = 0.0
        self.plans = {"one_cta": 0, "cluster": 0, "two_launches": 0}
        self.largest = {"B": 0, "n_dirty": 0}

    def __enter__(self):
        from repro_torch.kernels import lease_validate as lv

        plain = self.plain = self.module.validate_batch

        def counting(store, txns, *args, **kw):
            self.txns += len(txns)
            self.drains += 1
            t = time.perf_counter()
            try:
                ok = plain(store, txns, *args, **kw)
            finally:
                self.validate_s += time.perf_counter() - t
            n_dirty, b = store.staging.counts
            _, ctas, kernels = lv.variant(b, n_dirty, per_item_locks=False)
            self.plans["one_cta" if ctas == 1 else "cluster" if kernels == 1
                       else "two_launches"] += 1
            self.largest.update(B=max(self.largest["B"], b),
                                n_dirty=max(self.largest["n_dirty"], n_dirty))
            return ok

        self.module.validate_batch = counting
        return self

    def __exit__(self, *exc) -> None:
        self.module.validate_batch = self.plain


class SettleStats:
    """The lease settles one path makes through the device ops while the
    ``with`` block runs: calls, the host wall of ``ops.settle_lease_batch``
    (synchronised on the card, so it holds the ops' device work) and of
    the whole device-path ``ShardedLeaseManager.settle`` (packing, the
    copies in and the copy out included)."""

    def __init__(self) -> None:
        self.calls = 0
        self.ops_s = self.settle_s = 0.0

    def __enter__(self):
        import torch

        from repro_torch.core import lease_batched as lb
        from repro_torch.kernels import ops

        ops_plain = self.ops_plain = ops.settle_lease_batch
        settle_plain = self.settle_plain = lb.ShardedLeaseManager.settle

        def ops_timed(*args, **kw):
            t = time.perf_counter()
            out = ops_plain(*args, **kw)
            if out[0].device.type == "cuda":
                torch.cuda.synchronize(out[0].device)
            self.ops_s += time.perf_counter() - t
            self.calls += 1
            return out

        def settle_timed(mgr, *args, use_kernel=False, **kw):
            t = time.perf_counter()
            try:
                return settle_plain(mgr, *args, use_kernel=use_kernel, **kw)
            finally:
                if use_kernel:
                    self.settle_s += time.perf_counter() - t

        ops.settle_lease_batch = ops_timed
        lb.ShardedLeaseManager.settle = settle_timed
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.core import lease_batched as lb
        from repro_torch.kernels import ops

        ops.settle_lease_batch = self.ops_plain
        lb.ShardedLeaseManager.settle = self.settle_plain

    def as_dict(self) -> dict:
        return dict(settle_calls=self.calls, settle_ops_s=self.ops_s,
                    settle_s=self.settle_s)


class SanitizerStats:
    """What the sanitizer checks while the ``with`` block runs: the write
    slots ``check_write_locks`` checks (and its calls, by the form of the
    lock input), and the groups whose ``enabled_mask`` verdicts (from the
    device settle at ``lease_jax_min`` 1) it holds to sequential
    ``is_enabled``."""

    def __init__(self) -> None:
        self.calls = self.class_views = self.write_slots = 0
        self.enabled_checks = 0

    def __enter__(self):
        import repro_torch.analysis.sanitizer as san
        from repro_torch.core.stm import ClassLocks

        cwl = self.cwl_plain = san.check_write_locks
        mask = self.mask_plain = san.LeaseSanitizer.enabled_mask

        def counting_cwl(node, owners, item_cc, locks, txns, verdicts):
            n = cwl(node, owners, item_cc, locks, txns, verdicts)
            self.calls += 1
            self.class_views += isinstance(locks, ClassLocks)
            self.write_slots += n
            return n

        def counting_mask(lm, groups):
            out = mask(lm, groups)
            if getattr(lm.inner, "settle", None) is not None:
                self.enabled_checks += len(groups)
            return out

        san.check_write_locks = counting_cwl
        san.LeaseSanitizer.enabled_mask = counting_mask
        return self

    def __exit__(self, *exc) -> None:
        import repro_torch.analysis.sanitizer as san

        san.check_write_locks = self.cwl_plain
        san.LeaseSanitizer.enabled_mask = self.mask_plain

    def as_dict(self) -> dict:
        return dict(check_write_locks_calls=self.calls,
                    class_view_calls=self.class_views,
                    write_slots_checked=self.write_slots,
                    enabled_checks=self.enabled_checks)


def reset_launches() -> None:
    """Every kernel count to 0: just before a path is driven."""
    from repro_torch.kernels import lease_validate as lv

    lv.launches = 0
    lv.variant_launches.update(gather=0, drain=0)


def lease_launches() -> dict:
    from repro_torch.kernels import lease_validate as lv

    return dict(lv.variant_launches, all=lv.launches)


def run_cluster(workload: str, device: str, cfg_kw: dict, fail_at=None):
    import torch

    import repro_torch.core as T
    import repro_torch.core.cluster as cluster_mod

    if workload == "tpcc":
        lay = T.TpccLayout(n_nodes=4, **TPCC_SPEC)
        ccmap = T.TpccConflictMap(lay)
        cfg = T.SimConfig(n_items=lay.n_items, n_classes=ccmap.n_classes,
                          device=device, **cfg_kw)
        wl = T.TpccWorkload(lay)
    else:
        ccmap = None
        cfg = T.SimConfig(device=device, **cfg_kw)
        wl = T.BankWorkload(n_nodes=cfg.n_nodes, n_items=cfg.n_items)
    t0 = time.perf_counter()
    c = T.make_cluster("LILAC-TM-ST", wl, cfg, ccmap=ccmap)
    if fail_at is not None:
        c.events.schedule(fail_at, lambda: c.gcs.fail(3))
    t1 = time.perf_counter()
    reset_launches()                    # just before the path
    with DrainStats(cluster_mod) as stats, SettleStats() as settles, \
            SanitizerStats() as checks:
        m = c.run()
        if device == "cuda":
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = lease_launches()
    for r in c.replicas:
        mirror = r.store.device_versions().cpu().numpy()
        check(np.array_equal(mirror, r.store.versions.astype(np.int32)),
              f"{workload}/{device}: device version table of replica "
              f"{r.node} differs from its host versions")
    state = [(r.store.values.tobytes(), r.store.versions.tobytes())
             for r in c.replicas]
    out = dict(metrics=dataclasses.asdict(m), state=state,
               kernel_txns=stats.txns, kernel_drains=stats.drains,
               validate_s=stats.validate_s, launches=launches,
               drain_plans=stats.plans, largest=stats.largest,
               build_s=t1 - t0, run_s=t2 - t1, n_items=cfg.n_items,
               settle=settles.as_dict())
    if cfg.sanitize:
        # Cluster.run already reconciled every live replica; once more here
        # so the line can say how many were verified
        live = [r for r in c.replicas if c.gcs.alive(r.node)]
        for r in live:
            r.lm.verify_full()
        out.update(sanitizer=[r.lm.counters() for r in c.replicas],
                   verified_replicas=len(live), **checks.as_dict())
    return out


def compare_runs(phase: str, on_card: dict, on_cpu: dict,
                 what: str = "cuda and cpu") -> None:
    check(on_card["state"] == on_cpu["state"],
          f"{phase}: replica stores differ between {what}")
    check(on_card["metrics"] == on_cpu["metrics"],
          f"{phase}: metrics differ between {what}")


def summary(run: dict) -> dict:
    m = run["metrics"]
    return dict(n_items=run["n_items"], commits=m["commits"],
                aborts=m["aborts"], forwards=m["forwards"],
                cert_batches=m["cert_batches"],
                kernel_launches=run["launches"]["all"],
                variant_launches={k: v for k, v in run["launches"].items()
                                  if k != "all"},
                kernel_drains=run["kernel_drains"],
                kernel_txns=run["kernel_txns"], drain_plans=run["drain_plans"],
                largest_B=run["largest"]["B"],
                largest_n_dirty=run["largest"]["n_dirty"],
                build_s=run["build_s"], run_s=run["run_s"],
                validate_s=run["validate_s"], **run["settle"])


def check_drains(phase: str, run: dict) -> None:
    """Every batched drain of the card run launched ``drain``, once."""
    n = run["launches"]
    check(n["drain"] > 0, f"{phase} path never launched lease_validate")
    check(n["drain"] == run["kernel_drains"] == n["all"],
          f"{phase}: {n['drain']} drain launches for "
          f"{run['kernel_drains']} batched drains ({n['all']} in all)")
    check(n["gather"] == 0, f"{phase}: gather launched {n['gather']} times")
    check(sum(run["drain_plans"].values()) == run["kernel_drains"],
          f"{phase}: drain plans {run['drain_plans']} do not add up to "
          f"{run['kernel_drains']} drains")


# -- phases 6-7: the model kernels against their plain versions --------------

def timings(fn, budget_ms: float = 300.0) -> tuple:
    """(ms per call by CUDA events, device ms per call by CUDA-graph
    replay, calls), the call count sized to the budget from one timed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    n = int(min(200, max(3, budget_ms / max(one, 1e-3))))
    return time_ms(fn, n, warmup=2), graph_ms(fn, launches=n, replays=3), n


def op_bound(flops: float, n_bytes: float, flops_per_s: float) -> tuple:
    """Least time for the work: (ms, "operations" | "bytes")."""
    t_ops = flops / flops_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_case(name: str, b, sq, skv, hq, hkv, dk, dv, *, causal=True,
               window=None, cap=0.0, dtype="bfloat16", decode=False,
               valid0=None, copies=1, lse=False, seed=0) -> dict:
    """One shape through ``ops.attention`` on the card, held to
    ``ref.sdpa_ref``.  ``valid0``: in a decode case row 0's valid length,
    in a prefill case the first padding key.  ``copies`` > 1 times the
    calls over that many distinct q/k/v sets in rotation, so L2 (50 MB) is
    cold as it is for a model's layers; the first set is also timed alone
    (``*_warm``).  ``lse`` asks for the rows' log-sum-exp too (held within
    GRAD_LSE_TOL of the plain one; the output's bits as without it).  An f32
    case's bound is split-TF32's (``bound_fp32_ms`` beside it: the fp32
    CUDA cores'), and it names the backend SDPA takes (read from the
    autograd graph of an output that needs a gradient)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(td)
                  for shape in ((b, sq, hq, dk), (b, skv, hkv, dk),
                                (b, skv, hkv, dv)))
            for _ in range(copies)]
    q, k, v = sets[0]
    kp = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv)
    if decode:   # per-row valid lengths; the ring's unwritten tail at 2^30
        valid = torch.randint(skv // 2, skv + 1, (b,), generator=gen,
                              device=dev)
        if valid0 is not None:
            valid[0] = valid0
        qp = (valid - 1).to(torch.int32)[:, None].contiguous()
        kp = torch.where(kp < valid[:, None], kp, torch.full_like(kp, 2 ** 30))
    else:
        qp = torch.arange(skv - sq, skv, dtype=torch.int32,
                          device=dev).expand(b, sq).contiguous()
        if valid0 is not None:   # the keys from valid0 on are padding
            kp = torch.where(kp < valid0, kp, torch.full_like(kp, 2 ** 30))
    kp = kp.contiguous()
    kw = dict(q_positions=qp, kv_positions=kp, causal=causal,
              sliding_window=window, logit_softcap=cap)
    variant = fa.variant(td, sq, hq, hkv, dk, dv)
    before, by_variant = fa.launches, dict(fa.variant_launches)
    out = ops.attention(q, k, v, return_lse=lse, **kw)
    torch.cuda.synchronize()
    by_variant[variant] += 1
    check(fa.launches == before + 1 and fa.variant_launches == by_variant,
          f"{name}: flash kernel variant {variant} did not launch")
    lse_fields = {}
    if lse:
        out, out_lse = out
        want, want_lse = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
        lse_err = float((out_lse - want_lse).abs().max())
        check(lse_err <= GRAD_LSE_TOL and bool(torch.equal(
            out, ops.attention(q, k, v, **kw))),
              f"{name}: lse off by {lse_err}, or the output changes with it")
        lse_fields = dict(lse=True, max_abs_err_lse=lse_err,
                          lse_tol=GRAD_LSE_TOL)
    else:
        want = ref.sdpa_ref(q, k, v, **kw)
    err = float((out.float() - want.float()).abs().max())
    atol, rtol = FLASH_TOL[dtype]
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    check(torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol),
          f"{name}: flash kernel disagrees with ref.sdpa_ref "
          f"(max abs err {err}, atol {atol}, rtol {rtol})")

    def rotating(fn):
        turn = iter(range(1 << 62))
        return lambda: fn(*sets[next(turn) % copies])

    kernel = lambda q, k, v: ops.attention(q, k, v, return_lse=lse, **kw)
    plain = lambda q, k, v: ref.sdpa_ref(q, k, v, return_lse=lse, **kw)
    ms, g_ms, n = timings(rotating(kernel))
    plain_ms, plain_g_ms, _ = timings(rotating(plain))
    visible = ref.attn_mask(qp, kp, causal, window) \
        & (kp < VALID_POS_LIMIT)[:, None, :]
    pairs = int(visible.sum()) * hq
    # bytes this data needs: q and out, and each key some row sees, once
    seen_keys = int(visible.any(dim=1).sum())
    n_bytes = (q.numel() + out.numel() + seen_keys * hkv * (dk + dv)) \
        * q.element_size() + 4 * (qp.numel() + kp.numel())
    bms, by = op_bound(2.0 * pairs * (dk + dv), n_bytes,
                       BF16_FLOPS_PER_S if dtype == "bfloat16"
                       else SPLIT_TF32_FLOPS_PER_S)
    floor = {}
    if dtype == "float32":
        floor = dict(bound_fp32_ms=op_bound(2.0 * pairs * (dk + dv), n_bytes,
                                            SCALAR_OPS_PER_S)[0])
    if variant == "prefill_tc":
        # S's k-steps cover Dk in 16s; P.V runs on P_hi and on P_lo, at Dv
        # rounded up to the 64-column panels (80 -> 128)
        fms, fby = op_bound(
            2.0 * pairs * (-(-dk // 16) * 16 + 2 * -(-dv // 64) * 64),
            n_bytes, BF16_FLOPS_PER_S)
        floor = dict(floor_ms=fms, floor_by=fby)
    lib_ms = None
    if cap == 0.0:               # SDPA has no softcap
        if window is None and valid0 is None and not decode and sq == skv:
            lib = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, scale=dk ** -0.5, enable_gqa=True)
        else:
            amask = ref.attn_mask(qp, kp, causal, window)[:, None] \
                & (kp < VALID_POS_LIMIT)[:, None, None, :]
            lib = lambda q, k, v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=amask, scale=dk ** -0.5, enable_gqa=True)
        lib_ms = time_ms(rotating(lib), n, warmup=2)
        if dtype == "float32":
            with torch.enable_grad():
                ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
                floor["library_backend"] = sdpa_backend(lib(*ls))
                del ls
    warm = {}
    if copies > 1:
        warm = dict(ms_warm=time_ms(lambda: kernel(q, k, v), n, warmup=2),
                    graph_ms_warm=graph_ms(lambda: kernel(q, k, v),
                                           launches=n, replays=3))
    out = dict(case=name, variant=variant, B=b, Sq=sq, Skv=skv, Hq=hq,
               Hkv=hkv, Dk=dk, Dv=dv, causal=causal, window=window,
               softcap=cap, dtype=dtype, copies=copies,
               visible_pairs=pairs, max_abs_err=err,
               max_abs_want=float(want.float().abs().max()), atol=atol,
               rtol=rtol, ms=ms, graph_ms=g_ms, **warm, plain_ms=plain_ms,
               plain_graph_ms=plain_g_ms, bound_ms=bms, bound_by=by, **floor,
               library_ms=lib_ms, **lse_fields,
               wall_s=time.perf_counter() - t_start)
    emit("kernel_flash", **out)
    return out


def kernel_flash_phase() -> list:
    cases = [
        flash_case("glm4_prefill", 4, 2048, 2048, 32, 2, 128, 128),
        # 8 caches of 8.5 MB in rotation: L2 cold, as for 40 layers
        flash_case("glm4_decode", 4, 1, 2080, 32, 2, 128, 128, decode=True,
                   copies=8),
        # deepseek-v2's MLA prefill: Dk 192 (128 + 64 rope), Dv 128
        flash_case("mla_prefill", 2, 2048, 2048, 128, 128, 192, 128,
                   seed=26),
        # simt's record: the same shape in f32, which simt still serves
        flash_case("simt_mla_f32", 2, 2048, 2048, 128, 128, 192, 128,
                   dtype="float32", seed=27),
    ]
    grid = [   # the reference's test grid (tests/test_kernels.py)
        (2, 128, 128, 4, 2, 32, 32, True, None, 0.0, "float32"),
        (1, 100, 100, 4, 4, 16, 16, True, None, 0.0, "float32"),
        (2, 128, 128, 4, 2, 32, 32, True, 40, 0.0, "float32"),
        (2, 64, 192, 4, 2, 32, 32, True, None, 0.0, "float32"),
        (2, 128, 128, 4, 4, 32, 32, False, None, 0.0, "float32"),
        (2, 128, 128, 8, 2, 64, 64, True, None, 30.0, "bfloat16"),
        (1, 256, 256, 2, 2, 192, 128, True, None, 0.0, "float32"),
        (1, 72, 72, 2, 1, 24, 24, True, 16, 0.0, "float32"),
    ]
    for i, (b, sq, skv, hq, hkv, dk, dv, causal, window, cap,
            dtype) in enumerate(grid):
        cases.append(flash_case(f"grid{i}", b, sq, skv, hq, hkv, dk, dv,
                                causal=causal, window=window, cap=cap,
                                dtype=dtype, seed=i + 1))
    # the edges of the variants (tests/test_torch_cuda.py FLASH_GRID)
    cases += [
        flash_case("tc_ragged", 1, 200, 200, 4, 2, 128, 128, seed=20),
        flash_case("tc_noncausal", 1, 256, 256, 4, 2, 128, 128,
                   causal=False, seed=21),
        flash_case("tc_window", 1, 256, 256, 4, 2, 128, 128, window=64,
                   seed=22),
        flash_case("split_64_rows", 2, 4, 2080, 32, 2, 128, 128, seed=23),
        flash_case("split_one_key", 4, 1, 2080, 32, 2, 128, 128,
                   decode=True, valid0=1, seed=24),
        flash_case("split_f32_d64_window", 2, 1, 1000, 8, 1, 64, 64,
                   window=128, dtype="float32", decode=True, seed=25),
        # prefill_tc at MLA's dims
        flash_case("mla_ragged", 2, 200, 200, 4, 4, 192, 128, seed=28),
        flash_case("mla_pad", 2, 256, 384, 8, 8, 192, 128, valid0=300,
                   seed=29),
        flash_case("mla_window", 1, 384, 384, 4, 4, 192, 128, window=100,
                   seed=30),
        flash_case("mla_softcap", 1, 256, 256, 4, 4, 192, 128, cap=30.0,
                   seed=31),
        flash_case("mla_gqa2", 1, 256, 256, 8, 4, 192, 128, seed=32),
        flash_case("mla_noncausal", 1, 256, 256, 4, 4, 192, 128,
                   causal=False, seed=33),
        # MLA's multi-token serving step (mla_multi's second step: 3
        # tokens over the 2048-key cache, lse on): simt's one-warp tile
        flash_case("mla_multi_step", 2, 3, 2048, 128, 128, 192, 128,
                   lse=True, seed=34),
        # prefill_tc at hubert's head dim 80: its encoder's shape, then
        # edges; the same shape in f32 stays on simt
        flash_case("hubert_prefill", 4, 2048, 2048, 16, 16, 80, 80,
                   causal=False, seed=40),
        flash_case("hubert_f32", 4, 2048, 2048, 16, 16, 80, 80,
                   causal=False, dtype="float32", seed=41),
        flash_case("d80_causal", 1, 512, 512, 4, 4, 80, 80, seed=42),
        flash_case("d80_ragged", 2, 200, 200, 4, 4, 80, 80, causal=False,
                   seed=43),
        flash_case("d80_gqa4", 1, 256, 256, 8, 2, 80, 80, seed=44),
        flash_case("d80_window", 1, 384, 384, 4, 4, 80, 80, window=100,
                   seed=45),
        flash_case("d80_pad", 2, 256, 384, 8, 8, 80, 80, valid0=300,
                   seed=46),
        flash_case("d80_softcap", 1, 256, 256, 4, 4, 80, 80, causal=False,
                   cap=30.0, seed=47),
        # gemma3-27b's own shapes: its local layers' 1024-key window and
        # its global layers at the 4096-token prefill, a local decode step
        flash_case("gemma3_local", 1, 4096, 4096, 32, 16, 128, 128,
                   window=1024, seed=48),
        flash_case("gemma3_global", 1, 4096, 4096, 32, 16, 128, 128,
                   seed=49),
        flash_case("gemma3_decode_local", 1, 1, 4128, 32, 16, 128, 128,
                   window=1024, decode=True, seed=50),
    ]
    return cases


def ssd_inputs(b, s, h, p, n, dtype, seed, with_h0=True) -> tuple:
    """x, dt (softplus'd), a, B, C and h0 (or None) on the card, seeded;
    x, B and C in ``dtype``."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x = (rnd(b, s, h, p) * 0.5).to(td)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a = -torch.exp(rnd(h) * 0.3)
    bm = (rnd(b, s, 1, n) * 0.4).to(td)
    cm = (rnd(b, s, 1, n) * 0.4).to(td)
    h0 = rnd(b, h, p, n) * 0.1 if with_h0 else None
    return x, dt, a, bm, cm, h0


def ssd_case(name: str, b, s, h, p, n, chunk, *, dtype="float32",
             with_h0=True, seed=0) -> dict:
    """One shape through ``ops.ssd`` on the card (S padded to a multiple
    of the chunk there), held to ``ref.ssd_ref`` on the padded inputs."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss

    t_start = time.perf_counter()
    td = getattr(torch, dtype)
    x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, p, n, dtype, seed, with_h0)
    variant = ss.variant(td, p, n, chunk)
    before, by_variant = ss.launches, dict(ss.variant_launches)
    y, f = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    by_variant[variant] += 1
    check(ss.launches == before + 1 and ss.variant_launches == by_variant,
          f"{name}: SSD kernel variant {variant} did not launch")
    pad = (-s) % chunk
    y_r, f_r = ref.ssd_ref(*(ref.pad_seq(t, pad) for t in (x, dt)), a,
                           *(ref.pad_seq(t, pad) for t in (bm, cm)),
                           chunk=chunk, h0=h0)
    y_r = y_r[:, :s]
    check(bool(torch.isfinite(y).all() and torch.isfinite(f).all()),
          f"{name}: non-finite output")
    err_y = float((y.float() - y_r).abs().max())
    rel = 1e-2 if dtype == "bfloat16" else 2e-5   # bf16 y: one rounding
    check(err_y / (float(y_r.abs().max()) + 1e-9) < rel,
          f"{name}: SSD kernel y disagrees with ref.ssd_ref "
          f"(max abs err {err_y})")
    check(torch.allclose(f, f_r, atol=2e-3, rtol=1e-4),
          f"{name}: SSD kernel final state disagrees with ref.ssd_ref")
    err = max(err_y, float((f - f_r).abs().max()))
    ms, g_ms, _ = timings(lambda: ops.ssd(x, dt, a, bm, cm, chunk=chunk,
                                          h0=h0))
    plain_ms, plain_g_ms, _ = timings(
        lambda: ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0, plain=True))
    sp = s + pad
    nc, tri = sp // chunk, chunk * (chunk + 1) / 2
    per_head = 2 * tri * p + 4 * chunk * p * n + 3 * tri
    flops = b * nc * (2 * tri * n + h * per_head)   # C.B^T once per chunk
    el = x.element_size()
    n_bytes = (2 * x.numel() + bm.numel() + cm.numel()) * el \
        + 4 * (dt.numel() + a.numel() + (2 if with_h0 else 1) * b * h * p * n)
    bms, by = op_bound(flops, n_bytes, BF16_FLOPS_PER_S
                       if dtype == "bfloat16" else SPLIT_TF32_FLOPS_PER_S)
    floor = {}
    if dtype == "float32":   # the fp32 CUDA cores' bound beside split-TF32's
        floor["bound_fp32_ms"] = op_bound(flops, n_bytes,
                                          SCALAR_OPS_PER_S)[0]
    if variant == "tc":
        # this design's own work: ssd_state reads x and B and writes the
        # entering states and dacum / dt; ssd_chunk_scan reads them with
        # x, B and C again; the state product runs twice (x hi + lo), and
        # C.B^T is formed per 64 x 64 tile up to the diagonal
        strips = chunk // 64
        tiles = strips * (strips + 1) // 2
        n_hg = -(-h // 8)
        tc_flops = b * nc * (h * (2 * 2 * chunk * p * n + 2 * chunk * p * n
                                  + tiles * 2 * 64 * 64 * p)
                             + n_hg * tiles * 2 * 64 * 64 * n)
        states = b * nc * h * p * n * 2 + b * nc * h * 2 * chunk * 4
        tc_bytes = n_bytes + (x.numel() + bm.numel()) * el + 2 * states
        fms, fby = op_bound(tc_flops, tc_bytes, BF16_FLOPS_PER_S)
        floor = dict(floor_ms=fms, floor_by=fby)
    out = dict(case=name, variant=variant, B=b, S=s, H=h, P=p, N=n,
               chunk=chunk, dtype=dtype, h0=with_h0, max_abs_err=err,
               max_abs_err_y=err_y, max_abs_y=float(y_r.abs().max()), ms=ms,
               graph_ms=g_ms, plain_ms=plain_ms, plain_graph_ms=plain_g_ms,
               bound_ms=bms, bound_by=by, **floor, library_ms=None,
               wall_s=time.perf_counter() - t_start)
    emit("kernel_ssd", **out)
    return out


def ssd_phase_case(b=4, s=2048, h=48, n=128, chunk=256, seed=0) -> None:
    """tc's two kernels one at a time against their plain phases: the
    entering states within one bf16 rounding (rtol 2^-8) over the final
    state's atol 2e-3, the final state at atol 2e-3 / rtol 1e-4, y from
    the kernel's states within 1e-2 of max|y|."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ss

    x, dt, a, bm, cm, h0 = ssd_inputs(b, s, h, 64, n, "bfloat16", seed)
    states, meta, final = ss.tc_states(x, dt, a, bm, chunk=chunk, h0=h0)
    y = ss.tc_outputs(x, bm, cm, states, meta, chunk=chunk)
    torch.cuda.synchronize()
    prev, final_r = ref.ssd_states(x, dt, a, bm, chunk, h0=h0)
    y_r = ref.ssd_outputs(x, dt, a, bm, cm, chunk, states.float())
    err_states = float((states.float() - prev).abs().max())
    err_final = float((final - final_r).abs().max())
    err_y = float((y.float() - y_r).abs().max()) / float(y_r.abs().max())
    check(torch.allclose(states.float(), prev, atol=2e-3, rtol=2 ** -8),
          f"ssd_state: entering states differ from ref.ssd_states "
          f"({err_states})")
    check(torch.allclose(final, final_r, atol=2e-3, rtol=1e-4),
          f"ssd_state: final state differs from ref.ssd_states ({err_final})")
    check(err_y < 1e-2, f"ssd_chunk_scan: y differs from ref.ssd_outputs "
          f"({err_y} of max|y|)")
    emit("kernel_ssd_phases", B=b, S=s, H=h, N=n, chunk=chunk,
         max_abs_err_states=err_states, max_abs_err_final=err_final,
         rel_err_y=err_y,
         state_graph_ms=graph_ms(lambda: ss.tc_states(
             x, dt, a, bm, chunk=chunk, h0=h0), launches=20, replays=3),
         chunk_scan_graph_ms=graph_ms(lambda: ss.tc_outputs(
             x, bm, cm, states, meta, chunk=chunk), launches=20, replays=3))


def kernel_ssd_phase() -> list:
    cases = [ssd_case("mamba2_prefill", 4, 2048, 48, 64, 128, 256,
                      dtype="bfloat16"),
             # zamba2-1.2b's Mamba layers: d_inner 4096 in 64 heads, N 64
             ssd_case("zamba2_prefill", 4, 2048, 64, 64, 64, 256,
                      dtype="bfloat16", seed=27),
             # the same two prefills in f32 (a config's dtype="float32"):
             # simt at a model's full width
             ssd_case("mamba2_prefill_f32", 4, 2048, 48, 64, 128, 256,
                      seed=28),
             ssd_case("zamba2_prefill_f32", 4, 2048, 64, 64, 64, 256,
                      seed=29)]
    grid = [   # the reference's test grid (tests/test_kernels.py)
        (2, 256, 8, 16, 32, 64), (1, 128, 16, 64, 128, 32),
        (2, 512, 48, 64, 128, 256), (1, 64, 4, 32, 16, 64),
    ]
    for i, (b, s, h, p, n, chunk) in enumerate(grid):
        cases.append(ssd_case(f"grid{i}", b, s, h, p, n, chunk, seed=i + 1))
    for dtype in ("float32", "bfloat16"):   # odd H: one head per block
        cases.append(ssd_case(f"odd_heads_{dtype}", 1, 128, 5, 32, 64, 32,
                              dtype=dtype, seed=9))
    # the edges of tc (tests/test_torch_cuda.py SSD_GRID)
    bf = dict(dtype="bfloat16")
    cases += [
        ssd_case("tc_h5", 1, 512, 5, 64, 128, 256, seed=20, **bf),
        ssd_case("tc_no_h0", 2, 512, 8, 64, 128, 256, with_h0=False,
                 seed=21, **bf),
        ssd_case("tc_ragged", 1, 300, 4, 64, 128, 128, seed=22, **bf),
        ssd_case("tc_chunk64", 2, 256, 6, 64, 128, 64, seed=23, **bf),
        ssd_case("tc_chunk128", 1, 512, 6, 64, 128, 128, seed=24, **bf),
        ssd_case("tc_n64", 2, 512, 4, 64, 64, 256, seed=25, **bf),
        ssd_case("tc_b1", 1, 2048, 48, 64, 128, 256, seed=26, **bf),
    ]
    ssd_phase_case()
    return cases


def kernel_record(name: str, source: str, replaces: str, launches: int,
                  cases: list) -> dict:
    """One entry of the kernels line: the first case's times, the largest
    error over ``cases``."""
    head = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "graph_ms": head["graph_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"]}


def flash_records(cases: list, paths: dict) -> list:
    """One entry per flash variant, timed at its main-path case (glm4-9b
    prefill, glm4-9b decode; simt, which no model path reaches, at MLA's
    shape in f32), named in ``case``; ``launches`` sums the model paths'
    counts, by path beside it."""
    heads = {"prefill_tc": "glm4_prefill", "decode_split": "glm4_decode",
             "simt": "simt_mla_f32"}
    out = []
    for variant, head in heads.items():
        mine = [c for c in cases if c["variant"] == variant]
        first = [c for c in mine if c["case"] == head]
        check(len(first) == 1, f"flash case {head} did not run {variant}")
        by_path = {path: counts[variant] for path, counts in paths.items()}
        out.append(dict(kernel_record(
            f"flash_attention.{variant}",
            f"src/repro_torch/kernels/csrc/flash_{variant}.cuh",
            "src/repro/kernels/flash_attention.py:90",
            sum(by_path.values()),
            first + [c for c in mine if c["case"] != head]),
            case=head, launches_by_path=by_path))
    return out


def ssd_records(cases: list, paths: dict) -> list:
    """One entry per SSD variant, timed at its case on the main path
    (mamba2-780m prefill; simt, which the main path does not reach, at
    the same prefill in f32); ``launches`` sums the model paths' counts,
    by path beside it."""
    heads = {"tc": "mamba2_prefill", "simt": "mamba2_prefill_f32"}
    out = []
    for variant, head in heads.items():
        mine = [c for c in cases if c["variant"] == variant]
        first = [c for c in mine if c["case"] == head]
        check(len(first) == 1, f"ssd case {head} did not run {variant}")
        by_path = {path: counts[f"ssd_{variant}"]
                   for path, counts in paths.items()}
        out.append(dict(kernel_record(
            f"ssd_scan.{variant}",
            f"src/repro_torch/kernels/csrc/ssd_{variant}.cuh",
            "src/repro/kernels/ssd_scan.py:76", sum(by_path.values()),
            first + [c for c in mine if c["case"] != head]),
            case=head, launches_by_path=by_path))
    return out


BACKWARD_SOURCES = {
    "flash_attention": ("src/repro/kernels/flash_attention.py:90", {
        "tc": "src/repro_torch/kernels/csrc/flash_backward_tc.cuh",
        "simt": "src/repro_torch/kernels/csrc/flash_backward.cuh"}),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:76", {
        "tc": "src/repro_torch/kernels/csrc/ssd_backward_tc.cuh",
        "simt": "src/repro_torch/kernels/csrc/ssd_backward.cuh"}),
}


def backward_records(grad_cases: dict, paths: dict) -> list:
    """One entry per backward kernel and variant, both timed at the first
    case (zamba2's training shape, which takes ``tc``): ``tc`` as it runs
    there beside its plain twin, ``simt`` asked for by name at the same
    shape beside the fp32 plain backward; the largest error over the cases
    that took the variant; ``launches`` sums the training paths' counts,
    by path beside it.  ``replaces`` names the TPU kernel whose function's
    gradient it computes: the reference has no backward kernel and
    differentiates its plain version."""
    out = []
    for kernel, cases in grad_cases.items():
        head = cases[0]
        check(head["backward_variant"] == "tc",
              f"{kernel}: the timed case took {head['backward_variant']}")
        replaces, sources = BACKWARD_SOURCES[kernel]
        for variant, source in sources.items():
            name = f"{kernel}.backward.{variant}"
            mine = [c for c in cases if c["backward_variant"] == variant]
            check(bool(mine), f"no kernel_grad case took {name}")
            by_path = {path: counts.get(name, 0)
                       for path, counts in paths.items()}
            tc = variant == "tc"
            out.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": max(c["max_abs_err"] for c in mine),
                "ms": head["bwd_ms"] if tc else head["simt_bwd_ms"],
                "graph_ms": head["bwd_graph_ms"] if tc else None,
                "plain_ms": head["twin_bwd_ms"] if tc
                else head["plain_bwd_ms"],
                "bound_ms": head["bwd_bound_ms"],
                "bound_by": head["bwd_bound_by"],
                "library_ms": head["library_bwd_ms"], "case": head["case"],
                "launches_by_path": by_path,
                "max_rel_err": max(max(c["rel_err_vs_plain"]) for c in mine),
                **({k: head[k] for k in ("fwd_bwd_ms", "plain_fwd_bwd_ms",
                                         "library_fwd_bwd_ms",
                                         "fwd_bwd_bound_ms",
                                         "speedup_vs_simt")} if tc else {}),
                "cases": {c["case"]: {k: c.get(k) for k in (
                    "bwd_ms", "bwd_graph_ms", "simt_bwd_ms", "bwd_bound_ms",
                    "bwd_bound_fp32_ms", "library_bwd_ms", "library_backend",
                    "max_abs_err")}
                    for c in mine}})
    return out


def with_lse(record: dict, mesh_decode: dict) -> dict:
    """A flash variant's record with its log-sum-exp output on the
    mesh_decode paths: decode_split's launches that wrote it and its
    cases' times; prefill_tc's and simt's on MLA's multi-token seq-mesh
    steps (each launch there wrote it)."""
    counts = dict(mesh_decode["counts"])
    mla = counts.pop("mla_multi")
    variant = record["name"].split(".")[1]
    if variant in ("prefill_tc", "simt"):
        return dict(record, lse_launches=mla[variant])
    if record["name"] != "flash_attention.decode_split":
        return record
    return dict(record, lse_launches=sum(c["lse"] for c in counts.values()),
                lse={c["case"]: {k: c[k] for k in (
                    "ms", "graph_ms", "ms_without_lse",
                    "graph_ms_without_lse", "plain_ms", "bound_ms",
                    "bound_by", "max_abs_err_lse")}
                    for c in mesh_decode["cases"]})


# -- phases 8-10: the model stack ----------------------------------------------

ATTN_MIXERS = ("attn", "attn_local", "shared_attn")   # a flash call a pass

def vision_positions(b: int, s: int, device):
    """M-RoPE positions ``[3, B, S]`` of an image and then text: a square
    grid of ``isqrt(S / 2)``^2 patches at t = 0 (h = row, w = column), then
    text at its index in all three sections, so decode steps continue it."""
    import math

    import torch

    grid = math.isqrt(s // 2)
    t = torch.arange(s, device=device)
    img = t < grid * grid
    pos = torch.stack([torch.where(img, 0, t), torch.where(img, t // grid, t),
                       torch.where(img, t % grid, t)])
    return pos[:, None].expand(3, b, s).to(torch.int32).contiguous()


def model_inputs(cfg, batch: int, prompt: int, steps: int, gen, device):
    """A seeded prompt as the arch takes it (token ids; the stub frontend's
    ``embeds`` for vlm and audio; M-RoPE positions of an image and text)
    and ``steps`` rows of decode tokens (none for an encoder)."""
    import torch

    if cfg.family in ("vlm", "audio"):
        inputs = {"embeds": torch.randn((batch, prompt, cfg.d_model),
                                        generator=gen, device=device
                                        ).to(cfg.compute_dtype())}
    else:
        inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                          generator=gen, device=device)}
    if cfg.mrope_sections is not None:
        inputs["positions"] = vision_positions(batch, prompt, device)
    step_toks = torch.randint(0, cfg.vocab_size,
                              (steps if cfg.causal else 0, batch),
                              generator=gen, device=device)
    return inputs, step_toks


def generate(cfg, ctx, params, inputs: dict, step_tokens,
             ring_len: int) -> dict:
    """Prefill ``inputs``, move the cache into rings, one decode_step per
    row of ``step_tokens`` with ``[B]`` positions; logits and wall seconds.
    An encoder (``cfg.causal`` false) runs ``forward`` once instead: its
    logits ``[B, S, V]`` and ``prefill_s``."""
    import torch

    from repro_torch.models import decoder

    first = inputs["tokens"] if "tokens" in inputs else inputs["embeds"]
    dev = first.device
    b, s = first.shape[:2]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if not cfg.causal:
        logits = decoder.forward(cfg, ctx, params, inputs)
        sync()
        return dict(logits=[logits], ring=None,
                    prefill_s=time.perf_counter() - t0, decode_s=0.0)
    logits, caches = decoder.prefill(cfg, ctx, params, inputs)
    sync()
    t1 = time.perf_counter()
    ring = decoder.into_ring(decoder.init_cache(cfg, b, ring_len,
                                                cfg.compute_dtype(), dev),
                             caches)
    del caches
    sync()
    t2 = time.perf_counter()
    out = [logits]
    for i, tok in enumerate(step_tokens):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        logits, ring = decoder.decode_step(cfg, ctx, params, ring, tok, pos)
        out.append(logits)
    sync()
    t3 = time.perf_counter()
    return dict(logits=out, ring=ring, prefill_s=t1 - t0, decode_s=t3 - t2)


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (inflated by
    the profiler's host work), device busy ms (the sum of the device ops'
    times; null when the trace holds none), the largest device ops, and
    the device ms of this repo's kernels (names in the ``flash``,
    ``ssd`` and ``lease`` namespaces or files), whatever their rank."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in device_ops(prof)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) if rows else None
    ours = [dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows
            if any(k in n for k in ("flash::", "ssd::", "lease"))]
    return dict(wall_ms=wall, device_busy_ms=busy,
                top=[dict(name=n[:90], ms=ms, calls=c)
                     for n, ms, c in rows[:5]], repo_kernels=ours)


@contextlib.contextmanager
def recorded_routing():
    """Every ``moe.router_topk`` call while it is open, in order: the
    expert ids ``[T, K]`` and the k + 1 largest router probabilities
    ``[T, K + 1]``, both left on the device."""
    import torch

    from repro_torch.models import moe

    calls = []
    plain = moe.router_topk

    def recording(logits, top_k, norm_topk, router_scale):
        vals, ids = plain(logits, top_k, norm_topk, router_scale)
        calls.append((ids, torch.topk(torch.softmax(logits.float(), -1),
                                      top_k + 1).values))
        return vals, ids

    moe.router_topk = recording
    try:
        yield calls
    finally:
        moe.router_topk = plain


def routing_flips(a: list, b: list, where: str, n_moe: int) -> tuple:
    """The token rows of each call whose expert set differs between two
    recorded runs of the same work, and the largest change of a router
    probability over the rows that routed alike in the call and in the
    pass's earlier layers (the runs' own noise).

    The calls come ``n_moe`` a pass (one per MoE layer, in order).  A row
    that already took other experts in an earlier layer of its pass has
    another input and may route anywhere.  Any other flip must be a
    near-tie: its k-th and (k+1)-th probabilities closer, in both runs,
    than ``NEAR_TIE`` or twice the noise of its call; anything else fails.
    """
    import torch

    check(len(a) == len(b), f"{where}: {len(a)} and {len(b)} router calls")
    out, noise_max, flipped = [], 0.0, set()
    for i, ((ia, pa), (ib, pb)) in enumerate(zip(a, b)):
        if i % n_moe == 0:
            flipped = set()
        ia, ib = ia.cpu().sort(-1).values, ib.cpu().sort(-1).values
        pa, pb = pa.float().cpu(), pb.float().cpu()
        differ = (ia != ib).any(-1)
        alike = ~differ
        alike[list(flipped)] = False
        noise = float((pa - pb)[alike].abs().max()) if alike.any() else 0.0
        noise_max = max(noise_max, noise)
        k = ia.shape[1]
        rows = [r for r in torch.nonzero(differ).flatten().tolist()
                if r not in flipped]
        gap = torch.maximum(pa[rows, k - 1] - pa[rows, k],
                            pb[rows, k - 1] - pb[rows, k])
        wide = gap[gap >= max(NEAR_TIE, 2 * noise)]
        check(not len(wide), f"{where}: router call {i} takes other "
              f"experts at a gap of {wide.tolist()[:4]} (not a near-tie; "
              f"the call's noise {noise})")
        rows = set(torch.nonzero(differ).flatten().tolist())
        flipped |= rows
        out.append(rows)
    return out, noise_max


def generate_keep(flips: list, n_moe: int, batch: int, prompt: int,
                  steps: int) -> list:
    """Per logits entry of :func:`generate`, the rows whose own routing
    agreed in every MoE layer: the prompt's last position for the prefill
    entry, the step's token for a decode entry.  The calls come in layer
    order, ``n_moe`` for the prefill, then ``n_moe`` a step."""
    check(len(flips) == n_moe * (1 + steps),
          f"{len(flips)} router calls for {n_moe} MoE layers x "
          f"{1 + steps} passes")
    keep = []
    for entry in range(1 + steps):
        calls = flips[entry * n_moe:(entry + 1) * n_moe]
        row = (lambda b: b * prompt + prompt - 1) if entry == 0 \
            else (lambda b: b)
        keep.append([not any(row(b) in c for c in calls)
                     for b in range(batch)])
    return keep


def compare_logits(a: list, b: list, keep=None) -> dict:
    """Largest difference, its share of the largest reference logit, and
    the share of greedy (argmax) tokens that agree; with ``keep`` (per
    entry, a bool per row), over the kept rows only."""
    import torch

    if keep is None:
        keep = [[True] * len(y) for y in b]
    pairs = [(x.float().cpu()[k], y.float().cpu()[k])
             for x, y, k in zip(a, b, (torch.tensor(k, dtype=torch.bool)
                                       for k in keep))]
    pairs = [(x, y) for x, y in pairs if len(y)]
    diff = max(float((x - y).abs().max()) for x, y in pairs)
    top = max(float(y.abs().max()) for _, y in pairs)
    agree = torch.cat([(x.argmax(-1) == y.argmax(-1)).float()
                       for x, y in pairs])
    rows = sum(len(k) for k in keep)
    kept = sum(sum(k) for k in keep)
    return dict(max_abs_diff=diff, max_abs_logit=top, rel_diff=diff / top,
                greedy_agree=float(agree.mean()), rows_compared=kept,
                rows_flipped=rows - kept)


@contextlib.contextmanager
def recorded_attention():
    """The attention term of every ``decoder.block_apply`` while it is open,
    in order: the mixer's output before its post-norm and the residual
    add, where a wrong mask or rotary theta would show whole."""
    from repro_torch.models import decoder

    terms = []
    plain = decoder.gqa_attention, decoder.mla_attention

    def recording(fn):
        def run(*args, **kw):
            a, c = fn(*args, **kw)
            terms.append(a)
            return a, c
        return run

    decoder.gqa_attention, decoder.mla_attention = map(recording, plain)
    try:
        yield terms
    finally:
        decoder.gqa_attention, decoder.mla_attention = plain


def layerwise(cfg, sides, inputs: dict, step_tok, ring_len: int) -> dict:
    """Every layer on two sides from the same input: side 0 against side 1,
    each fed side 1's hidden state, over the prefill of ``inputs`` and then
    one decode step of ``step_tok`` against a copy of that layer's side-1
    prefill cache in a ring of ``ring_len`` (an encoder: the prefill
    alone).  ``sides``: two (ctx, params) pairs.  Per pass, each layer's
    largest output difference as a share of side 1's largest output, and
    under ``<pass>_attn`` the same of each attention layer's attention term
    (:func:`recorded_attention`): the residual stream can outgrow it."""
    import torch

    from repro_torch.models import common, decoder

    (ctx_a, pa), (ctx_b, pb) = sides
    dev_a, dev_b = ctx_a.device, ctx_b.device
    kinds = common.layer_plan(cfg).kinds
    pairs = list(zip(kinds, pa["layers"], pb["layers"]))
    shared = (pa.get("shared_attn"), pb.get("shared_attn"))
    share = lambda a, b: float((a.float().to(b.device) - b.float()).abs()
                               .max() / b.float().abs().max())
    inputs = to_device(inputs, dev_b)
    x = decoder.embed_in(cfg, pb, inputs)
    pos = decoder._positions(inputs, x)
    out, caches = {"prefill": []}, []

    def attn_share(name: str, terms: list) -> None:
        if terms:        # side 1's term, then side 0's
            out.setdefault(f"{name}_attn", []).append(share(terms[1],
                                                            terms[0]))
            terms.clear()

    with torch.no_grad(), recorded_attention() as terms:
        for kind, la, lb in pairs:
            y, c = decoder.block_apply(cfg, ctx_b, kind, lb, x, pos,
                                       shared_p=shared[1],
                                       return_cache=cfg.causal)
            y_a, _ = decoder.block_apply(cfg, ctx_a, kind, la, x.to(dev_a),
                                         pos.to(dev_a), shared_p=shared[0])
            out["prefill"].append(share(y_a, y))
            attn_share("prefill", terms)
            caches.append(c)
            x = y
        if not cfg.causal:
            return out
        b, s = x.shape[:2]
        ring = decoder.into_ring(decoder.init_cache(
            cfg, b, ring_len, cfg.compute_dtype(), dev_b), caches)
        del caches
        x = decoder.embed_in(cfg, pb, {"tokens": step_tok.to(dev_b)[:, None]})
        at = torch.full((b,), s, dtype=torch.int32, device=dev_b)
        pos = at[:, None]
        if cfg.mrope_sections is not None:
            pos = pos[None].expand(3, b, 1)
        out["decode"] = []
        for (kind, la, lb), r in zip(pairs, ring):
            r_a = to_device(r, dev_a, copy=True)
            y, _ = decoder.block_apply(cfg, ctx_b, kind, lb, x, pos,
                                       shared_p=shared[1], cache=r,
                                       cache_index=at)
            y_a, _ = decoder.block_apply(cfg, ctx_a, kind, la, x.to(dev_a),
                                         pos.to(dev_a), shared_p=shared[0],
                                         cache=r_a,
                                         cache_index=at.to(dev_a))
            out["decode"].append(share(y_a, y))
            attn_share("decode", terms)
            x = y
    return out


def expected_launches(cfg, prompt: int, steps: int) -> dict:
    """The kernel launches of :func:`generate` with the kernels on: one
    flash call per attention layer (zamba2's shared sites each count) and
    pass, in the variant the launcher takes for its shapes (MLA's one-token
    decode is absorbed einsums: no flash; an encoder runs one pass, its
    forward), and one SSD call per Mamba layer at prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import common

    kinds = common.layer_plan(cfg).kinds
    n_attn = sum(k.mixer in ATTN_MIXERS for k in kinds)
    steps = steps if cfg.causal else 0
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    dt = cfg.compute_dtype()
    by = dict.fromkeys(fa.VARIANTS, 0)
    if cfg.mla is not None:
        m = cfg.mla
        by[fa.variant(dt, prompt, cfg.n_heads, cfg.n_heads,
                      m.qk_nope_head_dim + m.qk_rope_head_dim,
                      m.v_head_dim)] += n_attn
    else:
        for sq, passes in ((prompt, 1), (1, steps)):
            by[fa.variant(dt, sq, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.head_dim)] += n_attn * passes
    ssd = dict.fromkeys((f"ssd_{v}" for v in ss.VARIANTS), 0)
    if n_mamba:
        s = cfg.ssm
        ssd[f"ssd_{ss.variant(dt, s.head_dim, s.d_state, s.chunk)}"] = \
            n_mamba
    return dict(flash=sum(by.values()), ssd=n_mamba, lease=0, **by, **ssd)


def model_phase(phase: str, arch: str, *, n_layers=None, batch: int = 4,
                prompt: int = 2048, steps: int = 16, ring: int = 2080,
                seed: int = 0, by_layer: bool = False, sites=()) -> dict:
    """Full width (depth cut to ``n_layers`` where given): "auto" (the
    kernels) then "ref" on the card.  The launches of the "auto" run are
    checked against :func:`expected_launches` and returned.  Where the
    model routes tokens to experts, a token whose routing differs between
    the two runs (a near-tie, :func:`routing_flips`) is left out of the
    logit comparison.

    ``by_layer``: for a model whose seeded weights make the logits
    chaotic in bf16 (gemma3's 62 layers: a plain run whose one prompt
    embedding is one bf16 step larger differs as much), the logits of the
    two runs are reported beside that sensitivity and the check is
    :func:`layerwise` instead: every layer's output and attention term
    within MODEL_TOL.

    ``sites``: the calls (``"prefill"``, ``"decode_step"``) whose sync
    sites are recorded once each after the "auto" run (SYNC_SITES)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import common, decoder

    t_start = time.perf_counter()
    cfg = get_config(arch)
    published = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device("cuda")
    params = common.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, cfg.compute_dtype())
    inputs, step_toks = model_inputs(
        cfg, batch, prompt, steps, torch.Generator(device=dev).manual_seed(
            seed + 1), dev)
    steps = len(step_toks)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    n_moe = sum(k.ffn == "moe" for k in common.layer_plan(cfg).kinds)
    runs, routing, path_counts = {}, {}, None
    for use in ("auto", "ref"):
        ctx = decoder.RunCtx(dev, use_kernel=use)
        # untimed, at the same shapes: the allocator's growth, cuBLAS's first
        # calls and the kernel's module load stay out of the timed run
        generate(cfg, ctx, params, inputs, step_toks[:2], ring)
        torch.cuda.reset_peak_memory_stats()
        fa.launches = ss.launches = lv.launches = 0    # just before the path
        fa.variant_launches.update(dict.fromkeys(fa.VARIANTS, 0))
        ss.variant_launches.update(dict.fromkeys(ss.VARIANTS, 0))
        with recorded_routing() as routing[use]:
            run = generate(cfg, ctx, params, inputs, step_toks, ring)
        # the SSD variants' keys carry a prefix: flash has a simt too
        counts = dict(flash=fa.launches, ssd=ss.launches, lease=lv.launches,
                      **fa.variant_launches,
                      **{f"ssd_{k}": v for k, v in ss.variant_launches.items()})
        want = expected_launches(cfg, prompt, steps) if use == "auto" \
            else dict.fromkeys(counts, 0)
        check(counts == want, f"{phase}/{use}: kernel launches {counts}, "
              f"expected {want}")
        # an encoder's forward: every frame's logits
        shape = (batch, cfg.vocab_size) if cfg.causal \
            else (batch, prompt, cfg.vocab_size)
        for lg in run["logits"]:
            check(bool(torch.isfinite(lg).all()),
                  f"{phase}/{use}: non-finite logits")
            check(tuple(lg.shape) == shape,
                  f"{phase}/{use}: logits shape {tuple(lg.shape)}")
        if use == "auto":   # where the time goes, after the counts are read
            path_counts = counts
            if cfg.causal:
                nxt = torch.full((batch,), prompt + steps, dtype=torch.int32,
                                 device=dev)
                calls = {"prefill": lambda: decoder.prefill(
                             cfg, ctx, params, inputs),
                         "decode_step": lambda: decoder.decode_step(
                             cfg, ctx, params, run["ring"], step_toks[0],
                             nxt)}
                for name in sites:
                    record_sites(f"{phase}/{name}", calls[name])
                emit(phase, profile="prefill", **device_profile(
                    lambda: decoder.prefill(cfg, ctx, params, inputs)))
                emit(phase, profile="decode_step", **device_profile(
                    lambda: decoder.decode_step(cfg, ctx, params,
                                                run["ring"], step_toks[0],
                                                nxt)))
            else:
                emit(phase, profile="forward", **device_profile(
                    lambda: decoder.forward(cfg, ctx, params, inputs)))
        del run["ring"]
        runs[use] = run
        rates = dict(decode_tok_s=batch * steps / run["decode_s"]) \
            if steps else dict(frames_s=batch * prompt / run["prefill_s"])
        emit(phase, use_kernel=use, arch=arch, n_layers=cfg.n_layers,
             published_layers=published, d_model=cfg.d_model,
             params=cfg.param_count(), batch=batch, prompt=prompt,
             inputs=sorted(inputs), steps=steps, ring=ring, launches=counts,
             prefill_s=run["prefill_s"], decode_s=run["decode_s"],
             prefill_tok_s=batch * prompt / run["prefill_s"], **rates,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    flips, noise = routing_flips(routing["auto"], routing["ref"], phase,
                                 n_moe) if n_moe else ([], 0.0)
    keep = generate_keep(flips, n_moe, batch, prompt, steps) if n_moe \
        else None
    agree = compare_logits(runs["auto"]["logits"], runs["ref"]["logits"],
                           keep)
    sensitivity = {}
    if by_layer:
        ref_ctx = decoder.RunCtx(dev, use_kernel="ref")
        bumped = dict(inputs)
        if "tokens" in inputs:      # one token's embedding row, one step up
            bumped_params = dict(params, embed=params["embed"].clone())
            bumped_params["embed"][inputs["tokens"][0, 0]] *= 1 + 2 ** -7
        else:
            bumped_params = params
            bumped["embeds"] = inputs["embeds"].clone()
            bumped["embeds"][0, 0] *= 1 + 2 ** -7
        bumped_run = generate(cfg, ref_ctx, bumped_params, bumped, step_toks,
                              ring)
        sensitivity = {f"plain_bumped_{k}": v for k, v in compare_logits(
            bumped_run["logits"], runs["ref"]["logits"]).items()}
        del bumped_params, bumped_run
        shares = layerwise(cfg, [(decoder.RunCtx(dev), params),
                                 (ref_ctx, params)], inputs, step_toks[0],
                           ring)
        emit(phase, compare="layerwise", tol_rel=MODEL_TOL, **shares)
        for name, per_layer in shares.items():
            check(max(per_layer) <= MODEL_TOL,
                  f"{phase}: a layer's {name} output through the kernels "
                  f"differs from the plain one by {max(per_layer)} of its "
                  f"largest value (limit {MODEL_TOL})")
    emit(phase, compare="auto_vs_ref", tol_rel=MODEL_TOL, init_s=init_s,
         router_calls=len(flips), router_noise=noise,
         routing_flips=sum(len(f) for f in flips),
         logits_checked=not by_layer, **sensitivity,
         wall_s=time.perf_counter() - t_start, **agree)
    check(agree["rows_compared"] * 2 >= agree["rows_compared"]
          + agree["rows_flipped"], f"{phase}: routing flipped in more "
          f"than half the compared rows")
    check(by_layer or agree["rel_diff"] <= MODEL_TOL,
          f"{phase}: kernel and plain logits differ by {agree['rel_diff']} "
          f"of the largest logit (limit {MODEL_TOL})")
    del params, runs, routing
    torch.cuda.empty_cache()
    return path_counts


def to_device(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: to_device(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, copy) for v in tree]
    return tree.to(device, copy=copy)


def to_cpu(tree):
    return to_device(tree, "cpu")


# arch -> layers: 2, or 6 where the first shared site (zamba2's layer 5) or
# global layer (gemma3's layer 5) lies deeper
HELD_ARCHS = {"glm4-9b": 2, "mamba2-780m": 2, "mixtral-8x7b": 2,
              "deepseek-v2-236b": 2, "zamba2-1.2b": 6, "minitron-4b": 2,
              "gemma3-27b": 6, "qwen2-vl-2b": 2, "hubert-xlarge": 2}
# also held layer by layer (:func:`layerwise`): seeded gemma3 amplifies one
# bf16 rounding through its layers (at 62 layers into logits of another
# order: model_phase's ``by_layer``)
HELD_BY_LAYER = ("gemma3-27b",)


def held_phase(*, batch: int = 2, prompt: int = 64, steps: int = 4,
               seed: int = 3) -> None:
    """Full width, depth cut to HELD_ARCHS: the port on cuda against the
    port on cpu; a token whose expert routing differs between the two (a
    near-tie) is left out of the comparison."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import common, decoder

    for arch, n_layers in HELD_ARCHS.items():
        t_start = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        dev = torch.device("cuda")
        on_card = common.init_params(cfg, torch.Generator(
            device=dev).manual_seed(seed), dev, cfg.compute_dtype())
        on_cpu = to_cpu(on_card)
        inputs, step_toks = model_inputs(
            cfg, batch, prompt, steps, torch.Generator().manual_seed(seed),
            "cpu")
        fa.launches = ss.launches = 0
        with recorded_routing() as on_card_routing:
            card = generate(cfg, decoder.RunCtx(dev), on_card,
                            to_device(inputs, dev), step_toks.to(dev),
                            prompt + 8)
        launched = fa.launches + ss.launches
        check(launched > 0, f"held/{arch}: no kernel launched on the card")
        with recorded_routing() as on_cpu_routing:
            host = generate(cfg, decoder.RunCtx("cpu"), on_cpu, inputs,
                            step_toks, prompt + 8)
        n_moe = sum(k.ffn == "moe" for k in common.layer_plan(cfg).kinds)
        flips, noise = routing_flips(on_card_routing, on_cpu_routing,
                                     f"held/{arch}", n_moe) if n_moe \
            else ([], 0.0)
        keep = generate_keep(flips, n_moe, batch, prompt, steps) if n_moe \
            else [[True] * batch for _ in card["logits"]]
        agree = compare_logits(card["logits"], host["logits"], keep)
        for x, y, k in zip(card["logits"], host["logits"], keep):
            k = torch.tensor(k, dtype=torch.bool)
            check(torch.allclose(x.float().cpu()[k], y.float()[k],
                                 atol=HELD_TOL, rtol=HELD_TOL),
                  f"held/{arch}: cuda and cpu logits differ "
                  f"({agree['max_abs_diff']})")
        shares = {}
        if arch in HELD_BY_LAYER:
            shares = layerwise(cfg, [(decoder.RunCtx(dev), on_card),
                                     (decoder.RunCtx("cpu"), on_cpu)],
                               inputs, step_toks[0], prompt + 8)
            for name, per_layer in shares.items():
                check(max(per_layer) <= HELD_TOL,
                      f"held/{arch}: a layer's {name} output on cuda "
                      f"differs from cpu by {max(per_layer)} of its largest "
                      f"value (limit {HELD_TOL})")
        emit("held", arch=arch, n_layers=n_layers, d_model=cfg.d_model,
             batch=batch, prompt=prompt, steps=len(step_toks),
             launches=launched, by_layer=shares,
             tol=HELD_TOL, routing_flips=sum(len(f) for f in flips),
             router_noise=noise,
             cuda_s=card["prefill_s"] + card["decode_s"],
             cpu_s=host["prefill_s"] + host["decode_s"],
             wall_s=time.perf_counter() - t_start, **agree)
        del on_card, on_cpu, card, host
        torch.cuda.empty_cache()


# -- phases 10b-10d: routed experts, real-decode serving ----------------------

def moe_layer(arch: str, seed: int, **moe_change):
    """(cfg, the params of one MoE layer) at full width, bf16, seeded: the
    first MoE layer of a model cut to it (``moe_change``: fields of its
    MoEConfig replaced)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.moe.first_dense_layers + 1,
                              moe=dataclasses.replace(cfg.moe, **moe_change))
    dev = torch.device("cuda")
    params = common.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, cfg.compute_dtype())
    return cfg, params["layers"][-1]["moe"]


def moe_routed_phase(seed: int = 7) -> None:
    """One full-width MoE layer of each arch: ``moe_apply`` (routed)
    against ``moe_ref`` (dense) on the card, at 4096 tokens (a prefill)
    and at 16 (a serving decode step).  The same router runs in both, so
    the ids are equal; the outputs differ where a product over fewer rows
    rounds differently (within MOE_TOL of max |y|).  Times per call
    (CUDA events) and device operations per call (the profiler)."""
    import torch

    from repro_torch.models import moe

    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        t_start = time.perf_counter()
        cfg, p = moe_layer(arch, seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for tokens in (4096, 16):
            x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                            device="cuda").to(cfg.compute_dtype())
            with recorded_routing() as calls:
                routed = moe.moe_apply(p, x, cfg)
            dense = moe.moe_ref(p, x, cfg)
            torch.cuda.synchronize()
            ids = calls[0][0]
            rows = torch.bincount(ids.flatten().long(),
                                  minlength=cfg.moe.n_experts).tolist()
            err = float((routed.float() - dense.float()).abs().max())
            top = float(dense.float().abs().max())
            check(bool(torch.isfinite(routed).all()),
                  f"moe_routed/{arch}: non-finite output")
            check(err <= MOE_TOL * top, f"moe_routed/{arch}/{tokens}: routed "
                  f"and dense differ by {err} (max |y| {top})")
            iters = 5 if tokens > 16 else 20
            routed_ms = time_ms(lambda: moe.moe_apply(p, x, cfg), iters,
                                warmup=2)
            dense_ms = time_ms(lambda: moe.moe_ref(p, x, cfg), iters,
                               warmup=2)
            ops_r = device_ops_per_call(lambda: moe.moe_apply(p, x, cfg), 3)
            ops_d = device_ops_per_call(lambda: moe.moe_ref(p, x, cfg), 3)
            emit("moe_routed", arch=arch, tokens=tokens,
                 n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                 experts_routed=sum(n > 0 for n in rows),
                 rows_per_expert=rows, max_abs_diff=err, max_abs_y=top,
                 rel_diff=err / top, tol_rel=MOE_TOL, routed_ms=routed_ms,
                 dense_ms=dense_ms,
                 routed_ops_per_call=ops_r["ops_per_call"],
                 routed_device_us=ops_r["device_us_per_call"],
                 dense_ops_per_call=ops_d["ops_per_call"],
                 dense_device_us=ops_d["device_us_per_call"])
        emit("moe_routed_done", arch=arch, wall_s=time.perf_counter() - t_start)
        del p
        torch.cuda.empty_cache()


# launch.serve's --backend real defaults (the reference launch's)
SERVE_REAL = dict(n_pods=2, n_sessions=16, n_requests=64,
                  tokens_per_request=4, locality=0.8, max_len=256, seed=0)
SERVE_REAL_HELD_REQUESTS = 32  # the held phase's cut: half the requests


@contextlib.contextmanager
def checked_backend(first_logits: list):
    """RealBackend with its migrations and steps watched: every transfer
    of a column the source held must return ``nbytes_session()`` and land
    bitwise on the destination (timed, synchronised); each step's decoded
    rows are counted; the first decode's logits go to ``first_logits``."""
    import torch

    from repro_torch.models import decoder
    from repro_torch.serve.engine import RealBackend

    stats = dict(moves=0, empty_moves=0, move_us=[], steps=0, decoded=0)
    plain_transfer, plain_step = RealBackend.transfer, RealBackend.step
    plain_decode = decoder.decode_step

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def transfer(self, src, dst, sid):
        if not self.stores[src].has(sid):
            stats["empty_moves"] += 1
            return plain_transfer(self, src, dst, sid)
        column = self.stores[src].export_session(sid)["tree"]
        sync(self.stores[src].device)
        t0 = time.perf_counter()
        shipped = plain_transfer(self, src, dst, sid)
        sync(self.stores[dst].device)
        stats["move_us"].append((time.perf_counter() - t0) * 1e6)
        check(shipped == self.stores[dst].nbytes_session(),
              f"serve_real: a transfer shipped {shipped} bytes, the column "
              f"is {self.stores[dst].nbytes_session()}")
        landed = self.stores[dst].export_session(sid)["tree"]
        check(all(torch.equal(a[m][k], b[m][k])
                  for a, b in zip(column, landed) for m in a for k in a[m]),
              "serve_real: a migrated column differs from the exported one")
        stats["moves"] += 1
        return shipped

    def step(self, pod, sids):
        if sids:
            stats["steps"] += 1
            stats["decoded"] += len(sids)
        return plain_step(self, pod, sids)

    def decode(*args, **kw):
        out = plain_decode(*args, **kw)
        if not first_logits:
            first_logits.append(out[0].float().cpu())
        return out

    RealBackend.transfer, RealBackend.step = transfer, step
    decoder.decode_step = decode
    try:
        yield stats
    finally:
        RealBackend.transfer, RealBackend.step = plain_transfer, plain_step
        decoder.decode_step = plain_decode


def serve_real_run(cfg, params, device, requests=None, **mesh_kw) -> dict:
    """One ``launch.serve.serve_real`` run at SERVE_REAL (``requests``:
    that many of its requests), watched; the engine's metrics, the
    backend's counts, the first step's logits and its routing, and the
    wall.  ``mesh_kw``: serve_real's ``mesh`` and ``seq_axis``."""
    import torch

    from repro_torch.launch.serve import serve_real
    from repro_torch.models import common

    first = []
    with recorded_routing() as routing, checked_backend(first) as stats:
        t0 = time.perf_counter()
        kw = dict(SERVE_REAL, n_requests=requests or SERVE_REAL["n_requests"])
        eng = serve_real(cfg, params, device=device, **kw, **mesh_kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    check(not any(eng.queues) and not eng.certifier.has_pending(),
          "serve_real: requests left undecoded after the drain")
    m = eng.metrics.as_dict()
    check(m["tokens"] == stats["decoded"] > 0,
          f"serve_real: the metrics count {m['tokens']} tokens, the backend "
          f"decoded {stats['decoded']}")
    n_moe = sum(k.ffn == "moe" for k in common.layer_plan(cfg).kinds)
    return dict(metrics=m, stats=stats, first_logits=first[0],
                first_routing=routing[:n_moe], wall_s=wall,
                steps=eng.metrics.steps,
                column_bytes=eng.backend.stores[0].nbytes_session())


def serve_real_phase(layers: dict, seed: int = 11) -> dict:
    """The reference launch's ``--backend real`` loop at its defaults
    (SERVE_REAL) with RealBackend on the card, each arch of ``layers`` at
    full width, depth cut to its count there.  Returns the flash
    launches of each run by variant."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    from repro_torch.serve.engine import MultiPodEngine

    dev = torch.device("cuda")
    out = {}
    for arch, n_layers in layers.items():
        t_start = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        params = common.init_params(cfg, torch.Generator(
            device=dev).manual_seed(seed), dev, cfg.compute_dtype())
        fa.launches = 0                              # just before the path
        fa.variant_launches.update(dict.fromkeys(fa.VARIANTS, 0))
        with sites_of_call(f"serve_real/{arch}/engine_step", MultiPodEngine,
                           "run_step", nth=4):
            run = serve_real_run(cfg, params, dev)
        counts = dict(fa.variant_launches)
        st, m = run["stats"], run["metrics"]
        n_attn = sum(k.mixer in ATTN_MIXERS
                     for k in common.layer_plan(cfg).kinds)
        want = dict.fromkeys(fa.VARIANTS, 0)
        if cfg.mla is None:        # MLA decodes in absorbed einsums
            want["decode_split"] = n_attn * st["steps"]
        check(counts == want, f"serve_real/{arch}: flash launches {counts}, "
              f"expected {want} ({st['steps']} decode steps)")
        check(st["moves"] > 0, f"serve_real/{arch}: no KV column migrated")
        check(m["transfers"] == st["moves"] + st["empty_moves"],
              f"serve_real/{arch}: {m['transfers']} transfers counted, "
              f"{st['moves']} + {st['empty_moves']} made")
        emit("serve_real", arch=arch, n_layers=n_layers, d_model=cfg.d_model,
             **SERVE_REAL, n_slots=max(8, SERVE_REAL["n_sessions"]),
             flash_launches=counts, decode_steps=st["steps"],
             engine_steps=run["steps"], tokens=m["tokens"],
             transfers=m["transfers"], kv_moves=st["moves"],
             column_bytes=run["column_bytes"], wire_GB=m["wire_GB"],
             kv_move_us_mean=float(np.mean(st["move_us"])),
             kv_move_us_max=float(np.max(st["move_us"])),
             wall_s=run["wall_s"],
             ms_per_engine_step=1e3 * run["wall_s"] / run["steps"],
             decoded_tok_s=m["tokens"] / run["wall_s"],
             forwards=m["forwards"], local=m["local"])
        out[arch] = counts
        emit("serve_real_done", arch=arch, wall_s=time.perf_counter() - t_start)
        del params, run
        torch.cuda.empty_cache()
    return out


def serve_real_held_phase(layers: dict, seed: int = 12) -> None:
    """The same loop, cut to SERVE_REAL_HELD_REQUESTS requests, for each
    arch of ``layers`` at full width and that depth, on the card and on
    the CPU through the port, the same bf16 weights: engine metrics equal
    key for key (but the wall-clock
    ``plan_block_s``: the engine's routing does not read token values),
    the first decode step's logits within HELD_TOL (rows whose expert
    routing differs, near-ties, left out)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common

    for arch, n_layers in layers.items():
        t_start = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        dev = torch.device("cuda")
        on_card = common.init_params(cfg, torch.Generator(
            device=dev).manual_seed(seed), dev, cfg.compute_dtype())
        on_cpu = to_cpu(on_card)
        card = serve_real_run(cfg, on_card, dev, SERVE_REAL_HELD_REQUESTS)
        host = serve_real_run(cfg, on_cpu, torch.device("cpu"),
                              SERVE_REAL_HELD_REQUESTS)
        a, b = dict(card["metrics"]), dict(host["metrics"])
        check(a.pop("plan_block_s") >= 0 and b.pop("plan_block_s") >= 0,
              "serve_real_held: plan_block_s < 0")
        check(a == b, f"serve_real_held/{arch}: the cuda run's metrics "
              f"differ from the cpu run's")
        flips, noise = routing_flips(
            card["first_routing"], host["first_routing"],
            f"serve_real_held/{arch}", len(card["first_routing"]))
        keep = [not any(r in f for f in flips)
                for r in range(len(card["first_logits"]))]
        agree = compare_logits([card["first_logits"]],
                               [host["first_logits"]], [keep])
        k = torch.tensor(keep, dtype=torch.bool)
        check(torch.allclose(card["first_logits"][k],
                             host["first_logits"][k], atol=HELD_TOL,
                             rtol=HELD_TOL),
              f"serve_real_held/{arch}: the first step's logits differ "
              f"({agree['max_abs_diff']})")
        emit("serve_real_held", arch=arch, n_layers=n_layers, tol=HELD_TOL,
             tokens=a["tokens"], transfers=a["transfers"],
             metrics_equal=True, router_noise=noise, cuda_s=card["wall_s"],
             cpu_s=host["wall_s"],
             wall_s=time.perf_counter() - t_start, **agree)
        del on_card, on_cpu, card, host
        torch.cuda.empty_cache()


# -- phases 11-14: serving, the placement planner --------------------------

# benchmarks/serve_locality.py's (policy, arbitration) grid and localities
SERVE_GRID = [("local", "steps"), ("short", "steps"), ("short", "priced"),
              ("short", "hybrid"), ("long", "steps"), ("long", "priced"),
              ("long", "hybrid")]
SERVE_LOCALITIES = (0.0, 0.5, 0.9)
PLAN_LOCALITIES = (0.0, 0.7, 0.9)      # benchmarks/planner.py's
SEEDS = (0, 1, 2)
SERVE_CELLS = [(policy, arb, loc, seed) for policy, arb in SERVE_GRID
               for loc in SERVE_LOCALITIES for seed in SEEDS]


def same_result(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("point", "metrics", "router"))


def serve_runs(device: str, jax_min: int, sanitize: bool = False) -> tuple:
    """Every serve cell on ``device``, drains counted; (results, stats,
    lease launches, wall s)."""
    import torch

    import repro_torch.serve.certifier as certifier_mod
    from repro_torch.launch.serve import run_point

    t0 = time.perf_counter()
    reset_launches()                    # just before the path
    with DrainStats(certifier_mod) as stats:
        out = [run_point("mixtral-8x7b", policy, loc, seed=seed,
                         arbitration=arb, device=device, jax_min=jax_min,
                         sanitize=sanitize)
               for policy, arb, loc, seed in SERVE_CELLS]
        if device == "cuda":
            torch.cuda.synchronize()
    return out, stats, lease_launches(), time.perf_counter() - t0


def serve_phase() -> dict:
    """The serving path at serve_locality's defaults (mixtral-8x7b KV
    sizes, 8 pods, 256 sessions, 80 steps): every GRID pair x locality x
    seed on cuda and on cpu, identical; then the same with every
    certification batch packed (``jax_min=1``), where each batch must
    launch ``drain`` once and ``gather`` never.  Returns the card's drain
    launches by ``jax_min`` and its ``jax_min=1`` results."""
    from repro_torch.serve.certifier import StepCertifier

    launched, results = {}, {}
    for jax_min in (8, 1):
        with contextlib.ExitStack() as once:
            if jax_min == 1:
                once.enter_context(sites_of_call(
                    "serve/certifier_drain", StepCertifier, "drain", nth=3,
                    when=lambda self, pod: len(self.pending[pod])
                    >= self.jax_min))
            card, stats, launches, card_s = serve_runs("cuda", jax_min)
        host, _, _, cpu_s = serve_runs("cpu", jax_min)
        for i, (a, b) in enumerate(zip(card, host)):
            check(same_result(a, b), f"serve (jax_min {jax_min}): run {i} "
                  f"differs between cuda and cpu")
        batches = sum(r["metrics"]["cert_batches"] for r in card)
        check(launches["drain"] == stats.drains == launches["all"],
              f"serve: {launches['drain']} drain launches for "
              f"{stats.drains} packed batches")
        check(launches["gather"] == 0,
              f"serve: gather launched {launches['gather']} times")
        if jax_min == 1:
            check(stats.drains == batches > 0,
                  f"serve: {stats.drains} packed batches for {batches} "
                  f"certification batches")
        launched[jax_min] = launches["drain"]
        results[jax_min] = card
        by_loc = {loc: [r["point"] for r, cell in zip(card, SERVE_CELLS)
                        if cell[2] == loc] for loc in SERVE_LOCALITIES}
        emit("serve", jax_min=jax_min, runs=len(card), cert_batches=batches,
             certified=sum(r["metrics"]["certified"] for r in card),
             cert_aborts=sum(r["metrics"]["cert_aborts"] for r in card),
             cert_max_batch=max(r["metrics"]["cert_max_batch"] for r in card),
             kernel_drains=stats.drains, kernel_txns=stats.txns,
             variant_launches={k: v for k, v in launches.items()
                               if k != "all"},
             drain_plans=stats.plans, largest_B=stats.largest["B"],
             largest_n_dirty=stats.largest["n_dirty"],
             validate_s=stats.validate_s, cuda_s=card_s, cpu_s=cpu_s,
             # simulated: a priced TPU pod, not the card's speed
             sim_tokens_per_s_mean={str(loc): float(np.mean(
                 [p["tokens_per_s"] for p in pts]))
                 for loc, pts in by_loc.items()},
             wire_GB_mean={str(loc): float(np.mean(
                 [p["wire_GB"] for p in pts])) for loc, pts in by_loc.items()})
    return launched, results[1]


def serve_plan_phase() -> None:
    """benchmarks/planner.py's sweep with the planner on (8 pods, 96
    sessions, 160 steps, SERVE_PLAN_DEFAULTS, ROUTER_DEFAULTS), with
    asynchronous plan epochs (the engine's default, scored on a side
    stream on the card) and synchronous ones: cuda identical to cpu in
    each mode; plan_moves > 0 at locality 0.9.  The two modes differ from
    each other by design (an async epoch's moves land one step later), as
    in the reference; the cells where they do are printed."""
    from repro_torch.dist.locality import ROUTER_DEFAULTS
    from repro_torch.launch.serve import run_point
    from repro_torch.plan import SERVE_PLAN_DEFAULTS

    cells = [(loc, seed) for loc in PLAN_LOCALITIES for seed in SEEDS]
    runs, wall = {}, {}
    for mode, plan_async in (("async", True), ("sync", False)):
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[f"{device}_{mode}"] = [run_point(
                "mixtral-8x7b", ROUTER_DEFAULTS.policy, loc, n_sessions=96,
                steps=160, seed=seed,
                arbitration=ROUTER_DEFAULTS.arbitration,
                plan_epoch_ms=SERVE_PLAN_DEFAULTS.epoch_ms, device=device,
                plan_async=plan_async) for loc, seed in cells]
            wall[f"{device}_{mode}"] = time.perf_counter() - t0
        for i, (a, b) in enumerate(zip(runs[f"cuda_{mode}"],
                                       runs[f"cpu_{mode}"])):
            check(same_result(a, b), f"serve_plan ({mode}): run {i} differs "
                  f"between cuda and cpu")
        hi = [r["point"]["plan_moves"] for r, (loc, _) in
              zip(runs[f"cuda_{mode}"], cells) if loc == 0.9]
        check(sum(hi) > 0, f"serve_plan ({mode}): no planned move at "
              f"locality 0.9")
    # the serving entry point itself, planner on: cuda against cpu
    from repro_torch.launch.serve import main as serve_main

    argv = ["--backend", "sim", "--arch", "mixtral-8x7b", "--preset", "full",
            "--pods", "8", "--sessions", "96", "--requests", "2000",
            "--plan-epoch-ms", "5"]
    with contextlib.redirect_stdout(io.StringIO()):   # its report lines
        launched = [serve_main(argv + ["--device", d])
                    for d in ("cuda", "cpu")]
    for m in launched:
        check(m.pop("plan_block_s") >= 0.0, "launch.serve: plan_block_s < 0")
    check(launched[0] == launched[1],
          "launch.serve: the cuda run differs from the cpu run")
    emit("serve_plan", runs=len(cells),
         launch_serve={k: launched[0][k] for k in (
             "tokens", "forwards", "transfers", "plan_epochs", "plan_moves")},
         plan_epochs=sum(r["metrics"]["plan_epochs"]
                         for r in runs["cuda_async"]),
         points={f"{loc}/{seed}": r["point"] for r, (loc, seed) in
                 zip(runs["cuda_async"], cells)},
         async_differs_from_sync=[
             f"{loc}/{seed}" for a, b, (loc, seed) in
             zip(runs["cuda_async"], runs["cuda_sync"], cells)
             if not same_result(a, b)],
         plan_block_s={k: sum(r["plan_block_s"] for r in v)
                       for k, v in runs.items()},
         wall_s=wall)


def plan_score_phase(reps: int = 20) -> dict:
    """The scorer at the planner bench's overlap shape (2^17 classes x 16
    nodes) on the card: bitwise equal to ``score_moves_np`` (the overlap
    cell's knobs, and a looser dominance share so that many scores are
    finite); then, as ``benchmarks/planner.py::overlap_cell`` times it,
    sync ms (dispatch + wait), kick ms and harvest ms around host work
    standing in for decode steps, the CPU's torch and numpy times, and the
    bound: the inputs' and the output's bytes at 3.35 TB/s."""
    from repro_torch.plan.score import (score_moves, score_moves_async,
                                        score_moves_np)

    n_classes, n_nodes = 1 << 17, 16
    rng = np.random.default_rng(0)
    rates = (rng.random((n_classes, n_nodes)) * 0.05).astype(np.float32)
    owner = rng.integers(0, n_nodes, n_classes).astype(np.int32)
    fwd_cost = np.full(n_classes, 2e-4, np.float32)
    move_cost = np.full(n_classes, 1e-3, np.float32)
    cpu = (rng.random(n_nodes) * 0.5).astype(np.float64)
    args = (rates, owner, fwd_cost, move_cost, cpu)
    kw = dict(horizon_ms=500.0, margin=3.0, min_frac=0.7, min_rate=0.016,
              load_gain=0.02)
    finite = {}
    for label, knobs in (("overlap", kw), ("loose", dict(kw, min_frac=0.07,
                                                         min_rate=0.0))):
        want = score_moves_np(*args, **knobs)
        got = score_moves(*args, device="cuda", **knobs)
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              f"plan_score/{label}: {int((got.view(np.uint32) != want.view(np.uint32)).sum())} "
              f"scores differ from score_moves_np in their bits")
        finite[label] = int(np.isfinite(want).sum())
    decode = [np.ones(1 << 20) for _ in range(2)]

    def decode_steps(n: int = 12) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            decode[0] = decode[0] + decode[1]
        return time.perf_counter() - t0

    record_sites("plan_score/score_harvest", lambda: score_moves_async(
        *args, device="cuda", **kw).wait())
    t = dict(sync=0.0, kick=0.0, harvest=0.0, decode=0.0, cpu_torch=0.0,
             numpy=0.0)
    for _ in range(reps):
        t0 = time.perf_counter()
        score_moves(*args, device="cuda", **kw)
        t["sync"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        fut = score_moves_async(*args, device="cuda", **kw)
        t["kick"] += time.perf_counter() - t0
        t["decode"] += decode_steps()
        t0 = time.perf_counter()
        fut.wait()
        t["harvest"] += time.perf_counter() - t0
    for _ in range(max(3, reps // 4)):
        t0 = time.perf_counter()
        score_moves(*args, device="cpu", **kw)
        t["cpu_torch"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        score_moves_np(*args, **kw)
        t["numpy"] += time.perf_counter() - t0
    ms = {f"{k}_ms": v * 1e3 / (reps if k in ("sync", "kick", "harvest",
                                               "decode") else max(3, reps // 4))
          for k, v in t.items()}
    n_bytes = 4 * (2 * rates.size + 3 * n_classes + n_nodes)
    out = dict(n_classes=n_classes, n_nodes=n_nodes, reps=reps,
               finite=finite, **ms,
               off_path_frac=1.0 - (ms["kick_ms"] + ms["harvest_ms"])
               / max(ms["sync_ms"], 1e-9),
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    emit("plan_score", **out)
    return out


def sim_plan_phase(main_cfg: dict) -> dict:
    """The main TPC-C run with the planner on (``SIM_PLAN_DEFAULTS``), on
    cuda and on cpu: byte-identical stores and metrics, planner epochs and
    prefetches issued, every drain through ``drain``."""
    from repro_torch.plan import SIM_PLAN_DEFAULTS

    cfg = dict(main_cfg, plan=SIM_PLAN_DEFAULTS)
    card = run_cluster("tpcc", "cuda", cfg)
    m = card["metrics"]
    emit("sim_plan", device="cuda", plan_epochs=m["plan_epochs"],
         plan_prefetches=m["plan_prefetches"], **summary(card))
    check_drains("sim_plan", card)
    check(m["plan_epochs"] > 0 and m["plan_prefetches"] > 0,
          f"sim_plan: {m['plan_epochs']} epochs, {m['plan_prefetches']} "
          f"prefetches")
    host = run_cluster("tpcc", "cpu", cfg)
    emit("sim_plan", device="cpu", **summary(host))
    compare_runs("sim_plan", card, host)
    return card


def serve_drain_case(rng, n: int, b: int, n_dirty: int) -> dict:
    """The drain kernel at the serving certifier's shape: B forwards (the
    row count bucketed as ``pack_drain`` does) each reading one session
    (R bucketed to 8), W = 0 and no class view, an n-entry epoch table
    and n_dirty pending epoch stamps; bitwise against
    ``ref.lease_drain_ref`` on ok and on the flushed table, timed like
    ``drain_case``."""
    import torch

    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    bp, r = max(8, 1 << (b - 1).bit_length()), 8
    table = rng.integers(0, 1000, n).astype(np.int32)
    dirty = rng.choice(n, n_dirty, replace=False).astype(np.int32)
    dirty_ver = (table[dirty] + 1).astype(np.int32)
    items = np.full((bp, r), -1, np.int32)
    items[:b, 0] = rng.choice(np.concatenate([dirty, rng.integers(0, n, b)]),
                              b)
    flushed = table.copy()
    flushed[dirty] = dirty_ver
    vers = np.zeros((bp, r), np.int32)
    vers[:b, 0] = np.where(rng.random(b) < 0.8, flushed[items[:b, 0]],
                           table[items[:b, 0]])
    staging = lv.DrainStaging(dev)
    v = staging.begin(n_dirty, bp, r, 0, 0, 0)
    v.dirty_idx[:] = dirty
    v.dirty_ver[:] = dirty_ver
    v.read_items[:] = items
    v.read_versions[:] = vers
    on = {k: torch.from_numpy(a).to(dev) for k, a in (
        ("dirty_idx", dirty), ("dirty_ver", dirty_ver), ("items", items),
        ("vers", vers))}
    want_table = torch.from_numpy(table).to(dev)
    plain = lambda: ref.lease_drain_ref(
        want_table, on["dirty_idx"], on["dirty_ver"], None, None, 0,
        on["items"], on["vers"], None)
    want = plain().cpu().numpy()
    dev_table = torch.from_numpy(table).to(dev)
    before = lv.launches
    got = lv.lease_drain(dev_table, staging, None).copy()
    check(np.array_equal(got, want), f"serve drain B{b}: ok disagrees with "
          f"ref.lease_drain_ref ({int((got != want).sum())} rows)")
    check(torch.equal(dev_table, want_table),
          f"serve drain B{b}: flushed another table than the twin")
    kernel = lambda: lv.lease_drain(dev_table, staging, None)
    n_bytes = 8 * n_dirty + 8 * bp * r + 4 * b + 4 * n_dirty + bp
    out = dict(case=f"serve_B{b}", n_items=n, B=bp, R=r, W=0, n_classes=0,
               n_dirty=n_dirty, passing=int(want[:b].sum()),
               max_abs_err=int(np.abs(got.astype(np.int32)
                                      - want.astype(np.int32)).max()),
               ms=wall_us(kernel, 2000) / 1e3,
               graph_ms=graph_ms(lambda: lv.lease_drain(
                   dev_table, staging, None, wait=False)),
               plain_ms=time_ms(plain, 500), plain_graph_ms=graph_ms(plain),
               bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, calls=lv.launches - before)
    emit("kernel_drain", **out)
    return out


# -- phases 15-20: runtime analysis on the card ------------------------------

SANITIZER_KEYS = ("sanitizer", "verified_replicas", "check_write_locks_calls",
                  "class_view_calls", "write_slots_checked", "enabled_checks")


# forced_sanitized's cut: 600 of the forced run's 2000 simulated ms (the
# 200 ms warm-up and node 3's failure at 120 ms stay inside it)
FORCED_SANITIZED_MS = 600.0


def sanitized_phase(phase: str, workload: str, cfg_kw: dict,
                    plain_card: dict, fail_at=None) -> dict:
    """``cfg_kw``'s run on cuda with ``sanitize=True``: byte-identical to
    the unsanitized cuda run ``plain_card`` (stores and metrics), every
    drain through ``drain`` and checked by ``check_write_locks`` with the
    ``ClassLocks`` it used; then the same sanitized run on the cpu, with
    equal stores, metrics, sanitizer counters and check counts."""
    kw = dict(cfg_kw, sanitize=True)
    card = run_cluster(workload, "cuda", kw, fail_at=fail_at)
    emit(phase, device="cuda", run_s_unsanitized=plain_card["run_s"],
         device_versions_equal_host=True,
         n_checks=sum(c["checks"] for c in card["sanitizer"]),
         **{k: card[k] for k in SANITIZER_KEYS}, **summary(card))
    check_drains(phase, card)
    compare_runs(phase, card, plain_card, "sanitized and unsanitized cuda")
    check(card["check_write_locks_calls"] == card["class_view_calls"]
          == card["metrics"]["cert_batches"] > 0,
          f"{phase}: {card['check_write_locks_calls']} write-lock checks "
          f"({card['class_view_calls']} with the drain's class view) for "
          f"{card['metrics']['cert_batches']} certification batches")
    check(card["write_slots_checked"] > 0,
          f"{phase}: no write slot was checked")
    host = run_cluster(workload, "cpu", kw, fail_at=fail_at)
    emit(phase, device="cpu", **{k: host[k] for k in SANITIZER_KEYS},
         **summary(host))
    compare_runs(phase, card, host)
    for k in SANITIZER_KEYS:
        check(card[k] == host[k], f"{phase}: {k} differs between cuda and "
              f"cpu: {card[k]} / {host[k]}")
    return card


def serve_sanitized_phase(plain: list) -> int:
    """Phase 11's runs at ``jax_min`` 1 with ``sanitize=True`` on cuda,
    each equal to the unsanitized cuda run key for key; every forward the
    drain kernel passes is checked at its session's owner.  Returns the
    drain launches."""
    card, stats, launches, card_s = serve_runs("cuda", 1, sanitize=True)
    for i, (a, b) in enumerate(zip(card, plain)):
        check(same_result(a, b), f"serve_sanitized: run {i} differs from "
              f"the unsanitized cuda run")
    batches = sum(r["metrics"]["cert_batches"] for r in card)
    check(launches["drain"] == stats.drains == launches["all"] == batches
          > 0, f"serve_sanitized: {launches['drain']} drain launches for "
          f"{stats.drains} packed batches, {batches} certification batches")
    emit("serve_sanitized", device="cuda", runs=len(card),
         cert_batches=batches, kernel_drains=stats.drains,
         variant_launches={k: v for k, v in launches.items() if k != "all"},
         owner_checked=sum(r["metrics"]["certified"] for r in card),
         validate_s=stats.validate_s, cuda_s=card_s)
    return launches["drain"]


def explore_phase() -> None:
    """The explorer's smoke grid (``run_smoke``: SMOKE_CELLS with the POR
    check) on cuda and on cpu: violation-free, every cell's ExploreStats
    equal across the devices, the POR reduction at least 2x."""
    from repro_torch.analysis.explore import run_smoke

    records, walls = {}, {}
    for device in ("cuda", "cpu"):
        rec = []
        t0 = time.perf_counter()
        rc = run_smoke(check_reduction=True, quiet=True, device=device,
                       record=rec)
        walls[device] = time.perf_counter() - t0
        check(rc == 0, f"explore: run_smoke on {device} exited {rc}")
        records[device] = rec
    def runs(st: dict) -> int:
        return st["schedules"] + st["pruned_sleep"] + st["states_deduped"]

    cells = []
    for (name, args, a, a_s), (_, _, b, b_s) in zip(records["cuda"],
                                                    records["cpu"]):
        sa = dataclasses.asdict(a if name == "naive" else a.stats)
        sb = dataclasses.asdict(b if name == "naive" else b.stats)
        check(sa == sb, f"explore: {name} {args}: ExploreStats differ "
              f"between cuda and cpu: {sa} / {sb}")
        if name != "naive":
            check(a.ok and b.ok, f"explore: {name} {args} found a violation")
        cells.append(dict(name=name, args=args, stats=sa, cuda_s=a_s,
                          cpu_s=b_s, cuda_runs_per_s=runs(sa) / a_s,
                          cpu_runs_per_s=runs(sa) / b_s))
    ratio = runs(cells[-1]["stats"]) / max(1, runs(cells[0]["stats"]))
    check(ratio >= 2.0, f"explore: POR reduction {ratio:.2f}x below 2x")
    emit("explore", cells=cells, por_ratio=ratio, cuda_s=walls["cuda"],
         cpu_s=walls["cpu"])


def explore_kernel_phase() -> int:
    """KERNEL_CELL (smoke-bank batched/drain, 1.5 ms, ``jax_min`` 1):
    exhaustive exploration in which every drain of every schedule launches
    ``drain`` and every settle runs on the device; violation-free, its
    ExploreStats equal to the same exploration on the cpu (the twin
    ``ref.lease_drain_ref`` deciding); drain launches, runs/s, per-drain
    wall, and the store staging areas made and still alive at the end
    (pinned bytes on the card): explored clusters are freed by the cyclic
    collector, not at once.  Returns the card's drain launches."""
    import gc
    import weakref

    import repro_torch.core.cluster as cluster_mod
    from repro_torch.analysis.explore import KERNEL_CELL, explore_scenario
    from repro_torch.kernels import lease_validate as lv

    name, args, cfg = KERNEL_CELL
    out = {}
    init = lv.DrainStaging.__init__
    for device in ("cuda", "cpu"):
        gc.collect()
        made = weakref.WeakSet()
        n_made = [0]

        def tracked(staging, *a, **kw):
            init(staging, *a, **kw)
            made.add(staging)
            n_made[0] += 1

        lv.DrainStaging.__init__ = tracked
        t0 = time.perf_counter()
        reset_launches()                # just before the path
        try:
            with DrainStats(cluster_mod) as drains, SettleStats() as settles, \
                    SanitizerStats() as checks:
                res = explore_scenario(name, cfg, dict(args, device=device))
        finally:
            lv.DrainStaging.__init__ = init
        wall = time.perf_counter() - t0
        launches = lease_launches()
        check(res.ok, f"explore_kernel on {device}: "
              f"{None if res.ok else res.violation.violation}")
        check(not res.stats.truncated,
              f"explore_kernel on {device}: truncated")
        live = list(made)
        stats = dataclasses.asdict(res.stats)
        out[device] = dict(
            stats=stats, wall_s=wall, runs_per_s=res.stats.runs / wall,
            kernel_drains=drains.drains, kernel_txns=drains.txns,
            validate_s=drains.validate_s,
            per_drain_us=drains.validate_s / max(1, drains.drains) * 1e6,
            drain_plans=drains.plans, largest_B=drains.largest["B"],
            variant_launches={k: v for k, v in launches.items()
                              if k != "all"},
            staging_made=n_made[0], staging_live=len(live),
            pinned_bytes=sum(o.nbytes for o in live
                             if o.device.type == "cuda"),
            **settles.as_dict(), **checks.as_dict())
        emit("explore_kernel", device=device, **out[device])
    card = out["cuda"]
    check(card["stats"] == out["cpu"]["stats"],
          f"explore_kernel: ExploreStats differ between cuda and cpu: "
          f"{card['stats']} / {out['cpu']['stats']}")
    n = card["variant_launches"]
    check(n["drain"] == card["kernel_drains"] > 0 and n["gather"] == 0,
          f"explore_kernel: {n} launches for {card['kernel_drains']} drains")
    check(card["settle_calls"] > 0 and card["enabled_checks"] > 0,
          "explore_kernel: no settle ran through the device ops")
    for k in ("kernel_drains", "kernel_txns", "settle_calls",
              "write_slots_checked", "enabled_checks"):
        check(card[k] == out["cpu"][k], f"explore_kernel: {k} differs "
              f"between cuda and cpu: {card[k]} / {out['cpu'][k]}")
    return n["drain"]


def drain_kernel_mutants() -> dict:
    """The drain kernel's own write-lock violations on the card: a
    ``validate_batch(class_locks=)`` drain handed stale class owners (the
    class of the written item is leased to proc 1 in the lease layer's
    view, unowned in the drain's) passes the write, and
    ``check_write_locks`` names it from the stale view; a drain whose
    verdict passes that write is named from the pass side, recomputed on
    the host.  With the live view the kernel itself refuses the write."""
    import torch

    from repro_torch.analysis.sanitizer import (SanitizerError,
                                                check_write_locks)
    from repro_torch.core.stm import (ClassLocks, Transaction,
                                      VersionedStore, validate_batch)
    from repro_torch.kernels import lease_validate as lv

    store = VersionedStore(3, device="cuda")
    item_cc = np.array([0, 1, 1], np.int32)
    owners = np.array([0, 1], np.int32)          # the lease layer's view
    txn = Transaction(txid=7, origin=0)
    txn.log_read(0, 0)
    txn.write_set[2] = 1.0
    forged = ClassLocks(torch.from_numpy(item_cc).to(store.device),
                        np.zeros(2, np.int32), 0)

    def drain(view):
        before = lv.variant_launches["drain"]
        ok = validate_batch(store, [txn], class_locks=view)
        check(lv.variant_launches["drain"] == before + 1,
              "mutants: the drain did not launch the drain kernel")
        return ok

    def named(*args):
        try:
            check_write_locks(*args)
        except SanitizerError as e:
            return e.invariant, e.detail
        return None, None

    out = {}
    ok = drain(forged)
    check(ok.tolist() == [True], f"mutants: the kernel refused the write "
          f"under the forged view: {ok.tolist()}")
    for case, locks in (("stale_owners", forged), ("leased_away", None)):
        inv, detail = named(0, owners, item_cc, locks, [txn], ok)
        check(inv == "write-locks", f"mutants: drain kernel {case}: "
              f"sanitizer named {inv!r} ({detail})")
        out[case] = dict(invariant=inv, detail=detail)
    live = forged._replace(owners=owners)
    ok = drain(live)
    check(ok.tolist() == [False] and named(0, owners, item_cc, live, [txn],
                                           ok) == (None, None),
          "mutants: the live view did not refuse the leased-away write")
    return out


def mutants_phase() -> None:
    """Every mutant of MUTANT_INVARIANTS re-found on the card by
    ``explore_scenario`` (exhaustive, window 0.6 ms, 400 schedules, as the
    CPU tests) with its invariant, the minimized trace naming it too; then
    the two drain-kernel forms."""
    from repro_torch.analysis.explore import ExploreConfig, explore_scenario
    from repro_torch.analysis.scenarios import MUTANT_INVARIANTS

    cfg = ExploreConfig(strategy="exhaustive", window_ms=0.6,
                        max_schedules=400)
    found = {}
    t0 = time.perf_counter()
    for name, want in sorted(MUTANT_INVARIANTS.items()):
        res = explore_scenario(name, cfg, {"device": "cuda"})
        check(not res.ok, f"mutants: {name} not found on the card")
        inv = res.violation.violation[0]
        check(inv == want == res.minimized.violation[0],
              f"mutants: {name} named {inv!r} (minimized "
              f"{res.minimized.violation[0]!r}), want {want!r}")
        found[name] = dict(invariant=inv,
                           runs=res.stats.runs,
                           deviations=len(res.minimized.deviations()))
    wall = time.perf_counter() - t0
    emit("mutants", device="cuda", found=found, n_found=len(found),
         drain_kernel=drain_kernel_mutants(), wall_s=wall)


# -- phases 21-23: single-device training ---------------------------------------

TRAIN_ARCH = "zamba2-1.2b"
TRAIN_ARGS = ["--no-mesh", "--arch", TRAIN_ARCH, "--preset", "full",
              "--steps", "4",
              "--batch", "2", "--seq", "2048", "--log-every", "1"]
HELD_TRAIN_LAYERS = 6          # zamba2 at full width: one shared site
HELD_TRAIN_LOSS_TOL = 1e-2     # cuda vs cpu train_step loss, relative
HELD_TRAIN_GRAD_TOL = 5e-2     # per leaf ||g_cuda - g_cpu|| / ||g_cpu||


# backward kernels against their plain versions: share of each input's
# largest |gradient|; the lse against the plain one, absolute
GRAD_TOL = {"attention": {"float32": 2e-5, "bfloat16": 2e-2},
            "ssd": {"float32": 1e-4, "bfloat16": 2e-2}}
GRAD_LSE_TOL = 1e-4
# the plain versions a kernel's path must not call on the card
PLAIN_FNS = ("sdpa_ref", "ssd_ref", "sdpa_bwd_ref", "ssd_bwd_ref",
             "sdpa_bwd_tc_ref", "ssd_bwd_tc_ref")


@contextlib.contextmanager
def plain_calls():
    """Inside the block, calls of the model kernels' plain versions
    (``ref``'s forwards and backwards) counted by name."""
    from repro_torch.kernels import ref

    counts = collections.Counter()
    saved = {name: getattr(ref, name) for name in PLAIN_FNS}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(ref, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def _grads(fn, inputs, weights):
    """``fn``'s outputs and the gradients of ``sum(out_i * weight_i)``
    (``weights`` pairs with ``fn``'s first outputs) for the inputs, fresh
    leaves each call."""
    import torch

    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              if t is not None else None for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
    return ([o.detach() for o in outs[:len(weights)]],
            torch.autograd.grad(loss, wanted))


def _rel_errs(got, want) -> list:
    """Per pair: max |got - want| over the largest |want|."""
    return [float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def _grad_checks(name: str, kind: str, dtype: str, g_k, g_p, g_a,
                 again, g_t=None, truth=None) -> dict:
    """The kernel's gradients against the fp32 plain backward, the ``tc``
    variant's plain twin (``g_t``, its bf16 roundings) where given, and
    autograd of the plain forward (GRAD_TOL of each input's largest
    |gradient|), and a second call's bits.  With ``truth`` (an fp64
    evaluation of the plain backward) the kernel and both plain sides are
    each held to it instead, their errors against each other reported."""
    import torch

    tol = GRAD_TOL[kind][dtype]
    vs_plain, vs_auto = _rel_errs(g_k, g_p), _rel_errs(g_k, g_a)
    vs_twin = _rel_errs(g_k, g_t) if g_t is not None else None
    same = [bool(torch.equal(a, b)) for a, b in zip(g_k, again)]
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(g_k, g_t if g_t is not None else g_p))
    fp64 = {}
    if truth is not None:
        fp64 = {f"rel_err_{side}_vs_fp64": _rel_errs(g, truth)
                for side, g in (("kernel", g_k), ("plain", g_p),
                                ("autograd", g_a))}
        check(max(max(v) for v in fp64.values()) <= tol,
              f"{name}: gradients off the fp64 plain backward by {fp64}, "
              f"limit {tol}")
    else:
        check(max(vs_plain) <= tol and max(vs_auto) <= tol
              and (vs_twin is None or max(vs_twin) <= tol),
              f"{name}: backward kernel gradients off by {vs_plain} (plain "
              f"backward) / {vs_twin} (its plain twin) / {vs_auto} (autograd "
              f"of the plain forward), limit {tol}")
    check(all(same), f"{name}: two backward calls differ ({same})")
    check(all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
              for g in g_k), f"{name}: a zero or non-finite gradient")
    return dict(grad_tol=tol, rel_err_vs_plain=vs_plain,
                rel_err_vs_twin=vs_twin, rel_err_vs_autograd=vs_auto,
                max_abs_err=abs_err, deterministic=all(same), **fp64)


def sdpa_backend(out) -> str:
    """The backend ``scaled_dot_product_attention`` took for ``out``, read
    from its autograd graph: ``flash``, ``efficient``, ``cudnn``, or
    ``math`` where no fused node is in it."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for key, backend in (("Flash", "flash"), ("Efficient", "efficient"),
                             ("Cudnn", "cudnn")):
            if f"ScaledDotProduct{key}" in fn.name():
                return backend
        todo.extend(f for f, _ in fn.next_functions)
    return "math"


def attention_grad_case(name: str, b, s, hq, hkv, dk, dv, *, causal=True,
                        window=None, cap=0.0, dtype="bfloat16",
                        timed=False, library=False, registers=None,
                        seed=21) -> dict:
    """The flash forward's lse and the flash backward kernels at one
    training shape (self-attention, positions 0..S-1): the lse within
    GRAD_LSE_TOL of the plain one, the output's bits equal with and
    without it (both timed); ``ops.attention`` under grad launches the
    backward once, its gradients held by :func:`_grad_checks`; the
    backward's time a call and its device time, its bound.  ``timed``
    adds the plain backward's, the Function's forward + backward, the old
    recompute's (autograd of the plain forward) and SDPA's; ``library``
    SDPA's backward alone.  Both name the backend SDPA takes.
    ``registers`` (the backward kernels' ptxas report at this pair) joins
    the record."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(td)
               for shape in ((b, s, hq, dk), (b, s, hkv, dk), (b, s, hkv, dv)))
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s) \
        .contiguous()
    kw = dict(q_positions=pos, kv_positions=pos, causal=causal,
              sliding_window=window, logit_softcap=cap)
    variant = fa.variant(td, s, hq, hkv, dk, dv)
    bwd_variant = fa.backward_variant(td, s, hq, hkv, dk, dv)
    weight = torch.randn((b, s, hq, dv), generator=gen, device=dev)
    dout = weight.to(td)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        bare = fa.flash_attention(q, k, v, **kw)
        _, lse_p = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    lse_err = float((lse - lse_p).abs().max())
    check(bool(torch.equal(out, bare)), f"{name}: the forward's output "
          f"changes when the lse is asked for")
    check(lse_err <= GRAD_LSE_TOL, f"{name}: lse off by {lse_err}")
    del lse_p

    before = dict(fa.backward_variant_launches)
    with plain_calls() as plain_n:
        _, g_k = _grads(lambda q, k, v: ops.attention(q, k, v, **kw),
                        (q, k, v), (weight,))
    ran = {k_: n - before[k_] for k_, n in fa.backward_variant_launches.items()}
    check(ran == {k_: int(k_ == bwd_variant) for k_ in ran} and not plain_n,
          f"{name}: backward launches {ran}, expected one {bwd_variant}; "
          f"plain calls {dict(plain_n)}")
    g_p = ref.sdpa_bwd_ref(q, k, v, out, lse, dout, **kw)
    g_t = (ref.sdpa_bwd_tc_ref(q, k, v, out, lse, dout, **kw)
           if bwd_variant == "tc" else None)
    _, g_a = _grads(lambda q, k, v: ref.sdpa_ref(q, k, v, **kw), (q, k, v),
                    (weight,))
    again = fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
    grads = _grad_checks(name, "attention", dtype, g_k, g_p, g_a, again, g_t)
    del g_p, g_t, g_a, again

    fwd_ms, fwd_g_ms, _ = timings(lambda: fa.flash_attention(q, k, v, **kw))
    lse_ms, lse_g_ms, _ = timings(
        lambda: fa.flash_attention(q, k, v, return_lse=True, **kw))
    bwd_ms, bwd_g_ms, iters = timings(
        lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, **kw))
    # work this data needs: the visible (row, key) pairs of every q head;
    # the backward's products S, dP, dV, dQ, dK (forward: S, P V); q, k,
    # v, out, dout and the lse read once, dq, dk, dv written once
    visible = ref.attn_mask(pos[:1], pos[:1], causal, window)
    pairs = int(visible.sum()) * b * hq
    el = q.element_size()
    n_bytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * out.numel()) \
        * el + 4 * lse.numel()
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" \
        else SPLIT_TF32_FLOPS_PER_S
    bms, by = op_bound(2.0 * pairs * (3 * dk + 2 * dv), n_bytes, rate)
    fbms, fby = op_bound(2.0 * pairs * (4 * dk + 3 * dv), n_bytes, rate)
    if dtype == "float32":   # the fp32 CUDA cores' bound beside split-TF32's
        grads["bwd_bound_fp32_ms"] = op_bound(
            2.0 * pairs * (3 * dk + 2 * dv), n_bytes, SCALAR_OPS_PER_S)[0]
    rec = dict(case=name, kind="attention", variant=variant,
               backward_variant=bwd_variant, dtype=dtype,
               shape=[b, s, hq, hkv, dk, dv], causal=causal, window=window,
               softcap=cap, lse_max_abs_err=lse_err, lse_tol=GRAD_LSE_TOL,
               out_bits_equal_without_lse=True, fwd_ms=fwd_ms,
               fwd_graph_ms=fwd_g_ms, fwd_lse_ms=lse_ms,
               fwd_lse_graph_ms=lse_g_ms, bwd_ms=bwd_ms,
               bwd_graph_ms=bwd_g_ms, bwd_bound_ms=bms, bwd_bound_by=by,
               fwd_bwd_bound_ms=fbms, fwd_bwd_bound_by=fby, **grads)
    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=hkv != hq).transpose(1, 2)

    if bwd_variant == "tc":
        # the CUDA-core kernels at the same shape, asked for by name
        rec["simt_bwd_ms"] = time_ms(
            lambda: fa.flash_attention_backward(q, k, v, out, lse, dout,
                                                variant="simt", **kw),
            2, warmup=1)
        rec["speedup_vs_simt"] = rec["simt_bwd_ms"] / bwd_ms
    if timed:
        no_grad = (q, k, v)

        def fwd_bwd(fn):
            def run():
                ls = [t.detach().requires_grad_(True) for t in no_grad]
                torch.autograd.grad(fn(*ls), ls, dout)
            return run

        n = max(3, iters // 4)
        rec["plain_bwd_ms"] = time_ms(
            lambda: ref.sdpa_bwd_ref(q, k, v, out, lse, dout, **kw), n,
            warmup=2)
        if bwd_variant == "tc":
            rec["twin_bwd_ms"] = time_ms(
                lambda: ref.sdpa_bwd_tc_ref(q, k, v, out, lse, dout, **kw),
                n, warmup=2)
        rec["fwd_bwd_ms"] = time_ms(
            fwd_bwd(lambda q, k, v: ops.attention(q, k, v, **kw)), n,
            warmup=2)
        rec["plain_fwd_bwd_ms"] = time_ms(
            fwd_bwd(lambda q, k, v: ref.sdpa_ref(q, k, v, **kw)), n,
            warmup=2)
        rec["library_fwd_bwd_ms"] = time_ms(fwd_bwd(library), n, warmup=2)
    if timed or library:
        ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = library(*ls)
        rec["library_backend"] = sdpa_backend(lib_out)
        rec["library_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(lib_out, ls, dout,
                                        retain_graph=True),
            max(3, iters // 4), warmup=2)
        del lib_out, ls
    if registers is not None:
        rec["registers"] = registers
    rec["wall_s"] = time.perf_counter() - t_start
    emit("kernel_grad", **rec)
    del q, k, v, out, lse, g_k
    torch.cuda.empty_cache()
    return rec


def ssd_grad_case(name: str, b, s, h, p, n, chunk, *, dtype="bfloat16",
                  timed=False, seed=22) -> dict:
    """The SSD backward kernels at one training shape, with h0 and the
    final state's gradient: ``ops.ssd`` under grad launches the backward
    once, its gradients (x, dt, A, B, C, h0) held by :func:`_grad_checks`;
    the backward's time a call and its device time, its bound.  ``timed``
    adds the plain backward's, the Function's forward + backward and the
    old recompute's (autograd of the plain forward)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ss

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    inputs = ssd_inputs(b, s, h, p, n, dtype, seed)
    x, dt, a, bm, cm, h0 = inputs
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    wy = torch.randn((b, s, h, p), generator=gen, device=dev)
    wf = torch.randn((b, h, p, n), generator=gen, device=dev)
    dy = wy.to(x.dtype)
    variant = ss.variant(x.dtype, p, n, chunk)
    bwd_variant = ss.backward_variant(x.dtype, p, n, chunk)

    def kernel(*t):
        return ops.ssd(*t[:5], chunk=chunk, h0=t[5])

    def plain(*t):
        y, final = ops.ssd(*t[:5], chunk=chunk, h0=t[5], plain=True)
        return y.to(t[0].dtype), final

    before = dict(ss.backward_variant_launches)
    with plain_calls() as plain_n:
        _, g_k = _grads(kernel, inputs, (wy, wf))
    ran = {k: c - before[k] for k, c in ss.backward_variant_launches.items()}
    check(ran == {k: int(k == bwd_variant) for k in ran} and not plain_n,
          f"{name}: backward launches {ran}, expected one {bwd_variant}; "
          f"plain calls {dict(plain_n)}")
    args = (x, dt, a, bm, cm, h0, dy, wf)
    g_p = ref.ssd_bwd_ref(*args, chunk=chunk)
    g_t = (ref.ssd_bwd_tc_ref(*args, chunk=chunk) if bwd_variant == "tc"
           else None)
    _, g_a = _grads(plain, inputs, (wy, wf))
    again = ss.ssd_scan_backward(*args, chunk=chunk)
    # f32: dA's f32 evaluations (kernel, plain) differ from each other by up
    # to the limit (tools/ssd_grad_digests.py), so each is held to fp64
    truth = (ref.ssd_bwd_ref(*(t.double() for t in args), chunk=chunk)
             if dtype == "float32" else None)
    grads = _grad_checks(name, "ssd", dtype, g_k, g_p, g_a, again, g_t,
                         truth)
    del g_p, g_t, g_a, again, truth

    bwd_ms, bwd_g_ms, iters = timings(
        lambda: ss.ssd_scan_backward(*args, chunk=chunk))
    # the forward's products at these shapes, twice for the backward; its
    # bytes: x, dy, dx, B, C, dB, dC in x's type, dt and ddt, a and da, h0,
    # dfinal and dh0 in fp32
    nc, tri = s // chunk, chunk * (chunk + 1) / 2
    fwd_flops = b * nc * (2 * tri * n + h * (2 * tri * p + 4 * chunk * p * n
                                             + 3 * tri))
    el = x.element_size()
    n_bytes = (3 * x.numel() + 2 * (bm.numel() + cm.numel())) * el \
        + 4 * (2 * dt.numel() + 2 * a.numel() + 3 * h0.numel())
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" \
        else SPLIT_TF32_FLOPS_PER_S
    bms, by = op_bound(2.0 * fwd_flops, n_bytes, rate)
    # forward + backward: x, B, C and dt, A read once, their gradients
    # and y written once
    fbms, fby = op_bound(3.0 * fwd_flops, 2 * (2 * x.numel() + bm.numel()
                                               + cm.numel()) * el
                         + 2 * 4 * (dt.numel() + a.numel()), rate)
    if dtype == "float32":   # the fp32 CUDA cores' bound beside split-TF32's
        grads["bwd_bound_fp32_ms"] = op_bound(2.0 * fwd_flops, n_bytes,
                                              SCALAR_OPS_PER_S)[0]
    rec = dict(case=name, kind="ssd", variant=variant,
               backward_variant=bwd_variant, dtype=dtype,
               shape=[b, s, h, p, n, chunk], with_h0=True, with_dfinal=True,
               bwd_ms=bwd_ms, bwd_graph_ms=bwd_g_ms, bwd_bound_ms=bms,
               bwd_bound_by=by, fwd_bwd_bound_ms=fbms, fwd_bwd_bound_by=fby,
               **grads)
    if bwd_variant == "tc":
        rec["simt_bwd_ms"] = time_ms(
            lambda: ss.ssd_scan_backward(*args, chunk=chunk, variant="simt"),
            3, warmup=1)
        rec["speedup_vs_simt"] = rec["simt_bwd_ms"] / bwd_ms
    if timed:
        def fwd_bwd(fn):
            def run():
                ls = [t.detach().requires_grad_(True) for t in inputs]
                y, final = fn(*ls)
                torch.autograd.grad([y, final], ls, [dy, wf])
            return run

        n_it = max(3, iters // 4)
        rec["plain_bwd_ms"] = time_ms(
            lambda: ref.ssd_bwd_ref(*args, chunk=chunk), n_it, warmup=2)
        if bwd_variant == "tc":
            rec["twin_bwd_ms"] = time_ms(
                lambda: ref.ssd_bwd_tc_ref(*args, chunk=chunk), n_it,
                warmup=2)
        rec["fwd_bwd_ms"] = time_ms(fwd_bwd(kernel), n_it, warmup=2)
        rec["plain_fwd_bwd_ms"] = time_ms(fwd_bwd(plain), n_it, warmup=2)
        rec["library_fwd_bwd_ms"] = rec["library_bwd_ms"] = None
    rec["wall_s"] = time.perf_counter() - t_start
    emit("kernel_grad", **rec)
    del inputs, x, g_k
    torch.cuda.empty_cache()
    return rec


def kernel_grad_phase(mla_registers: list) -> dict:
    """21. The backward kernels at the model paths' training shapes, each
    against its plain backward, ``tc``'s plain twin and autograd of the
    plain forward: zamba2's attention (timed in full) and glm4's (128, 128)
    GQA, hubert's (80, 80) bidirectional, deepseek-v2's MLA (192, 128) at
    1 x 1024 and at train_mla's 2 x 2048 (each beside SDPA's backward,
    with ``mla_registers``, the registers and spills of its kernels), a
    window with a softcap (all ``tc``) and an f32 case (``simt``); the SSD
    at zamba2's N 64 (timed in full) and mamba2's N 128 (``tc``) and
    zamba2's in f32 (``simt``).  Returns the cases by kernel, the timed
    case first."""
    mla = dict(library=True, registers=mla_registers)
    flash = [
        attention_grad_case("zamba2_attention", 2, 2048, 32, 32, 64, 64,
                            timed=True),
        attention_grad_case("glm4_attention", 1, 2048, 32, 2, 128, 128),
        attention_grad_case("hubert_attention", 2, 1024, 16, 16, 80, 80,
                            causal=False),
        attention_grad_case("mla_attention", 1, 1024, 128, 128, 192, 128,
                            **mla),
        attention_grad_case("mla_attention_train", 2, 2048, 128, 128, 192,
                            128, **mla),
        attention_grad_case("window_softcap", 1, 2048, 16, 8, 128, 128,
                            window=512, cap=50.0),
        attention_grad_case("zamba2_attention_f32", 1, 1024, 32, 32, 64, 64,
                            dtype="float32", library=True),
    ]
    ssd = [
        ssd_grad_case("zamba2_ssd", 2, 2048, 64, 64, 64, 256, timed=True),
        ssd_grad_case("mamba2_ssd", 2, 2048, 48, 64, 128, 256),
        ssd_grad_case("zamba2_ssd_f32", 1, 1024, 64, 64, 64, 256,
                      dtype="float32"),
    ]
    return {"flash_attention": flash, "ssd_scan": ssd}


def reset_model_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    fa.launches = ss.launches = fa.lse_launches = 0
    fa.backward_launches = ss.backward_launches = 0
    for counts in (fa.variant_launches, ss.variant_launches,
                   fa.backward_variant_launches,
                   ss.backward_variant_launches):
        for k in counts:
            counts[k] = 0


def model_counts() -> dict:
    """Forward launches by variant, and the backward kernels' launches by
    variant under ``backward``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    return dict(**fa.variant_launches,
                **{f"ssd_{k}": c for k, c in ss.variant_launches.items()},
                backward={
                    **{f"flash_attention.backward.{k}": c
                       for k, c in fa.backward_variant_launches.items()},
                    **{f"ssd_scan.backward.{k}": c
                       for k, c in ss.backward_variant_launches.items()}})


def want_backward(flash_tc: int, ssd_tc: int) -> dict:
    """Backward launches a training path should show: every one ``tc``."""
    return {"flash_attention.backward.tc": flash_tc,
            "flash_attention.backward.simt": 0,
            "ssd_scan.backward.tc": ssd_tc, "ssd_scan.backward.simt": 0}


def _train_setup(cfg, device, seed: int = 0):
    import torch

    from repro_torch.models.common import init_params
    from repro_torch.train import optimizer as opt

    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device, torch.float32)
    return params, opt.init(params)


def _train_batch(cfg, b: int, s: int, device, step: int = 0) -> dict:
    import torch

    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b, seed=0)).batch(step)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


def train_phase(remat: str) -> dict:
    """``launch.train.main`` at zamba2-1.2b's full width and depth, 4 steps
    of 2 x 2048 tokens on the card, counts reset just before: every loss
    finite; the kernels' launches per forward (6 ``prefill_tc``, 32 ``tc``;
    under ``full`` remat the body groups' forwards run again in the
    backward), the backward kernels' (6 and 32 a step, one a Function's
    backward), and no call of a plain version."""
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models.common import layer_plan

    t0 = time.perf_counter()
    reset_model_counts()
    with plain_calls() as plain_n:
        res = launch_train.main(TRAIN_ARGS + ["--remat", remat])
    counts = model_counts()
    wall = time.perf_counter() - t0
    cfg = launch_train.scaled_config(TRAIN_ARCH, "full")
    plan = layer_plan(cfg)
    steps = res["steps"]
    sites = sum(k.mixer == "shared_attn" for k in plan.kinds)
    mamba = sum(k.mixer == "mamba" for k in plan.kinds)
    body = plan.kinds[plan.prefix:plan.suffix_start]
    again = remat == "full"
    want = dict(
        prefill_tc=steps * (sites + again * sum(k.mixer == "shared_attn"
                                                for k in body)),
        ssd_tc=steps * (mamba + again * sum(k.mixer == "mamba"
                                            for k in body)),
        decode_split=0, simt=0, ssd_simt=0)
    got = {k: counts[k] for k in want}
    want_bwd = want_backward(steps * sites, steps * mamba)
    check(steps == 4 and all(np.isfinite(res["losses"])),
          f"train {remat}: losses {res['losses']}")
    check(got == want, f"train {remat}: kernel launches {got}, expected "
          f"{want}")
    check(counts["backward"] == want_bwd, f"train {remat}: backward "
          f"launches {counts['backward']}, expected {want_bwd}")
    check(not plain_n, f"train {remat}: plain versions called "
          f"{dict(plain_n)}")
    tokens = 2 * 2048
    out = dict(remat=remat, steps=steps, losses=res["losses"],
               step_s=res["step_s"], tokens_per_s=tokens / res["step_s"],
               peak_mem_gb=res["peak_mem_gb"], launches=got,
               launches_per_step={k: v / steps for k, v in got.items()},
               backward_launches=counts["backward"],
               plain_calls=sum(plain_n.values()), params=cfg.param_count(),
               wall_s=wall)
    emit("train", **out)
    del res
    torch.cuda.empty_cache()
    return out


def train_profile_phase() -> dict:
    """One more zamba2 train step on the card under ``torch.profiler``
    (after a warm-up step): device busy and idle share, the largest device
    ops, and the share of busy time spent in the kernels' backward (device
    time under the Functions' backward nodes).  A third step's host waits
    are recorded for the lint phase.  Then the step's gradients: every
    leaf finite and non-zero, so gradients crossed both kernels'
    Functions (the shared block's attention weights and every Mamba
    layer's ``w_in`` among them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch_train
    from repro_torch.models import decoder
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import leaves_with_paths

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = launch_train.scaled_config(TRAIN_ARCH, "full")
    ctx = decoder.RunCtx(dev)
    params, state = _train_setup(cfg, dev)
    step_fn = ts.make_train_step(cfg, ctx, ts.TrainConfig())
    batch = _train_batch(cfg, 2, 2048, dev)
    params, state, _ = step_fn(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in device_ops(prof)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    backward = {}
    for e in prof.events():
        if e.name.startswith("autograd::engine::evaluate_function: ") and \
                any(f in e.name for f in ("_AttentionBackward",
                                          "_SSDBackward")):
            key = e.name.split(": ")[1]
            backward[key] = backward.get(key, 0.0) \
                + e.device_time_total / 1e3
    ours = {n[:60]: ms for n, ms, _ in rows
            if any(k in n for k in ("flash::", "ssd::"))}
    check(busy > 0, "train_profile: the trace holds no device time")
    params, state, _ = record_sites("train_profile/train_step",
                                    lambda: step_fn(params, state, batch))
    grads_of = ts._grad_fn(cfg, ctx)
    _, _, grads = grads_of(params, batch)
    bad = [(".".join(map(str, path)), float(g.abs().max()))
           for path, g in leaves_with_paths(grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    check(not bad, f"train_profile: zero or non-finite gradients: {bad}")
    n_leaves = len(leaves_with_paths(grads))
    shared = {k: float(v.norm()) for k, v in grads["shared_attn"]["attn"].items()}
    w_in = [float(layer["mamba"]["w_in"].norm())
            for layer in grads["layers"] if "mamba" in layer]
    out = dict(wall_ms=wall, device_busy_ms=busy,
               idle_share=max(0.0, 1 - busy / wall),
               backward_ms=backward,
               backward_share=sum(backward.values()) / busy,
               repo_kernels_ms=ours,
               top=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:8]],
               grad_leaves=n_leaves, grad_leaves_nonzero_finite=n_leaves,
               shared_attn_grad_norms=shared, mamba_w_in_grad_norms=w_in,
               loss=float(m["loss"]), wall_s=time.perf_counter() - t0)
    emit("train_profile", **out)
    del params, state, grads
    torch.cuda.empty_cache()
    return out


def train_held_phase() -> dict:
    """zamba2-1.2b at full width cut to 6 layers (one shared site), 1 x
    2048 tokens: the train step's loss and gradients on the card (kernels)
    and on the CPU (plain versions) from the same fp32 masters and batch;
    loss within 1e-2 relative, each leaf's relative L2 error within 5e-2
    (bf16 compute)."""
    import dataclasses

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models import decoder
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(launch_train.scaled_config(TRAIN_ARCH, "full"),
                              n_layers=HELD_TRAIN_LAYERS)
    params, _ = _train_setup(cfg, dev, seed=3)
    batch = _train_batch(cfg, 1, 2048, dev, step=3)
    reset_model_counts()
    with plain_calls() as plain_n:
        loss_c, _, g_c = ts._grad_fn(cfg, decoder.RunCtx(dev))(params, batch)
    counts = model_counts()
    t_card = time.perf_counter() - t0
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    t1 = time.perf_counter()
    loss_h, _, g_h = ts._grad_fn(cfg, decoder.RunCtx("cpu"))(
        cpu_params, {k: v.cpu() for k, v in batch.items()})
    t_cpu = time.perf_counter() - t1
    rel_loss = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    errs = {}
    for (path, a), (_, b) in zip(leaves_with_paths(g_c),
                                 leaves_with_paths(g_h)):
        errs[".".join(map(str, path))] = float(
            (a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
    worst = max(errs, key=errs.get)
    check(counts["prefill_tc"] == 1 and counts["ssd_tc"] == 5
          and counts["backward"] == want_backward(1, 5)
          and not plain_n,
          f"train_held: kernel launches {counts}, plain calls "
          f"{dict(plain_n)}")
    check(rel_loss <= HELD_TRAIN_LOSS_TOL,
          f"train_held: loss {float(loss_c)} on cuda, {float(loss_h)} on cpu")
    check(errs[worst] <= HELD_TRAIN_GRAD_TOL,
          f"train_held: gradient {worst} off by {errs[worst]} (relative L2)")
    out = dict(layers=HELD_TRAIN_LAYERS, loss_cuda=float(loss_c),
               loss_cpu=float(loss_h), loss_rel_err=rel_loss,
               grad_leaves=len(errs), worst_leaf=worst,
               worst_rel_l2=errs[worst],
               median_rel_l2=float(np.median(list(errs.values()))),
               launches=counts, card_s=t_card, cpu_s=t_cpu,
               wall_s=time.perf_counter() - t0)
    emit("train_held", **out)
    del params, g_c
    torch.cuda.empty_cache()
    return out


MLA_TRAIN_ARCH = "deepseek-v2-236b"
MLA_TRAIN_LAYERS = 1           # the dense first layer: MLA + the 12288 MLP
MLA_TRAIN_STEPS = 4            # of 2 x 2048 tokens
MLA_HELD_TOKENS = 512          # 1 x 512: 512 rows a kv head, so tc


def mla_train_config():
    """deepseek-v2-236b at full width cut to its first (dense) layer:
    1.39 B parameters, 25 GB with fp32 masters, AdamW's moments and fp32
    gradients."""
    from repro_torch.launch import train as launch_train

    return dataclasses.replace(
        launch_train.scaled_config(MLA_TRAIN_ARCH, "full"),
        n_layers=MLA_TRAIN_LAYERS)


def train_mla_phase() -> dict:
    """23b. deepseek-v2-236b at full width, depth 1, seeded fp32 masters:
    4 train steps (``make_train_step``, as ``launch.train`` runs it) of 2 x
    2048 tokens of ``SyntheticLM``, counts reset just before.  Every loss
    finite; per step one ``prefill_tc`` launch (MLA's (192, 128), with the
    lse) and one ``flash_attention.backward.tc``, no other flash or SSD
    launch and no plain version called; step wall after the first,
    tokens/s, peak memory.  Then one more step under ``torch.profiler``:
    device busy, idle share, the MLA backward's device ms (under
    ``_AttentionBackward``) and its share of busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decoder
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = mla_train_config()
    params, state = _train_setup(cfg, dev)
    step_fn = ts.make_train_step(cfg, decoder.RunCtx(dev), ts.TrainConfig())
    batches = [_train_batch(cfg, 2, 2048, dev, step=i)
               for i in range(MLA_TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_model_counts()
    losses, stamps = [], []
    with plain_calls() as plain_n:
        for batch in batches[:MLA_TRAIN_STEPS]:
            params, state, m = step_fn(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize(dev)
            stamps.append(time.perf_counter())
    counts = model_counts()
    lse_launches = fa.lse_launches
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = float(np.mean(np.diff(stamps)))
    steps = len(losses)
    want = dict(prefill_tc=steps, decode_split=0, simt=0, ssd_tc=0,
                ssd_simt=0)
    got = {k: counts[k] for k in want}
    check(steps == MLA_TRAIN_STEPS and all(np.isfinite(losses)),
          f"train_mla: losses {losses}")
    check(got == want and lse_launches == steps,
          f"train_mla: kernel launches {got} ({lse_launches} with the lse), "
          f"expected {want}")
    check(counts["backward"] == want_backward(steps, 0),
          f"train_mla: backward launches {counts['backward']}")
    check(not plain_n, f"train_mla: plain versions called {dict(plain_n)}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        params, state, m = step_fn(params, state, batches[-1])
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t1) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in device_ops(prof)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    attn_bwd = sum(e.device_time_total / 1e3 for e in prof.events()
                   if e.name == "autograd::engine::evaluate_function: "
                                "_AttentionBackward")
    ours = {n[:60]: ms for n, ms, _ in rows if "flash::" in n}
    check(busy > 0 and attn_bwd > 0,
          f"train_mla: the trace holds {busy} ms of device time, {attn_bwd} "
          f"ms under _AttentionBackward")
    tokens = 2 * 2048
    out = dict(arch=MLA_TRAIN_ARCH, layers=MLA_TRAIN_LAYERS,
               params=cfg.param_count(), steps=steps, losses=losses,
               step_s=step_s, tokens_per_s=tokens / step_s, peak_mem_gb=peak,
               launches=got, launches_per_step={k: v / steps
                                                for k, v in got.items()},
               lse_launches=lse_launches,
               backward_launches=counts["backward"],
               plain_calls=sum(plain_n.values()), profiled_wall_ms=wall,
               device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall),
               attention_backward_ms=attn_bwd,
               attention_backward_share=attn_bwd / busy,
               repo_kernels_ms=ours, top=[dict(name=n[:90], ms=ms, calls=c)
                    for n, ms, c in rows[:8]],
               wall_s=time.perf_counter() - t0)
    emit("train_mla", **out)
    del params, state, batches
    torch.cuda.empty_cache()
    return out


def train_mla_held_phase() -> dict:
    """23c. The train_mla config at 1 x 512 tokens (512 rows a kv head, so
    ``tc``): the train step's loss and gradients on the card (kernels) and
    on the CPU (plain versions) from the same fp32 masters and batch; loss
    within 1e-2 relative, each leaf's relative L2 error within 5e-2 (bf16
    compute); on the card one ``prefill_tc`` and one ``tc`` backward
    launch and no plain version called."""
    import torch

    from repro_torch.models import decoder
    from repro_torch.train import train_step as ts
    from repro_torch.train.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = mla_train_config()
    params, _ = _train_setup(cfg, dev, seed=3)
    batch = _train_batch(cfg, 1, MLA_HELD_TOKENS, dev, step=3)
    reset_model_counts()
    with plain_calls() as plain_n:
        loss_c, _, g_c = ts._grad_fn(cfg, decoder.RunCtx(dev))(params, batch)
    counts = model_counts()
    g_c = tree_map(lambda t: t.cpu(), g_c)
    t_card = time.perf_counter() - t0
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    del params
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    loss_h, _, g_h = ts._grad_fn(cfg, decoder.RunCtx("cpu"))(
        cpu_params, {k: v.cpu() for k, v in batch.items()})
    t_cpu = time.perf_counter() - t1
    rel_loss = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    errs = {".".join(map(str, path)): float(
                (a - b).norm() / b.norm().clamp(min=1e-30))
            for (path, a), (_, b) in zip(leaves_with_paths(g_c),
                                         leaves_with_paths(g_h))}
    worst = max(errs, key=errs.get)
    want = dict(prefill_tc=1, decode_split=0, simt=0, ssd_tc=0, ssd_simt=0)
    check({k: counts[k] for k in want} == want
          and counts["backward"] == want_backward(1, 0) and not plain_n,
          f"train_mla_held: kernel launches {counts}, plain calls "
          f"{dict(plain_n)}")
    check(rel_loss <= HELD_TRAIN_LOSS_TOL,
          f"train_mla_held: loss {float(loss_c)} on cuda, {float(loss_h)} "
          f"on cpu")
    check(errs[worst] <= HELD_TRAIN_GRAD_TOL,
          f"train_mla_held: gradient {worst} off by {errs[worst]} "
          f"(relative L2)")
    out = dict(arch=MLA_TRAIN_ARCH, layers=MLA_TRAIN_LAYERS,
               tokens=MLA_HELD_TOKENS, loss_cuda=float(loss_c),
               loss_cpu=float(loss_h), loss_rel_err=rel_loss,
               grad_leaves=len(errs), worst_leaf=worst,
               worst_rel_l2=errs[worst],
               median_rel_l2=float(np.median(list(errs.values()))),
               attention_rel_l2={k: v for k, v in errs.items()
                                 if ".attn." in f".{k}."},
               launches=counts, card_s=t_card, cpu_s=t_cpu,
               wall_s=time.perf_counter() - t0)
    emit("train_mla_held", **out)
    del g_c, g_h, cpu_params
    return out


# -- phases 24-26: the mesh (a world of one NCCL rank on the card) -------------

MESH_MOE_TOKENS = 2048
MESH_MOE_CF = 8.0              # capacity factor: no token drops
MESH_TRAIN_LOSS_TOL = 1e-6     # mesh vs single-device losses, relative
LSE_TOL = 2e-5                 # decode_split's log-sum-exp vs plain, fp32


def sync_sites(fn) -> tuple:
    """One call of ``fn`` under PyTorch's sync debug mode, which warns at
    each host wait on the device: ``(result, sites, executed)``.  ``sites``
    counts the waits by site, the innermost frame under ``src/repro_torch/``
    at each warning as ``file:line`` (a sync inside torch's own Python
    names torch's file; the port's frame that called into it is the site),
    ``"other"`` where no frame of the port is on the stack.  ``executed``
    holds every ``file:line`` of the port that ran in the call (a
    ``sys.monitoring`` line hook that disables itself at each line once
    seen).  A wait inside a ctypes library (the drain's) or on a
    ``torch.cuda.Event`` does not warn."""
    import traceback
    import warnings

    import torch

    root = str(SRC / "repro_torch") + "/"
    sites = collections.Counter()
    executed = set()

    def site(filename: str, line: int) -> str:
        return f"{Path(filename).relative_to(ROOT).as_posix()}:{line}"

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        at = "other"
        for frame in reversed(traceback.extract_stack()):
            if frame.filename.startswith(root):
                at = site(frame.filename, frame.lineno)
                break
        sites[at] += 1

    mon = sys.monitoring
    tool = mon.COVERAGE_ID

    def on_line(code, line):
        if code.co_filename.startswith(root):
            executed.add(site(code.co_filename, line))
        return mon.DISABLE

    torch.cuda.synchronize()
    mon.use_tool_id(tool, "chip_smoke")
    mon.register_callback(tool, mon.events.LINE, on_line)
    mon.restart_events()
    mon.set_events(tool, mon.events.LINE)
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            result = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
    return result, sites, executed


def host_syncs(fn) -> int:
    """Host waits on the device during one call of ``fn``."""
    return sum(sync_sites(fn)[1].values())


# sync sites of one call each of the main paths, by call (phase/call ->
# (sites, executed)); the lint phase holds every site to the host-sync rule
SYNC_SITES = {}


def record_sites(label: str, fn):
    """``fn()`` with its sync sites recorded under ``label``."""
    result, sites, executed = sync_sites(fn)
    SYNC_SITES[label] = (sites, executed)
    return result


@contextlib.contextmanager
def sites_of_call(label: str, owner, name: str, nth: int = 1,
                  when=lambda *a, **kw: True):
    """Inside the block, the ``nth`` call of ``owner.name`` that ``when``
    accepts runs under :func:`record_sites` as ``label``."""
    plain = getattr(owner, name)
    seen = [0]

    def wrapped(*args, **kw):
        if label in SYNC_SITES or not when(*args, **kw):
            return plain(*args, **kw)
        seen[0] += 1
        if seen[0] < nth:
            return plain(*args, **kw)
        return record_sites(label, lambda: plain(*args, **kw))

    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, plain)
    check(label in SYNC_SITES, f"{label}: the call to record never ran")


def gloo_takes_cuda_tensors() -> dict:
    """Whether the installed gloo runs ``all_to_all_single`` on CUDA
    tensors (a gloo group of this world's one rank, beside its NCCL one)."""
    import torch
    import torch.distributed as dist

    grp = dist.new_group(backend="gloo")
    t = torch.arange(4, dtype=torch.float32, device="cuda")
    out = torch.empty_like(t)
    try:
        dist.all_to_all_single(out, t, group=grp)
        torch.cuda.synchronize()
        return dict(gloo_cuda_all_to_all=bool(torch.equal(out, t)))
    except Exception as e:          # the answer is what is recorded
        return dict(gloo_cuda_all_to_all=False, gloo_error=str(e)[:200])


MESH_MOE_GLOO = 4              # gloo ranks sharing the one card
MESH_MOE_GLOO_TIMEOUT = 300.0


def _moe_gloo_cases() -> list:
    """(name, arch, cfg change, mesh shape) of the a2a path on gloo ranks
    of the one card: mixtral's layer at ep 4, tp 1, and deepseek-v2's
    widths (d 5120, d_expert 1536, two shared experts) with its 160 experts
    cut to 2, the only way 4 ranks give its chunked layout tp 2 (ep 2)."""
    return [("mixtral_ep4_tp1", "mixtral-8x7b", {}, (1, 4)),
            ("deepseek_ep2_tp2", "deepseek-v2-236b",
             dict(n_experts=2, top_k=2), (1, 4))]


def _moe_gloo_rank(rank: int, world: int, port: int, out: str,
                   seed: int) -> None:
    """One gloo rank of the one-card a2a run: this rank's expert chunk of
    each case's layer, its global result, and on rank 0 the routed
    no-mesh oracle over the whole layer; results to ``out``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    res = {}
    try:
        for name, arch, change, shape in _moe_gloo_cases():
            cfg, p = moe_layer(arch, seed, **change)
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            msize = shape[1]
            chunks = moe.to_chunked(*(p["experts"][k][0] for k in (
                "w_gate", "w_up", "w_down")), msize)
            mine = dict(p, experts={k: c[rank % msize:rank % msize + 1]
                                    .clone() for k, c in zip((
                                        "w_gate", "w_up", "w_down"), chunks)})
            if "shared" in p:     # the dense rules: this rank's blocks
                f = p["shared"]["w_down"].shape[0] // msize
                lo = rank % msize * f
                mine["shared"] = {k: w.narrow(0 if k == "w_down" else -1,
                                              lo, f).clone()
                                  for k, w in p["shared"].items()}
            del chunks
            gen = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn((1, MESH_MOE_TOKENS, cfg.d_model),
                            generator=gen, device="cuda").to(
                cfg.compute_dtype())
            run = lambda: moe.moe_sharded_a2a(
                mine, x, cfg, mesh, capacity_factor=MESH_MOE_CF)
            y = run()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            res[f"{name}_ms"] = (time.perf_counter() - t0) / 3 * 1e3
            res[f"{name}_y"] = y.float().cpu()
            if rank == 0:                # the oracle, then its time warm
                res[f"{name}_want"] = moe.moe_apply(p, x, cfg).float().cpu()
                t0 = time.perf_counter()
                moe.moe_apply(p, x, cfg)
                torch.cuda.synchronize()
                res[f"{name}_routed_ms"] = (time.perf_counter() - t0) * 1e3
            del p, mine
            torch.cuda.empty_cache()
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_moe_gloo(seed: int) -> dict:
    """The a2a path as MESH_MOE_GLOO gloo ranks on the one card (gloo takes
    CUDA tensors there), each held to the routed no-mesh path within
    MOE_TOL of max |y|; every rank returns the same global result."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        procs = [ctx.Process(target=_moe_gloo_rank,
                             args=(r, MESH_MOE_GLOO, port, out, seed))
                 for r in range(MESH_MOE_GLOO)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + MESH_MOE_GLOO_TIMEOUT
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        check(all(proc.exitcode == 0 for proc in procs),
              f"mesh_moe_gloo: ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(Path(out) / f"rank{r}.pt")
                 for r in range(MESH_MOE_GLOO)]
    rec = {}
    for name, arch, change, shape in _moe_gloo_cases():
        want = ranks[0][f"{name}_want"]
        top = float(want.abs().max())
        for r in ranks[1:]:
            check(torch.equal(r[f"{name}_y"], ranks[0][f"{name}_y"]),
                  f"mesh_moe_gloo/{name}: ranks return different results")
        err = float((ranks[0][f"{name}_y"] - want).abs().max())
        check(err <= MOE_TOL * top, f"mesh_moe_gloo/{name}: a2a differs "
              f"from the routed path by {err} (max |y| {top})")
        rec[name] = dict(arch=arch, cut=change, mesh=shape,
                         max_abs_diff=err, rel_diff=err / top,
                         a2a_ms=[r[f"{name}_ms"] for r in ranks],
                         routed_ms=ranks[0][f"{name}_routed_ms"])
    return rec


def mesh_moe_phase(seed: int = 7) -> dict:
    """One full-width MoE layer of mixtral-8x7b and of deepseek-v2-236b on
    1 x 2048 tokens through ``moe_sharded`` and ``moe_sharded_a2a`` on the
    world-size-1 NCCL mesh (capacity factor 8: nothing drops), each held
    to the routed no-mesh ``moe_apply`` within MOE_TOL of max |y| (rows
    whose experts differ between the runs, near-ties, left out; the same
    router runs in all three, so none is expected).  Times per call of
    each path.  Then, where gloo takes CUDA tensors, the a2a path on
    MESH_MOE_GLOO gloo ranks of the one card (``mesh_moe_gloo``)."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    mesh = make_host_mesh(device="cuda")
    probe = gloo_takes_cuda_tensors()
    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        t_start = time.perf_counter()
        cfg, p = moe_layer(arch, seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((1, MESH_MOE_TOKENS, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.compute_dtype())
        kw = dict(capacity_factor=MESH_MOE_CF)
        paths = {
            "routed": lambda: moe.moe_apply(p, x, cfg),
            "replicate": lambda: moe.moe_sharded(p, x, cfg, mesh, **kw),
            "a2a": lambda: moe.moe_sharded_a2a(p, x, cfg, mesh, **kw)}
        outs, ids = {}, {}
        for name, fn in paths.items():
            with recorded_routing() as calls:
                outs[name] = fn()
            ids[name] = calls[0][0]
        torch.cuda.synchronize()
        want = outs["routed"].float().reshape(-1, cfg.d_model)
        top = float(want.abs().max())
        rec = dict(arch=arch, tokens=MESH_MOE_TOKENS, d_model=cfg.d_model,
                   n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                   capacity_factor=MESH_MOE_CF,
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   max_abs_y=top, tol_rel=MOE_TOL)
        for name in ("replicate", "a2a"):
            same = (torch.sort(ids[name], -1).values
                    == torch.sort(ids["routed"], -1).values).all(-1)
            got = outs[name].float().reshape(-1, cfg.d_model)
            check(bool(torch.isfinite(got).all()),
                  f"mesh_moe/{arch}/{name}: non-finite output")
            err = float((got - want)[same].abs().max())
            check(err <= MOE_TOL * top, f"mesh_moe/{arch}/{name}: differs "
                  f"from the routed path by {err} (max |y| {top})")
            rec[f"{name}_max_abs_diff"] = err
            rec[f"{name}_rel_diff"] = err / top
            rec[f"{name}_rows_left_out"] = int((~same).sum())
        for name, fn in paths.items():
            rec[f"{name}_ms"] = time_ms(fn, 3, warmup=1)
            rec[f"{name}_host_syncs"] = host_syncs(fn)
        emit("mesh_moe", **rec, wall_s=time.perf_counter() - t_start)
        del p, outs
        torch.cuda.empty_cache()
    if probe["gloo_cuda_all_to_all"]:
        t0 = time.perf_counter()
        probe["cases"] = mesh_moe_gloo(seed)
        probe["wall_s"] = time.perf_counter() - t0
    emit("mesh_moe_gloo", ranks=MESH_MOE_GLOO, **probe)
    return probe


def mesh_train_phase(train: dict) -> dict:
    """``launch.train.main`` on the mesh (a world of one NCCL rank) at
    zamba2-1.2b's full width and depth, 2 steps of 2 x 2048, counts reset
    just before: its losses equal the single-device ``train`` phase's
    first two within 1e-6 relative, with the same kernel launches a step;
    step wall and peak memory beside train's."""
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.models.common import layer_plan

    t0 = time.perf_counter()
    args = [a for a in TRAIN_ARGS if a != "--no-mesh"]
    args[args.index("--steps") + 1] = "2"
    torch.cuda.reset_peak_memory_stats()
    reset_model_counts()
    with plain_calls() as plain_n:
        res = launch_train.main(args + ["--remat", "none"])
    counts = model_counts()
    plan = layer_plan(launch_train.scaled_config(TRAIN_ARCH, "full"))
    steps = res["steps"]
    want = dict(prefill_tc=steps * sum(k.mixer == "shared_attn"
                                       for k in plan.kinds),
                ssd_tc=steps * sum(k.mixer == "mamba" for k in plan.kinds),
                decode_split=0, simt=0, ssd_simt=0)
    got = {k: counts[k] for k in want}
    base = train["none"]["losses"][:2]
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], base))
    check(steps == 2 and rel <= MESH_TRAIN_LOSS_TOL,
          f"mesh_train: losses {res['losses']}, single-device {base}")
    check(got == want, f"mesh_train: kernel launches {got}, expected {want}")
    want_bwd = want_backward(want["prefill_tc"], want["ssd_tc"])
    check(counts["backward"] == want_bwd and not plain_n,
          f"mesh_train: backward launches {counts['backward']}, expected "
          f"{want_bwd}; plain calls {dict(plain_n)}")
    out = dict(steps=steps, losses=res["losses"], train_losses=base,
               max_rel_loss_diff=rel, tol_rel=MESH_TRAIN_LOSS_TOL,
               step_s=res["step_s"], train_step_s=train["none"]["step_s"],
               peak_mem_gb=res["peak_mem_gb"],
               train_peak_mem_gb=train["none"]["peak_mem_gb"],
               launches=got, backward_launches=counts["backward"],
               wall_s=time.perf_counter() - t0)
    emit("mesh_train", **out)
    del res
    torch.cuda.empty_cache()
    return dict(out, counts=counts)


def lse_case(name: str, b, skv, hq, hkv, d, *, window=None,
             dtype="float32", seed=0) -> dict:
    """decode_split's log-sum-exp output on one decode shape against the
    plain version's (fp32, LSE_TOL), its output within FLASH_TOL, and the
    call timed with and without the output."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(td)
               for shape in ((b, 1, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    valid = torch.randint(skv // 2, skv + 1, (b,), generator=gen, device=dev)
    qp = (valid - 1).to(torch.int32)[:, None].contiguous()
    kp = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv)
    kp = torch.where(kp < valid[:, None], kp,
                     torch.full_like(kp, 2 ** 30)).contiguous()
    kw = dict(q_positions=qp, kv_positions=kp, causal=True,
              sliding_window=window)
    check(fa.variant(td, 1, hq, hkv, d, d) == "decode_split",
          f"{name}: not a decode_split shape")
    before = fa.lse_launches
    with torch.no_grad():
        out, lse = ops.attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    check(fa.lse_launches == before + 1, f"{name}: no lse launch")
    want, want_lse = ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    lse_err = float((lse - want_lse).abs().max())
    err = float((out.float() - want.float()).abs().max())
    atol, rtol = FLASH_TOL[dtype]
    check(torch.allclose(lse, want_lse, atol=LSE_TOL, rtol=LSE_TOL),
          f"{name}: lse differs from the plain version by {lse_err}")
    check(torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol),
          f"{name}: output differs from the plain version by {err}")
    with_lse = lambda: ops.attention(q, k, v, return_lse=True, **kw)
    without = lambda: ops.attention(q, k, v, **kw)
    plain = lambda: ref.sdpa_ref(q, k, v, return_lse=True, **kw)
    with torch.no_grad():
        ms, g_ms, n = timings(with_lse)
        ms0, g_ms0, _ = timings(without)
        plain_ms, _, _ = timings(plain)
    visible = ref.attn_mask(qp, kp, True, window) \
        & (kp < VALID_POS_LIMIT)[:, None, :]
    seen_keys = int(visible.any(dim=1).sum())
    n_bytes = (q.numel() + out.numel() + seen_keys * hkv * 2 * d) \
        * q.element_size() + 4 * (qp.numel() + kp.numel() + lse.numel())
    bms, by = op_bound(4.0 * int(visible.sum()) * hq * d, n_bytes,
                       SCALAR_OPS_PER_S)
    rec = dict(case=name, B=b, Skv=skv, Hq=hq, Hkv=hkv, D=d, window=window,
               dtype=dtype, max_abs_err_lse=lse_err, max_abs_err=err,
               tol_lse=LSE_TOL, ms=ms, graph_ms=g_ms, ms_without_lse=ms0,
               graph_ms_without_lse=g_ms0, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by)
    emit("mesh_decode_lse", **rec)
    return rec


def mesh_decode_phase(seed: int = 11) -> dict:
    """decode_split's log-sum-exp at glm4's and gemma3's decode shapes,
    then real-decode serving of zamba2 (all 38 layers, SERVE_REAL) three
    ways: without a mesh, on the mesh ``launch.serve --seq-axis 1`` builds
    (the reference's sizing rule: no seq axis on a world of one), and on a
    (1, 1, 1) mesh with a seq axis, whose decode merges its one chunk
    through the log-sum-exp and an all-gather.  Each run's metrics equal
    the meshless run's key for key, with decode_split's launches counted
    (the seq mesh's all with the lse output)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, decoder

    t0 = time.perf_counter()
    cases = [lse_case("glm4_decode", 4, 2080, 32, 2, 128, seed=60),
             lse_case("glm4_decode_bf16", 4, 2080, 32, 2, 128,
                      dtype="bfloat16", seed=61),
             lse_case("gemma3_decode_local", 1, 4128, 32, 16, 128,
                      window=1024, seed=62),
             lse_case("gemma3_decode_local_bf16", 1, 4128, 32, 16, 128,
                      window=1024, dtype="bfloat16", seed=63)]
    dev = torch.device("cuda")
    cfg = get_config("zamba2-1.2b")
    params = common.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, cfg.compute_dtype())
    n_attn = sum(k.mixer in ATTN_MIXERS for k in common.layer_plan(cfg).kinds)
    runs, counts = {}, {}
    meshes = {"none": {},
              "seq_axis_1": dict(mesh=make_host_mesh(model=1, seq=1,
                                                     device="cuda")),
              "seq_mesh": dict(mesh=init_device_mesh(
                  "cuda", (1, 1, 1), mesh_dim_names=("data", "seq", "model")),
                  seq_axis="seq")}
    for name, kw in meshes.items():
        reset_model_counts()
        fa.lse_launches = 0                          # just before the path
        runs[name] = serve_real_run(cfg, params, dev, **kw)
        counts[name] = dict(model_counts(), lse=fa.lse_launches)
        steps = runs[name]["stats"]["steps"]
        want = n_attn * steps
        check(counts[name]["decode_split"] == want
              and counts[name]["lse"] == (want if "seq_axis" in kw else 0),
              f"mesh_decode/{name}: decode_split {counts[name]}, expected "
              f"{want} ({steps} decode steps)")
    # one decode step of the 16 slots by itself, per mesh: its host waits
    # on the device and its wall
    steps = {}
    for name, kw in meshes.items():
        ctx = decoder.RunCtx(dev, **kw)
        caches = decoder.init_cache(cfg, 16, SERVE_REAL["max_len"],
                                    cfg.compute_dtype(), dev, mesh=ctx.mesh)
        tok = torch.zeros(16, dtype=torch.int32, device=dev)
        pos = torch.full((16,), 5, dtype=torch.int32, device=dev)
        step = lambda: decoder.decode_step(cfg, ctx, params, caches, tok,
                                           pos)
        steps[name] = dict(host_syncs=host_syncs(step),
                           ms=time_ms(step, 10, warmup=2))
    for name in ("seq_axis_1", "seq_mesh"):
        check(runs[name]["metrics"] == runs["none"]["metrics"],
              f"mesh_decode/{name}: serving metrics differ from the "
              f"meshless run")
        check(torch.equal(runs[name]["first_logits"],
                          runs["none"]["first_logits"]),
              f"mesh_decode/{name}: first decode logits differ")
    m = runs["none"]["metrics"]
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, **SERVE_REAL,
               tokens=m["tokens"], transfers=m["transfers"],
               metrics_equal=True,
               launches={k: {"decode_split": c["decode_split"],
                             "lse": c["lse"]} for k, c in counts.items()},
               wall_s={k: r["wall_s"] for k, r in runs.items()},
               ms_per_engine_step={k: 1e3 * r["wall_s"] / r["steps"]
                                   for k, r in runs.items()},
               decode_step=steps, phase_wall_s=time.perf_counter() - t0)
    emit("mesh_decode", **out)
    del params, runs
    torch.cuda.empty_cache()
    mla = mla_multi_case(meshes["seq_mesh"])
    return dict(out, cases=cases, counts=dict(counts, mla_multi=mla))


MLA_RING = 128                 # ring slots of the one-chunk steps
MLA_STEPS = (96, 3)            # tokens a step: prefill_tc, then simt


def _mla_inputs(seed: int, dev):
    """deepseek-v2 cut to its first layer (full width), its parameters
    drawn from ``seed`` and the tokens of the MLA_STEPS steps, batch 2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=1)
    params = common.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, cfg.compute_dtype())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    steps = [torch.randint(0, cfg.vocab_size, (2, t), generator=gen,
                           device=dev, dtype=torch.int32) for t in MLA_STEPS]
    return cfg, params, steps


def _mla_run(cfg, ctx, params, steps, ring: int):
    """The steps into a fresh ring of ``ring`` slots on ``ctx``: each
    step's logits and the launches, counted from just before the first."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decoder

    caches = decoder.init_cache(cfg, 2, ring, cfg.compute_dtype(),
                                ctx.device, mesh=ctx.mesh)
    reset_model_counts()                             # just before the path
    pos, outs = 0, []
    for toks in steps:
        out, caches = decoder.multi_token_step(cfg, ctx, params, caches,
                                               toks, pos)
        outs.append(out)
        pos += toks.shape[1]
    torch.cuda.synchronize()
    counts = dict(model_counts(), lse=fa.lse_launches)
    counts.pop("backward")
    return outs, counts


def mla_multi_case(seq_mesh: dict, seed: int = 13) -> dict:
    """deepseek-v2's MLA at full width (its first layer), steps of 96 and
    then 3 tokens into a seq-sharded latent cache on the (1, 1, 1) seq
    mesh, against the same steps without a mesh: the expanded path runs
    ``prefill_tc<192,128>`` (96 rows a kv head), then ``simt`` (3), each
    with the rows' lse, and merges its one chunk through the combine, so
    the logits are equal bit for bit; one lse launch a step.  The merge of
    several chunks is :func:`mla_seq_gloo_phase`'s."""
    import torch

    from repro_torch.models import decoder

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg, params, steps = _mla_inputs(seed, dev)
    logits, counts = {}, {}
    for name, kw in (("none", {}), ("seq_mesh", seq_mesh)):
        logits[name], counts[name] = _mla_run(
            cfg, decoder.RunCtx(dev, **kw), params, steps, MLA_RING)
    equal = all(torch.equal(a, b) for a, b in zip(logits["none"],
                                                  logits["seq_mesh"]))
    want = dict(prefill_tc=1, simt=1, lse=2)
    got = {k: counts["seq_mesh"][k] for k in want}
    check(equal, "mesh_decode/mla_multi: the seq mesh's logits differ")
    check(got == want and counts["none"]["lse"] == 0,
          f"mesh_decode/mla_multi: launches {counts}, expected {want}")
    out = dict(arch=cfg.name, n_layers=1, steps=list(MLA_STEPS),
               logits_equal=equal, launches=got,
               wall_s=time.perf_counter() - t0)
    emit("mesh_decode_mla_multi", **out)
    del params, logits
    torch.cuda.empty_cache()
    return counts["seq_mesh"]


MLA_SEQ = 4                    # gloo ranks sharing the one card: (1, 4, 1)
MLA_SEQ_RING = 256             # 64 slots a rank
MLA_SEQ_TIMEOUT = 300.0


def _mla_seq_rank(rank: int, world: int, port: int, out: str,
                  seed: int) -> None:
    """One gloo rank of :func:`mla_seq_gloo_phase`: the MLA steps into its
    64-slot chunk of a MLA_SEQ_RING ring cut over the (1, world, 1) seq
    mesh, every lse the attention kernels return recorded (its rows that
    saw no key: lse at most NEG_INF / 2); on rank 0 also the same steps
    without a mesh, and the gap between the two."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import decoder

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (1, world, 1),
                                mesh_dim_names=("data", "seq", "model"))
        cfg, params, steps = _mla_inputs(seed, dev)
        launch, calls = fa.flash_attention, []

        def recorded(q, k, v, **kw):
            res = launch(q, k, v, **kw)
            if kw.get("return_lse"):
                o, lse = res
                none = lse <= ref.NEG_INF / 2
                calls.append(dict(
                    variant=fa.variant(q.dtype, q.shape[1], q.shape[2],
                                       k.shape[2], q.shape[3], v.shape[3]),
                    rows=lse.numel(), rows_no_key=int(none.sum()),
                    rows_lse_inf=int(torch.isneginf(lse).sum()),
                    finite=bool(torch.isfinite(lse[~none]).all()
                                and torch.isfinite(o[~none]).all())))
            return res

        fa.flash_attention = recorded
        try:
            logits, counts = _mla_run(
                cfg, decoder.RunCtx(dev, mesh=mesh, seq_axis="seq"), params,
                steps, MLA_SEQ_RING)
        finally:
            fa.flash_attention = launch
        res = dict(calls=calls, launches=counts,
                   finite=all(bool(torch.isfinite(x).all()) for x in logits))
        if rank == 0:
            one, _ = _mla_run(cfg, decoder.RunCtx(dev), params, steps,
                              MLA_SEQ_RING)
            rows = lambda xs: [x.reshape(-1, x.shape[-1]) for x in xs]
            res["vs_meshless"] = compare_logits(rows(logits), rows(one))
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mla_seq_gloo_phase(seed: int = 13) -> dict:
    """26d. deepseek-v2's MLA steps of 96 and then 3 tokens into a latent
    cache cut over MLA_SEQ gloo ranks of the one card, a (1, 4, 1) seq
    mesh of 64 slots a rank: each rank runs the expanded path over its
    chunk (``prefill_tc<192,128>``, then ``simt``) with the rows' lse, and
    the chunks merge through ``attention._seq_combine``.  In the 96-token
    step rows 0-63 see no key of rank 1's chunk and no row one of rank 2's
    or 3's; in the 3-token step no row sees one of rank 2's or 3's.  So
    both kernels write rows that saw no key into the merge (lse at most
    NEG_INF / 2: weight 0), and each is checked to have done so.  Rank
    0's logits are held to the same steps without a mesh within MODEL_TOL
    of the largest logit."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        procs = [ctx.Process(target=_mla_seq_rank,
                             args=(r, MLA_SEQ, port, out, seed))
                 for r in range(MLA_SEQ)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + MLA_SEQ_TIMEOUT
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        check(all(proc.exitcode == 0 for proc in procs),
              f"mesh_mla_seq: ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(Path(out) / f"rank{r}.pt")
                 for r in range(MLA_SEQ)]
    want = dict(prefill_tc=1, simt=1, lse=2)
    no_key = collections.Counter()
    for r, res in enumerate(ranks):
        got = {k: res["launches"][k] for k in want}
        check(got == want, f"mesh_mla_seq: rank {r} launches {got}, "
              f"expected {want}")
        check(res["finite"], f"mesh_mla_seq: rank {r} logits not finite")
        for call in res["calls"]:
            check(call["finite"], f"mesh_mla_seq: rank {r} {call}: a row "
                  f"that saw keys has a lse or output not finite")
            no_key[call["variant"]] += call["rows_no_key"]
    check(no_key["prefill_tc"] > 0 and no_key["simt"] > 0,
          f"mesh_mla_seq: rows that saw no key by variant {dict(no_key)}: "
          f"each kernel should write some into the merge")
    cmp = ranks[0]["vs_meshless"]
    check(cmp["rel_diff"] <= MODEL_TOL, f"mesh_mla_seq: rank 0's logits "
          f"differ from the meshless steps by {cmp}")
    out = dict(arch="deepseek-v2-236b", n_layers=1, steps=list(MLA_STEPS),
               mesh=[1, MLA_SEQ, 1], ring=MLA_SEQ_RING,
               rows_no_key=dict(no_key), vs_meshless=cmp,
               calls=[res["calls"] for res in ranks],
               launches_all_ranks={k: sum(res["launches"][k] for res in ranks)
                                   for k in ranks[0]["launches"]},
               phase_wall_s=time.perf_counter() - t0)
    emit("mesh_mla_seq", **out)
    return out


# ---------------------------------------------------------------------------
# 26b-26c. tensor parallelism of the dense stack, and the dry run
# ---------------------------------------------------------------------------

MESH_TP = 4                    # gloo ranks sharing the one card: (1, 4)
MESH_TP_TIMEOUT = 420.0
MESH_TP_RING = 2080
# (tag, arch, batch, prompt, decode steps)
MESH_TP_CELLS = (("glm4", "glm4-9b", 1, 2048, 8),
                 ("zamba2", "zamba2-1.2b", 2, 2048, 4))
# cells also served in f32 on the plain versions, TP against one device
# within MESH_TP_F32_TOL of the largest logit (glm4-9b's f32 tree on four
# ranks and one device would not fit beside each other on the card)
MESH_TP_F32 = ("zamba2",)
MESH_TP_F32_TOL = 1e-3
DRYRUN_TIMEOUT = 600.0         # from its start, beside phase 29


def _tp_rank(rank: int, world: int, port: int, out: str, seed: int) -> None:
    """One gloo rank of ``mesh_tp``: each cell's blocks drawn with
    ``init_params(mesh=)`` and served on the kernels, the first prefill
    and decode kernel calls (and the first SSD scan) recorded and held to
    their plain versions at this rank's shapes, the bytes, peak, launches
    and records; the same pass on the plain versions (``use_kernel=
    "ref"``), and for the MESH_TP_F32 cells in f32 too; then on rank 0
    the single-device runs of the same seed and inputs."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.dryrun import serve_pass
    from repro_torch.models import common, decoder
    from repro_torch.train.tree import leaves

    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    res = {}
    try:
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        for tag, arch, b, prompt, steps in MESH_TP_CELLS:
            cfg = get_config(arch)
            dt = cfg.compute_dtype()
            size = torch.empty((), dtype=dt).element_size()
            t0 = time.perf_counter()
            params = common.init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed), dev, dt,
                mesh=mesh)
            init_s = time.perf_counter() - t0
            inputs, toks = model_inputs(
                cfg, b, prompt, steps,
                torch.Generator(device=dev).manual_seed(seed + 1), dev)
            shapes = leaves(shd._map_tree(
                lambda _, s: int(np.prod(s)),
                shd.local_param_shapes(cfg, mesh)))
            whole = leaves(shd._map_tree(
                lambda _, s: int(np.prod(s)), shd.param_tree_shapes(cfg, 1)))
            ctx = decoder.RunCtx(dev, mesh=mesh, batch_axes=("data",))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            with first_kernel_calls() as seen:
                reset_model_counts()              # just before the path
                t0 = time.perf_counter()
                run = serve_pass(cfg, ctx, params, inputs, toks, MESH_TP_RING)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = model_counts()
            counts.pop("backward")
            rec = dict(
                held_bytes=sum(t.numel() * t.element_size()
                               for t in leaves(params)),
                local_bytes=sum(shapes) * size, whole_bytes=sum(whole) * size,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=counts, wall_s=wall, init_s=init_s,
                prefill_records=run["prefill_records"],
                decode_records=run["decode_records"],
                finite=all(bool(torch.isfinite(x).all())
                           for x in run["logits"]))
            logits = [x.float().cpu() for x in run["logits"]]
            del run
            try:                  # each kernel at this rank's own shapes
                rec["held"] = hold_anchor_calls(f"mesh_tp/{tag}/rank{rank}",
                                                seen)
            except RuntimeError as e:     # reported by the parent
                rec["held_error"] = str(e)
            del seen
            plain = serve_pass(cfg, decoder.RunCtx(
                dev, mesh=mesh, batch_axes=("data",), use_kernel="ref"),
                params, inputs, toks, MESH_TP_RING)["logits"]
            plain = [x.float().cpu() for x in plain]
            del params
            torch.cuda.empty_cache()
            f32 = dataclasses.replace(cfg, dtype="float32")
            if tag in MESH_TP_F32:    # the same draws, in f32, plain
                params = common.init_params(
                    f32, torch.Generator(device=dev).manual_seed(seed), dev,
                    torch.float32, mesh=mesh)
                plain32 = serve_pass(f32, decoder.RunCtx(
                    dev, mesh=mesh, batch_axes=("data",), use_kernel="ref"),
                    params, inputs, toks, MESH_TP_RING)["logits"]
                plain32 = [x.cpu() for x in plain32]
                del params
                torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:                 # the single-device runs
                params = common.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                    dt)
                one = serve_pass(cfg, decoder.RunCtx(dev), params, inputs,
                                 toks, MESH_TP_RING)["logits"]
                one_plain = serve_pass(
                    cfg, decoder.RunCtx(dev, use_kernel="ref"), params,
                    inputs, toks, MESH_TP_RING)["logits"]
                # the TP gap beside the gaps with no TP (kernels against
                # plain) and with no kernel (TP against one device, both
                # plain): bf16 rounding in each
                rec["vs_single"] = compare_logits(logits, one)
                rec["plain_vs_single_plain"] = compare_logits(plain,
                                                              one_plain)
                rec["single_vs_single_plain"] = compare_logits(one,
                                                               one_plain)
                del params, one, one_plain
                torch.cuda.empty_cache()
                if tag in MESH_TP_F32:
                    params = common.init_params(
                        f32, torch.Generator(device=dev).manual_seed(seed),
                        dev, torch.float32)
                    rec["f32_plain_vs_single"] = compare_logits(
                        plain32, serve_pass(f32, decoder.RunCtx(
                            dev, use_kernel="ref"), params, inputs, toks,
                            MESH_TP_RING)["logits"])
                    del params
                    torch.cuda.empty_cache()
            dist.barrier()
            res[tag] = rec
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_tp_phase(seed: int = 24) -> dict:
    """26b. The dense stack tensor-parallel over MESH_TP gloo ranks of the
    one card, a (1, 4) mesh: glm4-9b (bf16, all 40 layers: 8 of its 32
    q heads a rank, its 2 kv heads gathered) and zamba2-1.2b at full
    width, each prefill then decode steps on the kernels; every rank's
    first prefill_tc, decode_split and ssd_scan.tc calls held to
    ``ref.sdpa_ref`` / ``ref.ssd_ref`` on the same inputs
    (:func:`hold_anchor_calls`); rank 0's logits held to the single-device
    run of the same seed within MODEL_TOL of the largest logit (over the
    prefill and every step, as ``compare_logits`` takes it), and the same
    gap reported with the plain versions on both sides and between the
    single device's kernels and plain versions; the MESH_TP_F32 cells
    also served in f32 on the plain versions, TP held to one device
    within MESH_TP_F32_TOL.  Each rank's parameter
    bytes equal its local shapes' sum, below the whole tree's.  No TP
    speed is claimed: the four ranks share the SMs (``wall_s`` is
    recorded)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config

    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
        sock.close()
        procs = [ctx.Process(target=_tp_rank,
                             args=(r, MESH_TP, port, out, seed))
                 for r in range(MESH_TP)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + MESH_TP_TIMEOUT
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        check(all(proc.exitcode == 0 for proc in procs),
              f"mesh_tp: ranks exited {[p.exitcode for p in procs]}")
        ranks = [torch.load(Path(out) / f"rank{r}.pt")
                 for r in range(MESH_TP)]
    out = {}
    for tag, arch, b, prompt, steps in MESH_TP_CELLS:
        cfg = get_config(arch)
        want = {k: v for k, v in expected_launches(cfg, prompt, steps).items()
                if k not in ("flash", "ssd", "lease")}
        for r, res in enumerate(ranks):
            rec = res[tag]
            emit("mesh_tp", cell=tag, arch=arch, rank=r, batch=b,
                 prompt=prompt, steps=steps, mesh=[1, MESH_TP],
                 **{k: v for k, v in rec.items() if not k.endswith(
                     "_records")},
                 **{f"{k}_by_op": collections.Counter(
                     f"{op} {dt}" for op, dt, _, _ in rec[k])
                    for k in ("prefill_records", "decode_records")})
            check("held_error" not in rec, rec.get("held_error", ""))
            check(rec["held_bytes"] == rec["local_bytes"] < rec["whole_bytes"],
                  f"mesh_tp/{tag}: rank {r} holds {rec['held_bytes']} B, its "
                  f"blocks are {rec['local_bytes']} B of {rec['whole_bytes']}")
            check(rec["launches"] == want, f"mesh_tp/{tag}: rank {r} "
                  f"launches {rec['launches']}, expected {want}")
            check(rec["finite"], f"mesh_tp/{tag}: rank {r} logits not finite")
            check(rec["decode_records"] == ranks[0][tag]["decode_records"],
                  f"mesh_tp/{tag}: ranks record different collectives")
        cmp = ranks[0][tag]["vs_single"]
        check(cmp["rel_diff"] <= MODEL_TOL, f"mesh_tp/{tag}: rank 0's "
              f"logits differ from the single-device run by {cmp}")
        if tag in MESH_TP_F32:
            cmp = ranks[0][tag]["f32_plain_vs_single"]
            check(cmp["rel_diff"] <= MESH_TP_F32_TOL, f"mesh_tp/{tag}: in "
                  f"f32 rank 0's logits differ from one device's by {cmp}")
        out[tag] = dict(ranks[0][tag],
                        peaks=[res[tag]["peak_bytes"] for res in ranks],
                        launches_all_ranks={
                            k: sum(res[tag]["launches"][k] for res in ranks)
                            for k in want})
    return out


# run in a process of its own (the world of placeholder ranks is
# process-wide): the mesh_tp cells on a fake (1, 4) mesh, the estimates
# anchors on a mesh of one, and a production cell; one JSON line a job
DRYRUN_RUNNER = r"""
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh

job = json.loads(sys.argv[2])
def out(**kw):
    print(json.dumps(kw), flush=True)

mesh = make_fake_mesh((1, job["tp"]))
for tag, arch, b, prompt, steps in job["tp_cells"]:
    t0 = time.perf_counter()
    with FakeTensorMode():
        c, run = dryrun.count_serve(get_config(arch), mesh, b, prompt,
                                    job["ring"])
    out(job="mesh_tp", cell=tag, peak_bytes=c.peak_bytes,
        dot_flops=c.dot_flops, host_s=time.perf_counter() - t0,
        prefill_records=run["prefill_records"],
        decode_records=run["decode_records"])
mesh = make_fake_mesh((1, 1))
for path, arch, shape, batch in job["anchors"]:
    t0 = time.perf_counter()
    with FakeTensorMode():
        c, args = dryrun.count_cell(get_config(arch), dataclasses.replace(
            SHAPES[shape], global_batch=batch), mesh)
    out(job="anchor", path=path, peak_bytes=c.peak_bytes,
        argument_bytes=args, dot_flops=c.dot_flops,
        host_s=time.perf_counter() - t0)
t0 = time.perf_counter()
cell = dryrun.run_cell("glm4-9b", "train_4k", False)
out(job="production", host_s=time.perf_counter() - t0, **cell)
"""


def start_dryrun() -> subprocess.Popen:
    """Start :data:`DRYRUN_RUNNER` (host only: it runs beside the examples
    phase, which claims no time, and is read by :func:`dryrun_phase`)."""
    import atexit

    job = dict(tp=MESH_TP, tp_cells=MESH_TP_CELLS, ring=MESH_TP_RING,
               anchors=ANCHOR_CELLS)
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_RUNNER, str(SRC), json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_phase(proc: subprocess.Popen, t_start: float, tp: dict,
                 anchors: dict) -> dict:
    """26c. The port's dry run in a subprocess: the ``mesh_tp`` cells on a
    fake (1, 4) world, whose collective records must equal the ranks'
    (its per-rank peak reported against theirs), the estimates anchors on
    a mesh of one (the predicted peaks against the measured ones), and
    glm4-9b train_4k on pod16x16 with its host seconds."""
    try:
        stdout, stderr = proc.communicate(
            timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter()
                                               - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0, f"dryrun: exit {proc.returncode}: "
          f"{stderr[-3000:]}")
    jobs = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
    out = {"wall_s": time.perf_counter() - t_start}
    for job in jobs:
        if job["job"] == "mesh_tp":
            got = tp[job["cell"]]
            for key in ("prefill_records", "decode_records"):
                check(job[key] == got[key], f"dryrun/{job['cell']}: the "
                      f"fake world's {key} differ from mesh_tp's")
            emit("dryrun_tp", cell=job["cell"], host_s=job["host_s"],
                 records_equal=True, dot_flops=job["dot_flops"],
                 predicted_peak_gb=job["peak_bytes"] / 1e9,
                 measured_peaks_gb=[p / 1e9 for p in got["peaks"]],
                 predicted_over_measured=job["peak_bytes"]
                 / max(got["peaks"]))
        elif job["job"] == "anchor":
            measured = anchors[job["path"]]["cell"]["peak_gb"]
            emit("dryrun_anchor", path=job["path"], host_s=job["host_s"],
                 predicted_peak_gb=job["peak_bytes"] / 1e9,
                 argument_gb=job["argument_bytes"] / 1e9,
                 measured_peak_gb=measured,
                 predicted_over_measured=job["peak_bytes"] / 1e9 / measured)
        else:
            check(job["status"] == "OK", f"dryrun: production cell "
                  f"{job.get('error', job)}")
            emit("dryrun_production", **{k: job[k] for k in (
                "arch", "shape", "mesh", "host_s", "run_s",
                "dot_flops_per_device", "memory_analysis", "roofline")},
                 collective_bytes=job["collectives"]["total_bytes"])
    check(sorted(j["job"] for j in jobs) == ["anchor"] * 3 + ["mesh_tp"] * 2
          + ["production"], f"dryrun: jobs {[j['job'] for j in jobs]}")
    return out


# -- phases 27-29: the sweep, the estimates against the card, the examples ----

SWEEP_VARIANTS = (("ALC~", dict(fine_grained=False)),
                  ("FGL~", dict(fine_grained=True)),
                  ("LILAC~", dict(fine_grained=True, migrate=True)))


def sweep_grid(name: str, locs, seeds: int, n_rounds: int = 512) -> dict:
    """One grid of ``vec_sim`` for each variant, on cuda and on cpu: every
    point's totals and the means bit-equal; wall and points/s a device."""
    import torch

    from repro_torch.core import vec_sim

    t0 = time.perf_counter()
    ccs = np.stack([vec_sim.draw_classes(s, locs, n_rounds=n_rounds)
                    for s in range(seeds)], axis=1)          # [L, S, R, N, 2]
    draw_s = time.perf_counter() - t0
    points = len(locs) * seeds
    runs = {}
    for device in ("cuda", "cpu"):
        runs[device] = {}
        for vname, kw in SWEEP_VARIANTS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = vec_sim.simulate_grid(torch.from_numpy(ccs).to(device),
                                        **kw)
            means = vec_sim.sweep_means(locs, res)
            res = [t.cpu().numpy() for t in res]
            means = {k: v.cpu().numpy() for k, v in means.items()}
            wall = time.perf_counter() - t0
            runs[device][vname] = dict(res=res, means=means, wall_s=wall)
    for vname, _ in SWEEP_VARIANTS:
        a, b = runs["cuda"][vname], runs["cpu"][vname]
        same = all(x.tobytes() == y.tobytes() for x, y in zip(a["res"], b["res"])) \
            and all(a["means"][k].tobytes() == b["means"][k].tobytes()
                    for k in a["means"])
        check(same, f"vec_sim {name}/{vname}: cuda and cpu differ")
    walls = {d: {v: r["wall_s"] for v, r in runs[d].items()} for d in runs}
    out = dict(grid=name, localities=len(locs), seeds=seeds,
               variants=len(SWEEP_VARIANTS), points=points * len(SWEEP_VARIANTS),
               n_rounds=n_rounds, n_nodes=4, n_classes=64, draw_s=draw_s,
               cuda_vs_cpu="bit-equal", wall_s=walls,
               points_per_s={d: points * len(w) / sum(w.values())
                             for d, w in walls.items()})
    if len(locs) <= 8:          # the benchmark's table: throughput, reuse
        out["table"] = {v: [[float(locs[i]),
                             float(runs["cuda"][v]["means"]["throughput"][i]),
                             float(runs["cuda"][v]["means"]["reuse"][i])]
                            for i in range(len(locs))]
                        for v, _ in SWEEP_VARIANTS}
    emit("vec_sim", **out)
    return out


def sweep_trends() -> None:
    """The four trends of tests/test_jax_sim.py, on the card."""
    from repro_torch.core import vec_sim

    def sweep(locs, seeds, **kw):
        out = vec_sim.locality_sweep(locs, seeds=seeds, **kw)
        return {k: v.cpu().numpy() for k, v in out.items()}

    r = sweep([0.0, 0.5, 0.95], 4)["reuse"]
    check(r[2] > r[1] > r[0] and r[2] > 0.5, f"vec_sim: reuse {r} does "
          "not rise with locality")
    fgl = sweep([0.9], 4, fine_grained=True)
    alc = sweep([0.9], 4, fine_grained=False)
    check(fgl["reuse"][0] > alc["reuse"][0]
          and fgl["throughput"][0] >= alc["throughput"][0],
          "vec_sim: FGL does not beat ALC at 0.9")
    base = sweep([0.3], 4, migrate=False)
    mig = sweep([0.3], 4, migrate=True)
    check(mig["lease_moves"][0] < base["lease_moves"][0]
          and mig["throughput"][0] >= base["throughput"][0],
          "vec_sim: migration does not cut lease moves at 0.3")
    a, f, l = (float(sweep([0.9], 6, **kw)["throughput"][0]) for kw in (
        dict(fine_grained=False), dict(fine_grained=True),
        dict(fine_grained=True, migrate=True)))
    check(a <= f + 1e-6 and f <= l + 1e-6,
          f"vec_sim: throughput ALC {a}, FGL {f}, LILAC {l} out of order")
    emit("vec_sim_trends", reuse_0_05_095=[float(x) for x in r],
         reuse_fgl_alc_09=[float(fgl["reuse"][0]), float(alc["reuse"][0])],
         lease_moves_base_mig_03=[float(base["lease_moves"][0]),
                                  float(mig["lease_moves"][0])],
         throughput_alc_fgl_lilac_09=[a, f, l], held=4)


def vec_sim_phase() -> None:
    """27. The benchmark's grid and a wide grid, then the trends."""
    sweep_grid("benchmark", [0.0, 0.3, 0.6, 0.9, 1.0], 4)
    sweep_grid("wide", [i / 100 for i in range(101)], 64)
    sweep_trends()


def anchor_inputs(cfg, shape: str, batch: int, gen, device) -> dict:
    """Real tensors of ``input_specs``' shapes and dtypes (token ids drawn,
    positions counted; a decode step's ``pos`` the cache's last slot)."""
    import torch

    from repro_torch.configs.shapes import input_specs

    out = {}
    for k, meta in input_specs(cfg, shape, batch_override=batch).items():
        if k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, meta.shape,
                                   generator=gen, device=device,
                                   dtype=meta.dtype)
        elif k == "positions":
            s = meta.shape[-1]
            out[k] = torch.arange(s, dtype=meta.dtype, device=device
                                  ).expand(meta.shape).contiguous()
        elif k == "pos":
            from repro_torch.configs.shapes import SHAPES

            out[k] = torch.tensor(SHAPES[shape].seq_len - 1, dtype=meta.dtype,
                                  device=device)
        else:
            raise ValueError(f"anchor cell input {k!r}")
    return out


@contextlib.contextmanager
def first_kernel_calls():
    """Copies of the arguments and output of the first ``ops.attention``
    call over several query rows (``"attention"``, a prefill) and over one
    (``"attention_decode"``), and of the first ``ops.ssd`` call, while it
    is open: one layer's kernel call at the path's own shapes and
    inputs."""
    import torch

    from repro_torch.kernels import ops

    seen = {}
    plain = ops.attention, ops.ssd
    copy = lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t

    def recording(kind, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            name = kind if kind == "ssd" or args[0].shape[1] > 1 \
                else "attention_decode"
            if name not in seen:
                seen[name] = (tuple(map(copy, args)),
                              {k: copy(v) for k, v in kw.items()},
                              tuple(map(copy, out)) if isinstance(out, tuple)
                              else copy(out))
            return out
        return run

    ops.attention, ops.ssd = (recording("attention", plain[0]),
                              recording("ssd", plain[1]))
    try:
        yield seen
    finally:
        ops.attention, ops.ssd = plain


def hold_anchor_calls(path: str, seen: dict, rows=(256, 512)) -> dict:
    """Each recorded kernel call held to its plain version on the same
    inputs: attention to ``ref.sdpa_ref`` at ``FLASH_TOL`` (a prefill on
    its first ``rows[0]`` and last ``rows[1]`` query rows against every
    key, as a full score matrix at S = 32768 would not fit; a decode on
    every row over the whole ring), the SSD scan to ``ref.ssd_ref`` batch
    row by batch row (y within 1e-2 of max |y| in bf16, 2e-5 in f32; the
    final state at atol 2e-3, rtol 1e-4, as ``ssd_case``)."""
    import torch

    from repro_torch.kernels import ref

    out = {}
    for name in ("attention", "attention_decode"):
        if name not in seen:
            continue
        (q, k, v), kw, got = seen[name]
        kw = {n: x for n, x in kw.items() if n not in ("plain", "return_lse")}
        sq = q.shape[1]
        spans = [slice(0, sq)] if sq <= sum(rows) else \
            [slice(0, rows[0]), slice(sq - rows[1], sq)]
        atol, rtol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
        err, held = 0.0, 0
        for sl in spans:
            want = ref.sdpa_ref(
                q[:, sl], k, v, **dict(kw, q_positions=kw["q_positions"][:, sl]))
            part = got[:, sl].float()
            check(bool(torch.isfinite(part).all()) and torch.allclose(
                part, want.float(), atol=atol, rtol=rtol),
                f"{path}: flash kernel disagrees with ref.sdpa_ref at "
                f"{tuple(q.shape)} x {tuple(k.shape)} rows {sl}")
            err = max(err, float((part - want.float()).abs().max()))
            held += sl.stop - sl.start
            del want, part
        out[name] = dict(q=list(q.shape), kv=list(k.shape), rows_held=held,
                         max_abs_err=err, atol=atol, rtol=rtol)
    if "ssd" in seen:
        (x, dt, a, bm, cm), kw, (y, f) = seen["ssd"]
        rel = 1e-2 if x.dtype == torch.bfloat16 else 2e-5
        err_y = err_f = y_max = 0.0
        for i in range(x.shape[0]):
            h0 = kw.get("h0")
            y_r, f_r = ref.ssd_ref(x[i:i + 1], dt[i:i + 1], a, bm[i:i + 1],
                                   cm[i:i + 1], chunk=kw["chunk"],
                                   h0=None if h0 is None else h0[i:i + 1])
            check(bool(torch.isfinite(y[i]).all() and torch.isfinite(f[i]).all()),
                  f"{path}: SSD kernel output not finite")
            check(torch.allclose(f[i:i + 1], f_r, atol=2e-3, rtol=1e-4),
                  f"{path}: SSD kernel final state disagrees with ref.ssd_ref "
                  f"(row {i}, max abs err {float((f[i:i + 1] - f_r).abs().max())})")
            err_y = max(err_y, float((y[i:i + 1].float() - y_r).abs().max()))
            err_f = max(err_f, float((f[i:i + 1] - f_r).abs().max()))
            y_max = max(y_max, float(y_r.abs().max()))
            del y_r, f_r
        check(err_y / (y_max + 1e-9) < rel,
              f"{path}: SSD kernel y disagrees with ref.ssd_ref (max abs err "
              f"{err_y}, max |y| {y_max})")
        out["ssd"] = dict(x=list(x.shape), chunks=x.shape[1] // kw["chunk"],
                          max_abs_err_y=err_y, max_abs_y=y_max,
                          max_abs_err_state=err_f, y_rel_tol=rel,
                          state_atol=2e-3, state_rtol=1e-4)
    check(bool(out), f"{path}: no kernel call recorded")
    return out


def anchor_cell(path: str, arch: str, shape: str, batch: int, params,
                steps: int = 6) -> dict:
    """One grid cell at full width and depth, its batch cut to ``batch``,
    on the kernels: peak memory against ``estimate(..., n_chips=1, tp=1,
    param_bytes=2)``'s residency and the step's time against the roofline
    bound of 2·N·D and the estimate's traffic (the reference dry run's
    yardsticks for an inference step).  A prefill runs once untimed, then
    timed with the counts reset just before; a decode step runs at the
    cache's last position against a full ring filled at init (``steps``
    steps timed), then one step under the profiler."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch.estimates import estimate
    from repro_torch.launch.roofline import model_flops, roofline_terms
    from repro_torch.models import common, decoder

    cfg = get_config(arch)
    full = SHAPES[shape]
    spec = dataclasses.replace(full, global_batch=batch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = anchor_inputs(cfg, shape, batch, gen, dev)
    ctx = decoder.RunCtx(dev, use_kernel="auto")
    dt = cfg.compute_dtype()
    kinds = common.layer_plan(cfg).kinds
    n_attn = sum(k.mixer in ATTN_MIXERS for k in kinds)
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    want = dict.fromkeys(fa.VARIANTS, 0)
    want.update({f"ssd_{v}": 0 for v in ss.VARIANTS})
    if spec.kind == "prefill":
        def run():
            return decoder.prefill(cfg, ctx, params, inputs)

        with first_kernel_calls() as seen:        # untimed: allocator growth
            logits, caches = run()
        del logits, caches
        passes, tokens = 1, batch * full.seq_len
        if n_attn:
            want[fa.variant(dt, full.seq_len, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.head_dim)] = n_attn
        if n_mamba:
            s = cfg.ssm
            want[f"ssd_{ss.variant(dt, s.head_dim, s.d_state, s.chunk)}"] = \
                n_mamba
    else:
        ring = decoder.init_cache(cfg, batch, full.seq_len, dt, dev)
        for layer in ring:                        # a full ring of random K/V
            for leaves in layer.values():
                for buf in leaves.values():
                    buf.normal_(generator=gen)

        def run():
            return decoder.decode_step(cfg, ctx, params, ring,
                                       inputs["tokens"], inputs["pos"])

        with first_kernel_calls() as seen:        # untimed
            run()
        passes, tokens = steps, batch
        want[fa.variant(dt, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.head_dim)] = n_attn * steps
    held = hold_anchor_calls(path, seen)
    del seen
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_model_counts()                          # just before the path
    t0 = time.perf_counter()
    for _ in range(passes):
        logits, _ = run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / passes
    counts = model_counts()
    counts.pop("backward")
    peak = torch.cuda.max_memory_allocated()
    check(counts == want, f"{path}: kernel launches {counts}, expected {want}")
    check(tuple(logits.shape) == (batch, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{path}: logits {tuple(logits.shape)} not finite or misshapen")
    del logits, _
    prof = device_profile(run)
    est = estimate(cfg, spec, n_chips=1, tp=1, param_bytes=2)
    # 6·N·D counts forward and backward; an inference step is 2·N·D
    flops = model_flops(cfg.param_count(), tokens,
                        cfg.active_param_count()) / 3.0
    terms = roofline_terms(flops, est.traffic_bytes, 0.0)
    # 2·N·D leaves out attention's own work: 2·(Dk + Dv) a visible
    # (query, key) pair and head, causal in a prefill, the whole ring in
    # a decode step
    s_kv = full.seq_len
    pairs = (s_kv * (s_kv + 1) // 2 if spec.kind == "prefill" else s_kv) \
        * batch
    attn_flops = 2.0 * pairs * cfg.n_heads * 2 * cfg.head_dim * n_attn
    terms_attn = roofline_terms(flops + attn_flops, est.traffic_bytes, 0.0)
    busy = prof["device_busy_ms"]
    out = dict(path=path, arch=arch, shape=shape, batch=batch,
               published_batch=full.global_batch, seq=full.seq_len,
               n_layers=cfg.n_layers, d_model=cfg.d_model,
               step_s=step_s, steps_timed=passes, launches=counts,
               peak_gb=peak / 1e9, est_residency_gb=est.residency_bytes / 1e9,
               peak_over_est=peak / est.residency_bytes,
               est_traffic_gb=est.traffic_bytes / 1e9,
               est_detail_gb={k: v / 1e9 for k, v in est.detail.items()},
               est_fits=est.as_dict(), flops_2nd=flops, roofline=terms,
               bound_share_of_step=terms["bound_s"] / step_s,
               attn_flops=attn_flops, roofline_with_attn=terms_attn,
               bound_with_attn_share_of_step=terms_attn["bound_s"] / step_s,
               held=held,
               device_busy_ms=busy,
               bound_share_of_busy=(terms["bound_s"] * 1e3 / busy
                                    if busy else None),
               idle=(1 - busy / prof["wall_ms"]) if busy else None,
               profile_wall_ms=prof["wall_ms"], top=prof["top"],
               repo_kernels=prof["repo_kernels"])
    out["est_fits"].pop("detail")
    emit("estimates_anchor", **out)
    return dict(counts, cell=out)


# (path, arch, shape, batch): the grid cells held to the estimates
ANCHOR_CELLS = (("anchor_glm4_prefill_32k", "glm4-9b", "prefill_32k", 1),
                ("anchor_glm4_decode_32k", "glm4-9b", "decode_32k", 16),
                ("anchor_mamba2_prefill_32k", "mamba2-780m", "prefill_32k",
                 4))


def estimates_anchor_phase() -> dict:
    """28. The analytic estimates against real steps on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common

    dev = torch.device("cuda")
    out = {}
    for arch in dict.fromkeys(a for _, a, _, _ in ANCHOR_CELLS):
        cfg = get_config(arch)
        params = common.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev,
            cfg.compute_dtype())
        for path, _, shape, batch in (c for c in ANCHOR_CELLS
                                      if c[1] == arch):
            t0 = time.perf_counter()
            out[path] = anchor_cell(path, arch, shape, batch, params)
            emit(f"{path}_done", wall_s=time.perf_counter() - t0)
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return out


# run an example as ``__main__`` with every kernel count at 0, then print
# the counts the run made
EXAMPLE_RUNNER = r"""
import json, runpy, sys
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lease_validate as lv
from repro_torch.kernels import ssd_scan as ss
fa.launches = ss.launches = lv.launches = 0
fa.backward_launches = ss.backward_launches = 0
for counts in (fa.variant_launches, ss.variant_launches, lv.variant_launches,
               fa.backward_variant_launches, ss.backward_variant_launches):
    for k in counts:
        counts[k] = 0
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("kernel_counts " + json.dumps(dict(
    **fa.variant_launches, **{"ssd_" + k: v for k, v in ss.variant_launches.items()},
    **{"lease_" + k: v for k, v in lv.variant_launches.items()},
    **{"flash_attention.backward." + k: v
       for k, v in fa.backward_variant_launches.items()},
    **{"ssd_scan.backward." + k: v
       for k, v in ss.backward_variant_launches.items()})), flush=True)
"""

EXAMPLES = ("quickstart", "serve_migration", "train_100m", "failover_recovery")
# the smoke's cut of an example's run: train_100m takes 100 of its 300
# default steps
EXAMPLE_ARGS = {"train_100m": ["--steps", "100"]}


def _part1(text: str) -> list:
    """quickstart's part 1: its header through the blank line after it."""
    lines = text.splitlines()
    start = lines.index("== 1. Replicated STM cluster (paper §4, Bank "
                        "benchmark) ==")
    return lines[start:lines.index("", start)]


def examples_phase(timeout_s: float = 420.0) -> dict:
    """29. The four examples as subprocesses on the card, all at once
    (train_100m at EXAMPLE_ARGS' 100 steps), and quickstart's part 1 on
    ``--device cpu`` beside them: each exits 0, and part 1 prints the same
    lines on both devices."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    try:
        for name in EXAMPLES:
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER,
                 str(ROOT / "examples" / "torch" / f"{name}.py"),
                 *EXAMPLE_ARGS.get(name, [])],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        procs["quickstart_cpu"] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             f"{str(ROOT / 'examples' / 'torch')!r}); import quickstart; "
             "quickstart.part1_cluster('cpu')"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        done = {}
        for name, p in procs.items():
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            out, err = p.communicate(timeout=left)
            done[name] = dict(rc=p.returncode, out=out, err=err,
                              wall_s=time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    counts = {}
    for name, r in done.items():
        check(r["rc"] == 0, f"examples/torch/{name}: exit {r['rc']}\n"
              f"{r['out'][-2000:]}\n{r['err'][-3000:]}")
        if name in EXAMPLES:
            line = [x for x in r["out"].splitlines()
                    if x.startswith("kernel_counts ")]
            check(len(line) == 1, f"examples/torch/{name}: no counts")
            counts[name] = json.loads(line[0].split(" ", 1)[1])
        emit("examples", example=name, rc=r["rc"], done_by_s=r["wall_s"],
             launches=counts.get(name), tail=r["out"].splitlines()[-6:])
    same = _part1(done["quickstart"]["out"]) == _part1(
        done["quickstart_cpu"]["out"])
    emit("examples_quickstart_part1", cuda_equals_cpu=same,
         lines=_part1(done["quickstart"]["out"]))
    check(same, "quickstart part 1 differs between cuda and cpu")
    return {f"examples_{k}": v for k, v in counts.items()}


# -- phase 30: the static lint, and the card's sync sites held to it ---------

LINT_TIMEOUT = 300.0
# where a train step must not wait on the device (the kernels' forward and
# backward dispatch)
TRAIN_QUIET_FILES = tuple(f"src/repro_torch/kernels/{m}.py" for m in (
    "ops", "flash_attention", "ssd_scan"))
INVISIBLE_SYNCS = (
    "a wait inside a ctypes library (lease_drain_launch's, the drain's one "
    "wait) warns under neither the sync debug mode nor the lint; a "
    "torch.cuda.Event wait (the scorer's harvest, plan/score.py) does not "
    "warn under the debug mode, and the lint flags it")


def lint_phase() -> dict:
    """``python -m repro_torch.analysis.lint --no-baseline`` over
    ``src/repro_torch`` in a process of its own (exit code 0, no violation;
    its host seconds), the inline allows by rule, and the sync sites of
    SYNC_SITES by call, each with its count in that one call.  Every
    observed site must be a line the ``host-sync`` rule flags (allows not
    applied: an intended sync is flagged and allowed); ``flagged_quiet``
    lists the flagged lines that ran in a recorded call without a wait
    being seen there."""
    import os

    from repro_torch.analysis import lint
    from repro_torch.analysis.rules import ALL_RULES, host_sync

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--no-baseline"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=LINT_TIMEOUT)
    host_s = time.perf_counter() - t0
    violations = []
    allows = collections.Counter()      # violations an allow suppresses
    flagged = {}                        # file -> lines host-sync flags
    for path in sorted(lint.DEFAULT_TARGET.rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        ctx = lint.FileCtx(path, rel, path.read_text(), lint.Project())
        raw = [v for rule in ALL_RULES for v in rule.check(ctx)]
        kept = lint.apply_allows(ctx, raw)
        violations += kept
        allows += collections.Counter(v.rule for v in raw) \
            - collections.Counter(v.rule for v in kept)
        flagged[rel] = {v.line for v in raw if v.rule == host_sync.RULE.id}
    by_call, unflagged = {}, []
    for call, (sites, executed) in SYNC_SITES.items():
        for at in sites:
            rel, _, line = at.rpartition(":")
            if not line.isdigit() or int(line) not in flagged.get(rel, ()):
                unflagged.append(f"{call}: {at}")
        quiet = sorted(at for at in executed if at not in sites
                       and int(at.rpartition(":")[2]) in flagged.get(
                           at.rpartition(":")[0], ()))
        by_call[call] = dict(syncs=sum(sites.values()), sites=dict(sites),
                             flagged_quiet=quiet)
    out = dict(exit_code=proc.returncode, rules=len(ALL_RULES),
               violations=len(violations), allows=dict(sorted(allows.items())),
               host_sync_flagged=sum(map(len, flagged.values())),
               host_s=host_s, calls=len(by_call), sync_sites=by_call,
               unflagged=unflagged, invisible=INVISIBLE_SYNCS)
    emit("lint", **out)
    check(proc.returncode == 0, f"lint: exit code {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    check(not violations, f"lint: {len(violations)} violations")
    check(not unflagged, f"lint: sync sites the host-sync rule does not "
          f"flag: {unflagged}")
    train = SYNC_SITES.get("train_profile/train_step", ({}, set()))[0]
    in_kernels = [at for at in train
                  if at.rpartition(":")[0] in TRAIN_QUIET_FILES]
    check("train_profile/train_step" in SYNC_SITES and not in_kernels,
          f"lint: the train step waits in the kernels' modules: "
          f"{in_kernels}")
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    # 1. env
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    emit("env", device=name, count=count, nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build: one nvcc per kernel, all at once
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lease_validate as lv
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import ssd_scan as ss

    t0 = time.perf_counter()
    nvcc.build_all([lv.LIB, fa.LIB, ss.LIB])
    emit("build", wall_s=time.perf_counter() - t0, **lv.LIB.info,
         flash_attention=fa.LIB.info, ssd_scan=ss.LIB.info)
    tc_builds = ptxas_kernels(fa.LIB.info, "prefill_tc_kernel")
    emit("build_prefill_tc", instantiations=tc_builds)
    check(fa.LIB.info.get("cached") or sorted(
        tuple(k["dims"]) for k in tc_builds) == sorted(fa.PREFILL_TC_DIMS),
          f"ptxas reported prefill_tc {tc_builds}, expected "
          f"{fa.PREFILL_TC_DIMS}")
    # the tc backward's kernels: dkdv_tc, or dkdv_tc2 where one warpgroup
    # cannot hold dK and dV, and dq_tc, at every pair; none spills
    bwd_builds = {kind: ptxas_kernels(fa.LIB.info, f"{kind}_kernel")
                  for kind in ("dkdv_tc", "dkdv_tc2", "dq_tc")}
    emit("build_backward_tc", **bwd_builds)
    pairs = sorted(fa.BACKWARD_TC_DIMS)
    check(fa.LIB.info.get("cached") or (
        sorted(tuple(k["dims"]) for k in bwd_builds["dkdv_tc"]
               + bwd_builds["dkdv_tc2"]) == pairs
        and sorted(tuple(k["dims"]) for k in bwd_builds["dq_tc"]) == pairs
        and not any(k["spill_stores"] or k["spill_loads"]
                    for ks in bwd_builds.values() for k in ks)),
          f"ptxas reported the tc backward {bwd_builds}, expected {pairs} "
          f"without a spill")
    mla_registers = [dict(kernel=kind, **k) for kind, ks in bwd_builds.items()
                     for k in ks if k["dims"] == [192, 128]]
    # the simt kernels (split-TF32 mma.sync): each instantiation of the
    # forward (warps, m-tiles, Dv n-tiles) and of the backward's dkdv
    # (pairs, q rows) and dq (warps, keys, Dk n-tiles), none spilling
    simt_builds = {kind: ptxas_kernels(fa.LIB.info, marker)
                   for kind, marker in (("forward", "4simt12flash_kernel"),
                                        ("dkdv", "8backward11dkdv_kernel"),
                                        ("dq", "8backward9dq_kernel"))}
    emit("build_simt", **simt_builds)
    check(fa.LIB.info.get("cached") or (
        [len(simt_builds[k]) for k in ("forward", "dkdv", "dq")] == [8, 3, 5]
        and not any(k["spill_stores"] or k["spill_loads"]
                    for ks in simt_builds.values() for k in ks)),
          f"ptxas reported the simt kernels {simt_builds}, expected 8 "
          f"forward, 3 dkdv and 5 dq instantiations without a spill")

    # the SSD simt kernels: forward state and chunk kernels, the backward's
    # own and chunk kernels, each instantiation's registers; none spills
    ssd_builds = {marker: ptxas_kernels(ss.LIB.info, marker)
                  for marker in SSD_SIMT_KERNELS}
    emit("build_ssd_simt", **ssd_builds)
    check(ss.LIB.info.get("cached") or (
        {m: len(ks) for m, ks in ssd_builds.items()} == SSD_SIMT_KERNELS
        and not any(k.get("spill_stores") or k.get("spill_loads")
                    for ks in ssd_builds.values() for k in ks)),
          f"ptxas reported the SSD simt kernels {ssd_builds}, expected "
          f"{SSD_SIMT_KERNELS} instantiations without a spill")

    # 3. kernel vs plain version
    rng = np.random.default_rng(0)
    n_main = 1_140_088
    main_cases = [kernel_case(f"main_B{b}", rng, n_main, b, 32, 16, 2000)
                  for b in (8, 16)]
    kernel_case("main_B16_lockfree", rng, n_main, 16, 32, 1, 2000,
                lock_free=True)
    kernel_case("wide", rng, 1 << 20, 1024, 256, 64, 200)

    # 3b. the drain against its twin, and a drain's routes timed
    drain_cases, item_cc, n_classes = kernel_drain_phase()

    # 4. main path: TPC-C at spec cardinalities, cuda then cpu
    main_cfg = dict(threads_per_node=16, certify_window_ms=0.5,
                    duration_ms=300.0, warmup_ms=45.0, seed=0)
    card = main_card = run_cluster("tpcc", "cuda", main_cfg)
    main_launches = card["launches"]
    emit("main", device="cuda", **summary(card))
    check_drains("main", card)
    host = run_cluster("tpcc", "cpu", main_cfg)
    emit("main", device="cpu", **summary(host))
    compare_runs("main", card, host)
    check(card["kernel_txns"] == host["kernel_txns"],
          "main: batched certification volume differs between cuda and cpu")

    # 5. forced path: every drain and settle on the device
    forced_cfg = dict(certify_jax_min=1, lease_jax_min=1,
                      cert_slot_mode="per_txn")
    from repro_torch.core import cluster as cluster_mod
    from repro_torch.core.lease_batched import ShardedLeaseManager

    with sites_of_call("forced/settle", ShardedLeaseManager, "settle",
                       nth=3, when=lambda *a, use_kernel=False, **kw:
                       use_kernel), \
            sites_of_call("forced/drain", cluster_mod, "validate_batch",
                          nth=3):
        card = forced_card = run_cluster("bank", "cuda", forced_cfg,
                                         fail_at=120.0)
    emit("forced", device="cuda", **summary(card))
    check_drains("forced", card)
    host = run_cluster("bank", "cpu", forced_cfg, fail_at=120.0)
    emit("forced", device="cpu", **summary(host))
    compare_runs("forced", card, host)

    # 5b. device operations per drain of the two card routes, profiled
    for b in (8, 16):
        drain_routes(np.random.default_rng(4), item_cc, n_classes, b, 0,
                     profile=True)

    # 6-7. the model kernels against their plain versions
    t0 = time.perf_counter()
    flash_cases = kernel_flash_phase()
    emit("kernel_flash_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    ssd_cases = kernel_ssd_phase()
    emit("kernel_ssd_done", wall_s=time.perf_counter() - t0)

    # 8-9. the model stack at full width and depth
    both = ("prefill", "decode_step")
    glm4 = model_phase("glm4", "glm4-9b", sites=both)
    mamba2 = model_phase("mamba2", "mamba2-780m", sites=("prefill",))

    # 8b-8c. the MoE models at full width, depth cut to fit one card; at
    # 8192 tokens mixtral's 4096-key window masks
    t0 = time.perf_counter()
    mixtral = model_phase("mixtral", "mixtral-8x7b", n_layers=8, batch=1,
                          prompt=8192, ring=8224, sites=both)
    emit("mixtral_done", wall_s=time.perf_counter() - t0)
    check(dict(prefill_tc=mixtral["prefill_tc"],
               decode_split=mixtral["decode_split"], simt=mixtral["simt"])
          == dict(prefill_tc=8, decode_split=128, simt=0),
          f"mixtral: flash launches {mixtral}")
    t0 = time.perf_counter()
    deepseek = model_phase("deepseek", "deepseek-v2-236b", n_layers=4,
                           batch=2, prompt=2048, ring=2080, sites=both)
    emit("deepseek_done", wall_s=time.perf_counter() - t0)
    check(dict(simt=deepseek["simt"], prefill_tc=deepseek["prefill_tc"],
               decode_split=deepseek["decode_split"], flash=deepseek["flash"])
          == dict(simt=0, prefill_tc=4, decode_split=0, flash=4),
          f"deepseek: flash launches {deepseek}")

    # 8d-8h. the rest of the model stack at full width and depth: zamba2
    # (Mamba2 + six shared attention sites: both model kernels on one
    # path), minitron, gemma3 (all 62 layers, 54 GB of weights; at 4096
    # tokens its 1024-key window masks), qwen2-vl (an image and text from
    # embeddings, M-RoPE positions), hubert (the encoder's forward)
    rest = {}
    for phase, arch, kw, want in (
            ("zamba2", "zamba2-1.2b", dict(sites=("decode_step",)),
             dict(ssd_tc=32, ssd_simt=0, prefill_tc=6, decode_split=96,
                  simt=0)),
            ("minitron", "minitron-4b", {},
             dict(prefill_tc=32, decode_split=512, simt=0)),
            ("gemma3", "gemma3-27b", dict(batch=1, prompt=4096, ring=4128,
                                          by_layer=True,
                                          sites=("decode_step",)),
             dict(prefill_tc=62, decode_split=992, simt=0)),
            ("qwen2vl", "qwen2-vl-2b", {},
             dict(prefill_tc=28, decode_split=448, simt=0)),
            ("hubert", "hubert-xlarge", {},
             dict(prefill_tc=48, decode_split=0, simt=0))):
        t0 = time.perf_counter()
        rest[phase] = model_phase(phase, arch, **kw)
        emit(f"{phase}_done", wall_s=time.perf_counter() - t0)
        got = {k: rest[phase][k] for k in want}
        check(got == want, f"{phase}: kernel launches {got}, expected {want}")

    # 10. the card against the CPU port
    t0 = time.perf_counter()
    held_phase()
    emit("held_done", wall_s=time.perf_counter() - t0)

    # 10b-10d. routed experts; real-decode serving on the card, and held
    # to the same serving on the CPU
    t0 = time.perf_counter()
    moe_routed_phase()
    emit("moe_routed_phase_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    serve_real = serve_real_phase({"mixtral-8x7b": 8, "deepseek-v2-236b": 4,
                                   "zamba2-1.2b": 38})
    emit("serve_real_phase_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    serve_real_held_phase({"mixtral-8x7b": 2, "deepseek-v2-236b": 2,
                           "zamba2-1.2b": 6})
    emit("serve_real_held_done", wall_s=time.perf_counter() - t0)

    # 11-14. serving on SimBackend and the placement planner
    t0 = time.perf_counter()
    serve_launches, serve_results = serve_phase()
    emit("serve_done", wall_s=time.perf_counter() - t0)
    rng = np.random.default_rng(5)
    serve_cases = [serve_drain_case(rng, 256, b, d)
                   for b, d in ((4, 16), (6, 160))]
    t0 = time.perf_counter()
    serve_plan_phase()
    emit("serve_plan_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    plan_score_phase()
    emit("plan_score_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    sim_plan = sim_plan_phase(main_cfg)
    emit("sim_plan_done", wall_s=time.perf_counter() - t0)

    # 15-20. runtime analysis: the sanitizer and the explorer on the card
    t0 = time.perf_counter()
    main_san = sanitized_phase("main_sanitized", "tpcc", main_cfg, main_card)
    emit("main_sanitized_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    forced_cut = dict(forced_cfg, duration_ms=FORCED_SANITIZED_MS)
    forced_san = sanitized_phase(
        "forced_sanitized", "bank", forced_cut,
        run_cluster("bank", "cuda", forced_cut, fail_at=120.0),
        fail_at=120.0)
    emit("forced_sanitized_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    serve_san = serve_sanitized_phase(serve_results)
    emit("serve_sanitized_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    explore_phase()
    emit("explore_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    explore_kernel = explore_kernel_phase()
    emit("explore_kernel_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mutants_phase()
    emit("mutants_done", wall_s=time.perf_counter() - t0)

    # 21-23. single-device training: each kernel's autograd Function at
    # the training shapes, the trainer at zamba2's full width and depth
    # (remat none and full), one step profiled, the train step held to the
    # CPU; deepseek-v2's first layer at full width trained and held
    t0 = time.perf_counter()
    grad_cases = kernel_grad_phase(mla_registers)
    emit("kernel_grad_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train = {remat: train_phase(remat) for remat in ("none", "full")}
    emit("train_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_profile_phase()
    emit("train_profile_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_held = train_held_phase()
    emit("train_held_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_mla = train_mla_phase()
    emit("train_mla_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_mla_held = train_mla_held_phase()
    emit("train_mla_held_done", wall_s=time.perf_counter() - t0)
    train_paths = {"train": train["none"]["launches"],
                   "train_remat_full": train["full"]["launches"],
                   "train_mla": train_mla["launches"]}
    backward_paths = {"train": train["none"]["backward_launches"],
                      "train_remat_full": train["full"]["backward_launches"],
                      "train_held": train_held["launches"]["backward"],
                      "train_mla": train_mla["backward_launches"],
                      "train_mla_held":
                          train_mla_held["launches"]["backward"]}

    # 24-26. the mesh on a world of one NCCL rank: the sharded MoE paths,
    # data-parallel training, seq-sharded decode through decode_split's
    # log-sum-exp
    t0 = time.perf_counter()
    mesh_moe_phase()
    emit("mesh_moe_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh_train = mesh_train_phase(train)
    emit("mesh_train_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh_decode = mesh_decode_phase()
    emit("mesh_decode_done", wall_s=time.perf_counter() - t0)
    import torch.distributed as dist

    dist.destroy_process_group()
    backward_paths["mesh_train"] = mesh_train["backward_launches"]
    mesh_paths = {"mesh_train": mesh_train["counts"],
                  **{f"mesh_decode_{k}": c
                     for k, c in mesh_decode["counts"].items()}}

    # 26b. the dense stack tensor-parallel over 4 gloo ranks of the card
    t0 = time.perf_counter()
    tp = mesh_tp_phase()
    emit("mesh_tp_done", wall_s=time.perf_counter() - t0)
    mesh_paths.update({f"mesh_tp_{tag}": rec["launches_all_ranks"]
                       for tag, rec in tp.items()})

    # 26d. MLA's multi-token steps over a ring cut over 4 gloo ranks
    t0 = time.perf_counter()
    mla_seq = mla_seq_gloo_phase()
    emit("mesh_mla_seq_done", wall_s=time.perf_counter() - t0)
    mesh_paths["mesh_mla_seq"] = {k: v for k, v in
                                  mla_seq["launches_all_ranks"].items()
                                  if k != "lse"}

    # 27-29. the batched policy sweep, the analytic estimates against real
    # steps at the grid's 32k shapes, the four examples as users run them
    t0 = time.perf_counter()
    vec_sim_phase()
    emit("vec_sim_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    anchors = estimates_anchor_phase()
    emit("estimates_anchor_done", wall_s=time.perf_counter() - t0)
    # 26c. the dry run on the host, beside the examples (which claim no
    # time): fake ranks against mesh_tp's and the anchors, a production
    # cell
    t0 = dry_t0 = time.perf_counter()
    dry = start_dryrun()
    example_paths = examples_phase()
    emit("examples_done", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    dryrun_phase(dry, dry_t0, tp, anchors)
    emit("dryrun_done", wall_s=time.perf_counter() - t0)
    new_paths = {**{k: {n: c for n, c in v.items() if n != "cell"}
                    for k, v in anchors.items()}, **example_paths}

    # 30. the static lint over the port, and the sync sites recorded above
    t0 = time.perf_counter()
    lint_phase()
    emit("lint_done", wall_s=time.perf_counter() - t0)

    drain_paths = {"main": main_launches["drain"],
                   "serve_jax_min_1": serve_launches[1],
                   "serve_jax_min_8": serve_launches[8],
                   "sim_plan": sim_plan["launches"]["drain"],
                   "main_sanitized": main_san["launches"]["drain"],
                   "forced_sanitized": forced_san["launches"]["drain"],
                   "serve_sanitized": serve_san,
                   "explore_kernel": explore_kernel,
                   **{k: v["lease_drain"] for k, v in example_paths.items()}}

    lease = "src/repro_torch/kernels/csrc/lease_validate.cu"
    lease_tpu = "src/repro/kernels/lease_validate.py:70"
    print(smi_line, flush=True)
    print(json.dumps({"kernels": [
        # main_cases[1]: B = 16, R = 32, W = 16; drain_cases[1] the same
        dict(kernel_record("lease_validate.gather", lease, lease_tpu,
                           main_launches["gather"],
                           [dict(main_cases[1], library_ms=None),
                            *main_cases]),
             floor_ms=main_cases[1]["floor_ms"],
             floor_graph_ms=main_cases[1]["floor_graph_ms"]),
        dict(kernel_record("lease_validate.drain", lease, lease_tpu,
                           sum(drain_paths.values()),
                           [drain_cases[1], *drain_cases, *serve_cases]),
             launches_by_path=drain_paths),
        *(with_lse(r, mesh_decode) for r in flash_records(flash_cases, {
              "glm4": glm4, "mamba2": mamba2, "mixtral": mixtral,
              "deepseek": deepseek, **rest,
              "serve_real_mixtral": serve_real["mixtral-8x7b"],
              "serve_real_deepseek": serve_real["deepseek-v2-236b"],
              "serve_real_zamba2": serve_real["zamba2-1.2b"],
              **train_paths, **mesh_paths, **new_paths})),
        *ssd_records(ssd_cases, {"mamba2": mamba2, "zamba2": rest["zamba2"],
                                 **train_paths, **mesh_paths, **new_paths}),
        *backward_records(grad_cases, {
            **backward_paths,
            **{k: v for k, v in example_paths.items()
               if k == "examples_train_100m"}}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
