#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and PyTorch built for CUDA; imports nothing of
JAX or of the JAX package.  Phases, each of which exits non-zero on failure
and ends with a ``clock:`` line (seconds since the script started):

1. device check — CUDA present, the card's name and power limit from
   ``nvidia-smi``, TF32 off for matmuls and convolutions;
D. dry-run — right after phase 1, a CPU subprocess (no card visible to it)
   runs ``launch/dryrun.py`` / ``launch/fed_dryrun.py`` on fake tensors
   for configurations the card phases run (``dryrun_entries``: phase 6's
   ``DRY_SERVE`` at their prefill and one decode step, 8 (a)'s
   ``DRY_TRAIN`` steps, phase 4's main path; under ``--nccl`` each rank of
   6b's ``DRY_MP`` and of 8 (h)), beside every card phase; phase 9 reads it;
2. build — the four sources of ``src/repro_torch/csrc`` compiled for
   sm_90a, one ``nvcc`` per source, in parallel; the five kernels bound
   (``server_update.cu`` holds the dense fold and the dequant fold); then
   the tensor-core instructions (``HMMA``) of every compiled kernel, counted
   in ``cuobjdump -sass``: each tensor-core kernel of ``flash_attention``
   and ``ssd_scan`` (the bf16 routes, ``*_mma_kernel``) must have some; their
   local-memory loads and stores (``LDL`` / ``STL``: register spills),
   printed; and the bulk copies (``UBLKCP``, ``cp.async.bulk`` global ->
   shared) of each of the 32 ``fold_kernel`` instantiations, which must
   have some;
3. kernels vs plain — each kernel against its plain PyTorch version on the
   card, at the main path's plane (C, P) = (25, 22026) and at a ResNet-18
   sized plane (25, 11173962, ragged on purpose): ``fed_direction`` at
   n_aux 0–3 for f32 and bf16 x and in the aux orders of the other
   specs (``FD_LAYOUTS``: SCAFFOLD's and FedDyn's per-client aux before a
   broadcast one, FedProx's broadcast x_t), ``server_update`` at all four
   write_x/write_m combinations for f32 and bf16 momentum, and
   ``dequant_update`` for int8 and bf16 q × f32 and bf16 momentum × the
   four write combinations; then both folds at ``FOLD_EDGES`` (a
   misaligned plane view, C of 1 and 100, ragged narrow planes, C = 1000
   streaming through the ring); every fold case is launched twice and
   required bitwise equal to the first launch (determinism) and to its
   plain version.  The launch floor, a one-element ``fill_`` timed the
   same way, is printed beside the main-plane folds.  Then both folds with
   the staleness discount γ ≠ 1 on their coefficient row (``GAMMAS``: 0.9
   and 0.81) at both planes, x and m written: ``server_update`` with f32
   and bf16 momentum, ``dequant_update`` with int8 and bf16 q; each
   launched twice, bitwise against the first launch and its plain version,
   its time printed beside its γ = 1 twin.  Then both kernels of the
   federated LM's round at its cohort plane (``FULL_C``, ``FULL_P``) = (2,
   1,235,814,400), 9.9 GB, each alone on an emptied card:
   ``fed_direction`` with one broadcast f32 aux within tolerance,
   ``server_update`` with f32 m, x and m written, bitwise.  Times are CUDA-event
   medians of 21 samples of a CUDA-graph replay, so they are device time
   without the host's launch cost; ``eager_ms`` is the time per call when
   Python launches each call, which is what the main path pays.  ``flash_attention`` at the
   serving shape (B=4, S=1024, H=32, Hkv=8, hd=64, bf16, causal; timed
   beside ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
   as the library yardstick), at a ragged shape with a window and
   q_offset that leaves rows no key, in f32 with hd=128 without the
   causal mask, in bf16 with hd=128 at a ragged causal shape, in bf16
   without the causal mask (GQA, Sq ≠ Skv), then at the other archs'
   shapes, each beside SDPA: gemma3's serving shape (H=16, Hkv=8, hd=256),
   its local layer past the 1024 window (S=2048), the f32 route at hd=256,
   zamba2's shared block (32 / 32 heads, hd=112), qwen3 (40 / 8, hd=128) and
   seamless' encoder (16 / 16 heads, hd=64, bf16, without the causal mask);
   ``ssd_scan`` at the serving shape (B=4, S=1024, H=64, P=64, N=128,
   L=64, bf16 x), at a ragged S, at S < L in f32 and in bf16, and at
   zamba2's shape (H=112, N=64) — each within the tolerance stated at
   ``LM_KERNEL_TOL``;
4. main path — ``repro_torch.launch.fed_train.run_federated`` with FedCM at
   the CLI defaults (N=100, cohort 10 Bernoulli → capacity 25, K=10, B=50,
   MLP 32-128-128-10) for 20 rounds, eval every 5, uncompressed, then with
   ``--uplink-compress int8``, then ``topk``, then with drops 0.1 + NaN
   corruption 0.1 + quarantine; each run with the launch counts set to 0
   just before and read just after.  Then, for each of these paths, the
   mean seconds per round of 20 further rounds of an engine, whose
   metrics are checked (wire bytes, fault counters); and the device time
   of one uncompressed round with the host's launch gaps removed (the
   device's busy share).  ``--profile`` (not part of the default run)
   adds device time by kernel over 5 rounds;
4b. the other nine algorithms — ``run_federated`` for fedprox, fedavgm,
   fedacg, fedadam, fedadagrad, fedyogi, mimelite, scaffold and feddyn at
   the CLI defaults (``ALGO_SETTINGS`` for the adaptive three) for 20
   rounds, then scaffold and mimelite under ``--uplink-compress int8``;
   each run with the launch counts set to 0 just before and read just
   after (``fed_direction`` K a round; one fold launch a round per fold
   row: ``FOLDS_PER_ROUND``), a finite loss, its final test accuracy and
   the steady seconds per round of 20 further rounds;
4c. the async ring — ``run_federated`` with ``--pipeline-depth`` /
   ``--staleness`` at γ = 0.9 (``ASYNC_RUNS``: fedcm at D=2 S=1 and D=4
   S=2, scaffold under int8 and mimelite at D=2 S=1) for 20 rounds, each
   with the launch counts set to 0 just before and read just after (K
   ``fed_direction`` a round; ``FOLDS_PER_ROUND`` fold launches a round,
   drain included), a finite loss and the final accuracy;
   then 20 further rounds of an engine (``folded`` D − 1 zeros, then ones)
   and their steady seconds per round, measured in turns with the same
   spec's sync loop before and after;
4d. the host store at fleet scale — N = ``FLEET_N`` = 1,000,000 clients,
   scaffold, zipf availability, dropout 0.1, store failures 0.05,
   ``StreamingClientData``: ``run_federated`` sync and on the ring (D=2,
   S=1) with their launch counts, then an engine's 20 rounds (touched rows
   ≤ 20 × capacity, the store's bytes, ``n_retries`` > 0) and 20 more
   (steady s/round), the device's peak memory under 1 GB throughout (a
   resident (N, P) f32 plane would be 88.1 GB); then, on device-resident
   data (N = 100), bit for bit on the card: store ≡ resident for scaffold
   and feddyn, sync and async, and for scaffold under int8 and top-k (the
   residual store ≡ the resident residual plane), and the ring at D = 1,
   S = 0 ≡ the sync loop for scaffold under int8;
4e. checkpoint and fleet — (a) kill and resume: fedcm with drops 0.1,
   scaffold under int8 and scaffold on the host store at N = ``FLEET_N``
   (``KILL_CASES``), each as ``python -m repro_torch.launch.fed_train
   --rounds 20 --eval-every 5 --ckpt-every 10`` subprocesses (the three
   cases in parallel): ``--die-after 10`` must exit with code 75, then
   ``--resume`` runs to round 20 with its launch counts printed and held
   to the prediction; its round-20 snapshot must equal the straight
   in-process ``run_federated`` run's plane for plane and byte for byte;
   the snapshot's bytes and its ``load_fed_run`` / ``save_fed_run`` ms on
   the card (the re-saved file byte-equal); (b) the fleet loop:
   ``run_federated(..., ckpt_every=5, serve=True)`` for 20 rounds against
   ``serve=False``: versions 1-5 published, a hot-swap, served version 5,
   the in-run health probe 200, ``fleet.check`` clean, the round-20
   snapshots bitwise equal; then the steady ms a round of an engine with
   and without a serving thread, in turns (plain, serve, serve, plain);
   (c) llama3.2-1b at its published widths cut to 2 layers published as
   version 1, ``serve.run --ckpt DIR --follow --sessions 3 --batch 4
   --prompt-len 1024 --gen 8`` with version 2 (× 0.5) published from
   another thread after session 0: a swap, served version 2, 2
   ``flash_attention`` launches a prefill, the last session's tokens equal
   to a fresh run on ``DIR/step_2.msgpack``; payload bytes, publish and
   load ms.  Its files live in ``build/smoke_checkpoint`` (removed after);
4f. cohort sharding — (a) the fold on column shards: at both planes and
   for n in ``SHARD_WORLDS`` (2, 4), a round's uplink split exactly as
   ``scatter_fold`` lays it out (``columns_send`` blocks as the
   ``all_to_all`` delivers them, the cohort padded to C_pad with zero
   weights, x and m as ``plane_chunk`` views at misaligned offsets), in one
   process: ``server_update`` (f32) and ``dequant_update`` (int8) on each
   ``(C_pad, ceil(P/n))`` block, the joined outputs bitwise the unsharded
   launch, each shard's time beside the whole launch's and the shard's
   bound; (b) whole sharded rounds: ``SHARD_RUNS`` (fedcm, scaffold int8,
   mimelite, fedcm with drops and NaN corruption, the fedcm ring at D=2
   S=1, and phase 4g's ``_test_mixed``, an affine direction with a
   ``server_fn``, registered at runtime in every rank), ``SHARD_ROUNDS``
   rounds each at the CLI defaults, on worlds of 2
   and 4 ranks that share cuda:0 over gloo (``repro_torch.launch.mesh``;
   collectives staged through the host, so their ms/round is not a
   multi-card time), after a warm-up run: each rank's launch counts (K
   ``fed_direction`` a round, ``FOLDS_PER_ROUND`` folds), every rank
   bitwise rank 0, and rank 0 against the unsharded run on the card,
   bitwise or within ``PARITY_RTOL`` / ``PARITY_ATOL`` (the largest
   difference printed); (c) the same over NCCL, one rank a card, on 2 and
   ``min(4, device_count)`` cards when there are two or more, else the
   line ``nccl: not run (1 card visible)``; (d) the fleet loop of a sharded
   run: ``run_federated`` with ``cohort_shard`` 2 on 2 gloo ranks sharing
   cuda:0, 10 rounds, a snapshot every 2, without and with ``serve`` (rank
   0 the publisher and the serving thread): the round-10 snapshots bitwise
   and byte-equal, versions 1-6 published, the served version the last
   one, health 200, ``fleet.check`` clean.  ``--nccl`` (not part of the
   default run) runs phases 1–2, then (c) alone, beside the unsharded runs
   it is compared with, then the model group on four cards over NCCL (the
   ms of one ``all_reduce`` of a decode step's and a prefill's activation,
   then ``MP_FULL``: ``serve.run`` of chameleon-34b whole, dbrx-132b at 16 of
   40 layers, zamba2-7b whole and seamless-m4t-large-v2 whole,
   ``SERVE_ARGS``, one rank a card: tokens the same on every rank and
   finite, one flash launch an attention layer and one SSD launch a mamba
   layer a prefill on each rank (seamless: one session, one flash launch an
   encoder layer), prefill and decode ms a session, each rank's peak device
   memory), on a machine with four cards;
4g. the public API — (a) three specs registered at runtime
   (``user_specs``: the reference's affine ``_test_damped``; ``_test_escape``
   with a normalized-gradient ``direction_fn`` and an averaging
   ``server_fn``; ``_test_mixed``, an affine direction with that
   ``server_fn``), each through ``run_federated`` at the CLI defaults for
   20 rounds with the launch counts set to 0 just before and read just
   after (``USER_SPEC_LAUNCHES``: no ``fed_direction`` for a
   ``direction_fn``, one mean-only ``server_update`` a round for a
   ``server_fn``), a finite loss and its accuracy, card vs CPU over 3
   injected rounds within ``PARITY_RTOL`` / ``PARITY_ATOL`` and the ring at
   D = 1, S = 0 bitwise the sync loop on the card; then unregistered;
   (b) FedCM over ``cnn_classifier`` (GroupNorm, P = 22,058) on
   ``make_synthetic_images`` at its defaults (10 classes, 8 × 8 × 3, 20,000 /
   4,000), Dirichlet 0.6, N 100, Bernoulli 10 % (capacity 25), K 10, B 50,
   20 rounds: 200 ``fed_direction`` and 20 ``server_update`` launches, a
   finite loss whose last round is below its first, the test accuracy
   beside the partition's ``heterogeneity_score``, the steady ms a round of
   20 more rounds, card vs CPU over 3 injected rounds; (c)
   ``fed_direction``'s kernel at FedCM's coefficients against the blend
   oracle ``fedcm_step_ref`` (``BLEND_SIZES`` in f32 and bf16,
   ``BLEND_EDGES``, bf16 x with f32 g and Δ bit for bit, the main plane);
   (d) the four ``examples/torch`` scripts as subprocesses on the card, all
   at once (``EXAMPLES``: quickstart and fed_comparison at their defaults,
   serve_model with mamba2-1.3b and with gemma3-12b --gen 48, lm_pretrain
   --tiny), each exiting 0, their last lines printed;
5. card vs CPU — three rounds from one converted state with the same
   injected ids, masks and minibatch indices on ``cuda`` and on ``cpu``;
   then three rounds under int8 + faults, each started on both devices
   from the card's state, with the hash draws (the same bits on both) and
   the floor flips of the int8 rounding counted;
5b. card vs CPU, the other nine algorithms — three rounds of each from one
   converted state, with the same ids, masks, minibatch indices and (for
   mimelite) full batches on both devices: params, momentum, and where the
   spec has them the (N, P) client states and the second moment, within
   ``PARITY_RTOL`` / ``PARITY_ATOL``;
5c. card vs CPU under the ring — six launches at D=2, S=1, γ = 0.9 of
   fedcm, scaffold, fedadam and mimelite from one converted state
   (nonzero momentum)
   with the same injected draws on both devices, through the loop
   ``run_rounds_async`` runs (``run_rounds_async_on``): every state plane
   within ``PARITY_RTOL`` / ``PARITY_ATOL`` after the drain;
6. serving — ``repro_torch.launch.serve`` (the CLI's ``run``) at full width
   for the ten archs of ``SERVE_ARCHS``, ``--full --batch 4 --prompt-len
   1024 --gen 32 --sessions 2``, chameleon, maverick and dbrx cut in depth
   to fit one card (the cut config passed to ``run``); seamless-m4t serves
   one session, as the reference's encoder-decoder does (1024 source frames
   encoded through 24 flash launches, 32 greedy decode steps); with the launch
   counts set to 0 just before each and read just after: ``flash_attention``
   / ``ssd_scan`` launches per prefill as the table says, none of the
   federated kernels; tokens in range, finite logits, the run's peak device
   memory; prefill and decode ms and tok/s of each session; then one
   decode step of llama and mamba2 at that shape: its ms, and the device
   operations it runs with their summed device time (torch.profiler);
6b. the model group on one card — ``MP_CASES`` (chameleon-34b at its
   published widths cut to 2 layers, mamba2-1.3b at 2 layers, zamba2-7b as
   one mamba layer and the shared block, seamless-m4t-large-v2 at 2 + 2
   layers, all with bf16 activations; dbrx at 1 layer, maverick at one
   period with 16 experts and zamba2's whole period plus a tail layer, f32)
   on 2 and 4 gloo ranks that share cuda:0, the two worlds at once
   (``repro_torch.launch.mesh``; each rank draws its share of the weights
   with ``init_params_sharded``), against the unsharded model on the card
   from the same seed: one session of B = 2 × 128 prompt tokens (seamless:
   128 seeded source frames encoded) and 4 teacher-forced decode steps;
   every rank's logits byte for byte rank 0's, rank 0's logits (seamless:
   its encoder output in place of the prefill's) and every rank's cache
   (its heads of the unsharded cache: kv heads of the self and cross K/V,
   SSD heads of the SSM state, those heads' x channels and B's and C's of
   the conv state) within ``LM_REL_L2`` (bf16) or ``F32_REL_L2`` (f32), no
   MoE route flipped, ``flash_attention`` launched once an attention layer
   (seamless: an encoder layer) and ``ssd_scan`` once a mamba layer in each
   rank's prefill (the counts set to 0 in the rank just before, read just after;
   a mamba case with no SSD launch fails), each rank's collective counts
   printed; then the kernels against their plain versions at the rank-local
   head counts, B 4 × 1024, bf16: ``flash_attention`` at the four-card runs'
   (``MP_FLASH``: 16 / 2, 32 / 4, 12 / 2 heads, hd 128), zamba2's shared
   block's 8 / 8 and 16 / 16 (hd 112) and seamless' encoder's 4 / 4 and 8 /
   8 (hd 64, not causal), each beside SDPA; ``ssd_scan`` (``MP_SSD``, P 64,
   chunk 64) at mamba2's 16 and 32 heads (N 128) and zamba2's 28 and 56 (N
   64);
7. card vs CPU, serving — each arch at full width cut to one period
   (``CARD_VS_CPU``), B=2, prompt 128, the same f32 weights on both
   devices: prefill logits and cache, then 4 teacher-forced decode steps,
   each within ``LM_REL_L2``; with f32 activations (the MoE archs,
   zamba2's whole period) within ``F32_REL_L2``, the MoE archs with no
   (token, choice) route differing between the devices; then seamless-m4t at
   2 + 2 layers (``ENCDEC_VS_CPU``, bf16, 128 source frames): the encoder
   output, the cross-attention K/V, 4 teacher-forced decode steps' logits
   and the self-attention cache, each within ``LM_REL_L2``;
8. training — (a) each arch (``TRAIN_VS_CPU``: one period at the published
   widths, the vocabulary cut to ``TRAIN_VOCAB``, in f32) two
   ``launch/steps.py`` train steps on the CPU and on the card from the same
   weights and batch: losses, grad norms, every updated param leaf and both
   AdamW moments within ``F32_REL_L2`` (a leaf that starts at 0 within
   ``UPDATE_REL_L2``), no kernel launched; (b) ``launch/train.run``
   at full width (``TRAIN_FULL``: llama3.2-1b at batch 8, seamless-m4t at
   batch 4, 512 tokens a row, 30 steps, warmup 5): a finite loss that falls,
   ms/step and tok/s after the first ``TRAIN_WARM`` steps, the peak device
   memory and the share of the bf16 peak that the step's matmul FLOPs
   (6 · params · tokens, part by part, the embedding gather left out) over
   its time reach, no kernel launched; (c) FedCM over an LM, card vs CPU
   (``FED_LM_VS_CPU``: llama3.2-1b at its published widths cut to one
   layer, vocabulary ``TRAIN_VOCAB``, f32; N 4, a fixed cohort of 2, K 2,
   B 2 × 32, 3 rounds of ``FederatedEngine.round_step`` over
   ``cohort_loss_fn``) from one converted state with the same ids and
   minibatch indices: params within ``PARITY_RTOL`` / ``PARITY_ATOL``,
   momentum and each round's loss within ``F32_REL_L2``, 6
   ``fed_direction`` and 3 ``server_update`` launches on the card; (d)
   ``launch/federated_llm.run`` over llama3.2-1b at its published config
   (``FED_LM_FULL``; f32 params, P = 1,235,814,400), N 4, cohort 2, K 2, B 4
   × 64, 3 rounds: 6 / 3 launches, finite losses, the last round's below
   the first's, ms a round and the peak device memory; an out-of-memory
   error fails it (nothing is retried smaller).  ``--profile`` (not part
   of the default run) then profiles one local step of (d) with the
   engine's gradient route and with the whole-plane one
   (``fed_lm_step_profile``); (e)–(f) a model group of 2 gloo ranks
   sharing cuda:0 (``model_group_training_one_card``), its world run at
   once with (i)–(j)'s (``both_group_worlds_one_card``); (f) also runs each
   of ``GROUP_FED_VARIANTS`` (the flat round, faults with noise and
   quarantine, ``_test_escape``, ``_test_mixed``, the tree path with and
   without faults) on the engine's own draws against the same rounds
   unsharded on the card: counters equal, params within ``PARITY_RTOL`` /
   ``PARITY_ATOL``, momentum and losses within ``F32_REL_L2``, each
   variant's launches, ms of each round; (i) training on a
   grid: 4 gloo ranks sharing cuda:0 as a 2 x 2 and a 4 x 1 grid (FSDP
   over data, ``launch.mesh.make_grid``), llama3.2-1b and mamba2-1.3b at
   one period of their published widths, vocabulary ``TRAIN_VOCAB``, f32,
   B 4 x 32, two steps: each rank's share and moments within
   ``F32_REL_L2`` of the unsharded share, the replicated parts bitwise
   along each row and down each column, one loss and grad norm, no kernel
   launched; mamba2's 2 x 2 snapshot after step 1 byte for byte the file
   joined here from the shares, its 1 x 2 resume's step 2 within
   ``F32_REL_L2`` of the straight step 2; (j) FedCM on the 2 x 2 grid (the
   cohort over data, each client over model), phase 8 (c)'s shape and
   draws, against the unsharded card round, 6 ``fed_direction`` and 3
   ``server_update`` launches on each rank; 6c ``serve --ckpt --follow``
   on the grid's first row (a model group of 2), llama3.2-1b at its
   published widths cut to one layer, vocabulary ``TRAIN_VOCAB``: version
   2 published after decode step 3, both ranks swap at the unsharded
   server's step, with its tokens, one flash launch a rank; 6d serving on
   the same world's 2 x 2 and 4 x 1 grids (``GRID_SERVE``: zamba2-7b as one
   mamba layer and the shared block, starcoder2-7b at 2 layers with its
   window cut to 4, dbrx-132b at 1 layer with 4 experts of a quarter
   width; vocabulary ``TRAIN_VOCAB``, bf16; ``GRID_SERVE_RUNS``): B 1
   against a 16-deep cache the data ranks split into slabs (the prompt
   across two, decode across a boundary, starcoder2's last step with one
   valid slab), and B 4 split over the data rows in both ``serve_params``
   layouts, each rank's share taken from the whole draw, 6 / 2
   teacher-forced decode steps, against the unsharded model on the card on
   the rows the rank serves (a MoE routes each data row's block at its own
   capacity): every step's logits and every cache leaf (its heads, then
   its slab) within ``LM_REL_L2``, logits byte for byte along each row (the
   world where the sequence splits), the token written on exactly the
   data rank whose slab holds it, three data-group ``all_reduce``s an
   attention application a decode step where the sequence splits and none
   where the batch does, a prefill's flash / SSD launches on each rank
   (``--grid-only`` runs (i), (j), 6c and 6d alone, then, on 4 gloo ranks
   sharing cuda:0, the witness of (m)'s gate, ``long_context_witness``:
   zamba2-7b at published widths cut to 7 layers on (m)'s layouts, with
   f32 activations within ``F32_REL_L2`` of the 1 x 4 group and in bf16
   within ``LONG_REL_L2`` of it, its decode combining slabs that all hold
   data; and a rehearsal of (n), cut to fit).  ``--nccl`` on four
   cards: phase 4f (c), 6b's four-card serving (``MP_FULL``), then (m)
   ``serve.run`` of zamba2-7b whole at ``--shape long_500k`` (B 1, a
   524,288-deep cache, a 32,768-token prompt, 32 tokens, 2 sessions) on 1
   x 4, 4 x 1 (``--serve-params replicated``) and 2 x 2 (``fsdp``), the
   grids fed the 1 x 4 group's tokens and their logits within
   ``LONG_REL_L2`` of its at every step, and (n) dbrx-132b at MP_FULL's 16
   of 40 layers on 2 x 2 in the serve layout (expert banks FSDP over
   data) fed MP_FULL's tokens, its relative L2 reported; each with prefill
   and decode ms, peak and cache GB a rank (under ``CARD_BYTES``), flash /
   SSD launches and data-group collectives a rank; then (g) / (h) on 4-way
   model groups ((h) also with faults and on the tree path,
   ``GROUP_FED_FULL_VARIANTS``: ms a round, peak GB and launches a rank),
   (k) starcoder2-7b trained whole on a 2 x 2 grid of cards
   (FSDP over data) and (l) llama3.2-1b federated at a cohort of 8 on a 2
   x 2 grid (``--groups-only``: (g)-(l) alone);
9. summary — first the dry-run's witness (``dryrun_witness``): each
   entry's kernel launches and each rank's collective census equal to what
   the card's run counted (``ParallelContext.counts``), exactly, and the
   card's peak (``max_memory_allocated`` less the phase's base) inside the
   band ``DRY_PEAK_*`` around the dry-run's (its MemTracker peak plus the
   cuBLAS workspaces its GEMMs take), the ratio
   printed on a ``dry-run witness:`` line each (``--nccl`` ends with the
   same for its entries; ``--nccl --witness-only`` runs 6b's ``DRY_MP``,
   8 (h) and the witness alone); then the ``nvidia-smi`` line, one JSON
   line ``{"kernels": [...]}``
   (``flash_attention`` / ``ssd_scan`` launches summed over phase 6's
   serving runs, the federated kernels' those of the main path; beside
   flash's and the SSD scan's, ``launches_by_path``: phase 6's count,
   each rank's in phase 6b's worlds, 6c's ranks' and 6d's (summed over a
   grid's cases); for ``fed_direction`` and
   ``server_update``, ``launches_by_path``
   — the main path, phase 4g's runs (each user spec, the CNN), phase 8
   (c)'s card run and 8 (d), each its own count — and ``full_plane``, their times and bound at the federated LM's cohort
   plane; every launch count in the line is one the card counted) and,
   last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MAIN_C, MAIN_P = 25, 22026
BIG_C, BIG_P = 25, 11_173_962
# phase 3: the full-width federated LM's cohort plane (phase 8 (d)): a cohort
# of 2 over llama3.2-1b's 1,235,814,400 f32 params (its 33 RMSNorm scales
# included), 9.9 GB a plane
FULL_C, FULL_P = 2, 1_235_814_400
ROUNDS, EVAL_EVERY, K = 20, 5, 10
PARITY_RTOL, PARITY_ATOL = 2e-5, 1e-5  # tests/_torch_parity.py (three rounds)
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# flash_attention and ssd_scan vs their plain versions, |Δ| ≤ rtol·|plain| +
# atol_rel·max|plain|, by output dtype.  Both sum in f32 in different orders (the kernel's online softmax /
# register or tensor-core tiles vs the plain version's full-matrix products
# and torch.cumsum), so f32 outputs differ by ~1e-7 of the largest value; a
# bf16 output may land one ulp (≤ 2^-7 relative) apart when the f32 values
# straddle a rounding boundary.  The bf16 routes' f32 operands enter the
# tensor cores as two bf16 pieces to stay within these numbers
# (tests/test_torch_kernel_precision.py, which reads this table).
LM_KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-5)}
# Card vs CPU serving (bf16 activations): each bf16 rounding is ≤ 2^-9
# relative and a 2-layer forward chains a few dozen of them, with the card's
# GEMMs summing in another order than the CPU's: relative L2 error ≤ 2e-2
# (~10 half-ulps) for the logits and every cache leaf.
LM_REL_L2 = 2e-2
# Card vs CPU with f32 activations (phase 7): logits and caches agree to the
# f32 GEMMs' summation order.  The MoE archs run so, because in bf16 a
# one-ulp difference between the devices can flip a top-k route and change
# that token's output wholesale, which is not a fault; in f32 no route may
# differ.  So does zamba2's whole period (7 layers): in bf16 its prefill on
# the CPU sits past LM_REL_L2 from the f32 model's (2.4e-2 relative L2 in its
# largest cache leaf; phase 7 prints this drift for every row), so two bf16
# runs that round differently cannot be held to LM_REL_L2 there.
F32_REL_L2 = 1e-4
SERVE_ARGS = ["--full", "--batch", "4", "--prompt-len", "1024", "--gen", "32", "--sessions", "2"]
# phase 6: (arch, cut of the published config, kernel launches a prefill).
# Depth is cut only where one 80 GB card forces it; maverick also stores its
# params in bf16 (the reference's param_dtype field; its routers stay f32).
SERVE_ARCHS = (
    ("llama3.2-1b", {}, {"flash_attention": 16}),
    ("mamba2-1.3b", {}, {"ssd_scan": 48}),
    ("qwen3-14b", {}, {"flash_attention": 40}),
    ("gemma3-12b", {}, {"flash_attention": 48}),
    ("starcoder2-7b", {}, {"flash_attention": 32}),
    ("zamba2-7b", {}, {"flash_attention": 13, "ssd_scan": 68}),
    ("chameleon-34b", {"n_layers": 16}, {"flash_attention": 16}),
    ("llama4-maverick-400b-a17b", {"n_layers": 2, "param_dtype": "bfloat16"},
     {"flash_attention": 2}),
    ("dbrx-132b", {"n_layers": 4}, {"flash_attention": 4}),
    ("seamless-m4t-large-v2", {}, {"flash_attention": 24}),
)
# phase 7: each arch at its published widths cut to one period, the same f32
# weights on both devices, bf16 activations within LM_REL_L2 or f32 ones
# within F32_REL_L2: zamba2 in bf16 as one mamba layer and the shared block
# (attn_every 2, as the reference's ``reduced``), and in f32 as its whole
# period plus one tail layer; the MoE archs in f32, maverick's experts cut
# to 16 for the host's memory
CARD_VS_CPU = (
    ("llama3.2-1b", {"n_layers": 2}),
    ("mamba2-1.3b", {"n_layers": 2}),
    ("qwen3-14b", {"n_layers": 2}),
    ("starcoder2-7b", {"n_layers": 2}),
    ("chameleon-34b", {"n_layers": 2}),
    ("gemma3-12b", {"n_layers": 6}),
    ("zamba2-7b", {"n_layers": 2, "attn_every": 2}),
    ("zamba2-7b", {"n_layers": 7, "dtype": "float32"}),
    ("dbrx-132b", {"n_layers": 1, "dtype": "float32"}),
    ("llama4-maverick-400b-a17b", {"n_layers": 2, "n_experts": 16, "dtype": "float32"}),
)
# phase 7: the encoder-decoder at its published widths cut to 2 + 2 layers
ENCDEC_VS_CPU = ("seamless-m4t-large-v2", {"n_layers": 2, "n_encoder_layers": 2})
# phase 6b: the model group on one card — each case at its published widths
# cut as stated, served on MP_WORLDS gloo ranks sharing cuda:0 (the worlds
# run at once) against the unsharded model on the same card: one session of
# MP_B × MP_PROMPT prompt tokens (seamless: as many source frames) and
# MP_STEPS teacher-forced decode steps; chameleon, mamba2, zamba2's mamba
# layer and shared block, and seamless at 2 + 2 layers with bf16
# activations; the MoE archs in f32 (a one-ulp difference in bf16 may flip
# a route, as phase 7 says), maverick's experts cut to 16 as phase 7 cuts
# them, and zamba2's whole period plus a tail layer in f32 (phase 7's two
# zamba2 forms).  Then the kernels at the rank-local head counts: flash
# (B=4, S=1024, bf16) at the four-card runs' chameleon 64 / 8 heads on 4
# and on 2 ranks and dbrx's 48 / 8 on 4 (hd 128, causal), zamba2's shared
# block's 32 / 32 on 4 and 2 (hd 112, causal) and seamless' encoder's 16 /
# 16 on 4 and 2 (hd 64, not causal); the SSD scan (B=4, S=1024, P=64,
# chunk 64, bf16) at mamba2's 64 heads on 4 and 2 ranks (N 128) and
# zamba2's 112 (N 64).
MP_WORLDS = (2, 4)
MP_CASES = (("chameleon-34b", {"n_layers": 2}),
            ("dbrx-132b", {"n_layers": 1, "dtype": "float32"}),
            ("llama4-maverick-400b-a17b", {"n_layers": 2, "n_experts": 16, "dtype": "float32"}),
            ("mamba2-1.3b", {"n_layers": 2}),
            ("zamba2-7b", {"n_layers": 2, "attn_every": 2}),
            ("zamba2-7b", {"n_layers": 7, "dtype": "float32"}),
            ("seamless-m4t-large-v2", {"n_layers": 2, "n_encoder_layers": 2}))
MP_B, MP_PROMPT, MP_STEPS, MP_SEED = 2, 128, 4, 7
# (H, Hkv, hd, causal) a rank
MP_FLASH = ((64 // 4, 8 // 4, 128, True), (64 // 2, 8 // 2, 128, True),
            (48 // 4, 8 // 4, 128, True), (32 // 4, 32 // 4, 112, True),
            (32 // 2, 32 // 2, 112, True), (16 // 4, 16 // 4, 64, False),
            (16 // 2, 16 // 2, 64, False))
# (H, N) a rank
MP_SSD = ((64 // 4, 128), (64 // 2, 128), (112 // 4, 64), (112 // 2, 64))
MP_TIMEOUT_S, MP_DEADLINE_S = 300.0, 600.0
# --nccl: ``serve.run`` on four cards, one rank a card (SERVE_ARGS): chameleon
# whole, dbrx at 16 of its 40 layers (a rank's f32 share is then 53.4 GB),
# zamba2 whole (81 layers, 5.8 GB a rank) and seamless whole (24 + 24 layers,
# one session, 1.6 GB a rank)
MP_FULL = (("chameleon-34b", {}), ("dbrx-132b", {"n_layers": 16}), ("zamba2-7b", {}),
           ("seamless-m4t-large-v2", {}))
MP_FULL_RANKS = 4
# phase 8 (a): two train steps of each arch in f32 on the card and on the CPU
# from the same weights and batch (TRAIN_B × TRAIN_S tokens), at the
# published widths of every layer.  The CPU holds the params, gradients, both
# AdamW moments and the new ones at once (~7 × the f32 params) and streams
# each through AdamW's ~30 elementwise passes, ~10 s a GB for two steps; so
# each arch runs one period (gemma3 one local and one global layer, zamba2 a
# mamba layer and the shared block, seamless 1 + 1 layers), the MoE archs
# with the fewest experts their top-k allows, and the vocabulary cut to
# TRAIN_VOCAB
TRAIN_VOCAB = 4096
TRAIN_VS_CPU = (
    ("llama3.2-1b", {"n_layers": 1}),
    ("mamba2-1.3b", {"n_layers": 1}),
    ("qwen3-14b", {"n_layers": 1}),
    ("starcoder2-7b", {"n_layers": 1}),
    ("chameleon-34b", {"n_layers": 1}),
    ("gemma3-12b", {"n_layers": 2, "local_global_pattern": (1, 1)}),
    ("zamba2-7b", {"n_layers": 2, "attn_every": 2}),
    ("dbrx-132b", {"n_layers": 1, "n_experts": 4}),
    ("llama4-maverick-400b-a17b", {"n_layers": 2, "n_experts": 2}),
    ("seamless-m4t-large-v2", {"n_layers": 1, "n_encoder_layers": 1}),
)
TRAIN_B, TRAIN_S, TRAIN_LR = 2, 32, 1e-5
# A train step's update (new − old params) goes through AdamW's
# g / (|g| + ε), ε = 1e-8: an element whose gradient lies within its rounding
# noise of 0 (|g| ~ 1e-9) moves by up to lr·|Δg|/ε and may flip sign, so a
# few elements of a leaf differ by a sizeable part of lr.  The CPU tests
# (tests/_torch_parity.py takes this definition) measured per-leaf relative
# L2 ≤ 8.7e-4 of the update over 3 steps × 8 cases (mamba2's 1-d dt_bias and
# A_log).  Here a leaf that starts at 0 (the norms' scale − 1, the conv bias)
# is, after two steps, that update alone, so it is held to this bound; every
# other updated leaf and both moments (linear in the gradients) to F32_REL_L2
UPDATE_REL_L2 = 2e-3
# phase 8 (b): ``launch/train.run`` at full width; the batch is the only cut
TRAIN_FULL = (("llama3.2-1b", 8), ("seamless-m4t-large-v2", 4))
TRAIN_ARGS = ["--full", "--seq", "512", "--steps", "30", "--warmup", "5", "--log-every", "5"]
TRAIN_WARM = 5  # steps left out of ms/step and tok/s
# the algorithms beyond FedCM and FedAvg (phases 4b and 5b)
# phase 8 (c): FedCM over llama3.2-1b at its published widths cut to one
# layer, the vocabulary cut to TRAIN_VOCAB, f32 activations, on the card and
# on the CPU from one converted state with the same ids, masks and minibatch
# indices; (d) ``launch/federated_llm.run`` at the published config, nothing
# cut (a cohort of 2 is what one card holds)
FED_LM_VS_CPU = ("llama3.2-1b", {"n_layers": 1, "vocab_size": TRAIN_VOCAB, "dtype": "float32"})
FED_LM_FULL = "llama3.2-1b"
FED_LM_RUN = {"n_clients": 4, "cohort": 2, "local_steps": 2, "rounds": 3}
FED_LM_VS_CPU_BATCH, FED_LM_FULL_BATCH = (2, 32), (4, 64)  # (B, S) a client a step
# phase 8 (e): training on a model group on one card: GROUP_RANKS gloo ranks
# sharing cuda:0, each arch of GROUP_TRAIN at one period of its published
# widths, the vocabulary cut to TRAIN_VOCAB, f32, B TRAIN_B x TRAIN_S (phase 8
# (a)'s cut; dbrx with the 4 experts its top-4 allows); then remat "dots"
# against "none" on llama3.2-1b at REMAT_CASE's cut, B REMAT_B x REMAT_S: four
# layers, so that what a period keeps adds up and the three policies' peaks
# part.  (f): FedCM on the same ranks, phase 8 (c)'s shape and draws.
GROUP_RANKS = 2
GROUP_SEED = 9
# (f), after the injected rounds: GROUP_FED_VARIANT_ROUNDS rounds of each variant
# of its FedCM config on the engine's own draws (the generator seeded GROUP_SEED
# on every rank; the fault layer's hash draws, each rank drawing its own
# columns), against the same rounds unsharded on the card, each round timed
# (the first takes the variant's warm-up): the flat round itself, the fault layer
# (noise + quarantine by norm; at a cohort of 2 the median is the two rows'
# mean, so a multiple of 1.5 catches one row made ~10x its norm), the escape
# hatches (phase 4g's specs, whole planes gathered over the group) and the
# per-leaf tree path, with and without the faults; each with its
# (fed_direction a local step, server_update a round) launches
GROUP_FAULT = dict(drop_rate=0.1, corrupt_rate=0.5, corrupt_mode="noise", noise_scale=10.0,
                   quarantine=True, quarantine_norm_mult=1.5)
GROUP_FED_VARIANTS = {"flat": ({}, (1, 1)),
                      "faults": ({"fault": GROUP_FAULT}, (1, 1)),
                      "escape": ({"algo": "_test_escape"}, (0, 1)),
                      "mixed": ({"algo": "_test_mixed"}, (1, 1)),
                      "tree": ({"use_flat_plane": False}, (0, 0)),
                      "tree_faults": ({"use_flat_plane": False, "fault": GROUP_FAULT}, (0, 0))}
GROUP_FED_VARIANT_ROUNDS = 2
GROUP_TRAIN = (("llama3.2-1b", {"n_layers": 1}), ("dbrx-132b", {"n_layers": 1, "n_experts": 4}),
               ("mamba2-1.3b", {"n_layers": 1}))
REMAT_CASE = ("llama3.2-1b", {"n_layers": 4, "vocab_size": TRAIN_VOCAB, "dtype": "float32"})
REMAT_B, REMAT_S = 4, 512
# --nccl (g): ``launch/train.run`` of starcoder2-7b whole on MP_FULL_RANKS
# cards (its f32 params, gradients and AdamW moments, ~115 GB, fit no one
# card); (h) ``launch/federated_llm.run`` of llama3.2-1b as published, each
# client a model group of MP_FULL_RANKS cards, a cohort of 8 (one card held 2)
GROUP_TRAIN_FULL = ("starcoder2-7b", ["--full", "--batch", "8", "--seq", "512", "--remat", "dots",
                                      "--steps", "10", "--warmup", "2", "--log-every", "1"])
GROUP_TRAIN_WARM = 2  # steps left out of ms/step and tok/s
GROUP_FED_RUN = {"n_clients": 16, "cohort": 8, "local_steps": 2, "batch": 4, "seq": 64,
                 "rounds": 3}
# (h) beside the flat round, the same run with the fault layer (noise +
# quarantine by norm: the median of 8 rows stays a clean one's while at most
# 3 are corrupted) and on the per-leaf tree path, each with its
# (fed_direction a local step, server_update a round) launches
GROUP_FED_FULL_VARIANTS = (
    ("faults", {"fault": dict(drop_rate=0.1, corrupt_rate=0.25, corrupt_mode="noise",
                              noise_scale=10.0, quarantine=True, quarantine_norm_mult=3.0)},
     (1, 1)),
    ("tree", {"use_flat_plane": False}, (0, 0)))
# phase 8 (i): training on a grid on one card: GRID_RANKS gloo ranks sharing
# cuda:0, as each grid of GRID_SHAPES (data, model), each arch of GRID_TRAIN
# at one period of its published widths, the vocabulary cut to TRAIN_VOCAB,
# f32, B GRID_B x TRAIN_S; GRID_SNAPSHOT's 2 x 2 run snapshotted at step 1
# and resumed on 1 x 2 (each model row of the grid): mamba2, whose packed
# leaves (``rules.Pieces``) the join must undo, at half llama's bytes.  (j): FedCM on the 2 x
# 2 grid (the cohort over data, each client over model), phase 8 (c)'s shape
# and draws.  6c: ``serve --ckpt --follow`` on the grid's first model row (a
# group of 2), llama3.2-1b at its published widths cut to GRID_SERVE_CUT,
# version 2 published after decode step GRID_PUBLISH_AFTER.
GRID_RANKS = 4
GRID_SHAPES = ((2, 2), (4, 1))
GRID_TRAIN = (("llama3.2-1b", {"n_layers": 1}), ("mamba2-1.3b", {"n_layers": 1}))
GRID_B = 4
GRID_SNAPSHOT = "mamba2-1.3b"
GRID_SERVE_ARGS = ["--arch", "llama3.2-1b", "--full", "--batch", "2", "--prompt-len", "256",
                   "--gen", "8", "--follow"]
GRID_SERVE_CUT = {"n_layers": 1, "vocab_size": TRAIN_VOCAB}
GRID_PUBLISH_AFTER = 3
GRID_SERVE_SEED = 13
# (B, prompt, cache, steps, {grid: serve_params}): B 1 against a cache the
# data ranks split (slabs of 4 on 4 x 1, 8 on 2 x 2): the prompt spans two
# of 4 x 1's slabs, decode (positions 6-11) crosses a slab boundary on both
# grids, and at position 11 starcoder2's window leaves one valid slab; B 4
# split over the data rows, in both layouts on 2 x 2
GRID_SERVE_RUNS = ((1, 6, 16, 6, {(2, 2): ("fsdp",), (4, 1): ("replicated",)}),
                   (4, 6, 8, 2, {(2, 2): ("fsdp", "replicated"), (4, 1): ("replicated",)}))
# the f32 case's: B 1 in the replicated layout alone (no data-group gathers
# of its 3 GB through the host)
GRID_SERVE_F32_RUNS = ((1, 6, 16, 6, {(2, 2): ("replicated",), (4, 1): ("replicated",)}),)
# 6d: serving on the same world's grids, (name, arch, cut, runs): each case
# at its published widths cut in depth, the vocabulary cut to TRAIN_VOCAB,
# bf16 weights and activations unless cut says otherwise; zamba2 as one
# mamba layer and the shared block (its 7 bf16 layers drift past LM_REL_L2
# over a split of the SSD heads: 2.05e-2 of the SSM state), and its 7
# layers in f32, held to F32_REL_L2; starcoder2's window cut to 4 so that
# it empties slabs of a 16-deep cache, dbrx's 4 experts cut to a quarter of
# their hidden width (their data-group gathers go through the host under
# gloo)
GRID_SERVE = (("zamba2-7b", "zamba2-7b", {"n_layers": 2, "attn_every": 2}, GRID_SERVE_RUNS),
              ("zamba2-7b f32", "zamba2-7b",
               {"n_layers": 7, "param_dtype": "float32", "dtype": "float32"},
               GRID_SERVE_F32_RUNS),
              ("starcoder2-7b", "starcoder2-7b", {"n_layers": 2, "sliding_window": 4},
               GRID_SERVE_RUNS),
              ("dbrx-132b", "dbrx-132b", {"n_layers": 1, "n_experts": 4, "d_ff": 2688},
               GRID_SERVE_RUNS))
# --nccl (m): zamba2-7b whole at long_500k's shape (B 1, a 524,288-deep
# cache), a 32,768-token prompt (prefill_32k's length), 32 tokens, 2
# sessions, on each (data, model, serve_params) layout; the 1 x 4 model
# group (heads split over model, no data axis) first, the reference of the
# others
LONG_ARGS = ["--arch", "zamba2-7b", "--full", "--shape", "long_500k", "--prompt-len", "32768",
             "--gen", "32", "--sessions", "2"]
LONG_LAYOUTS = ((1, 4, "fsdp"), (4, 1, "replicated"), (2, 2, "fsdp"))
# (n): dbrx-132b at MP_FULL's 16 of 40 layers, SERVE_ARGS, on 2 x 2 in the
# serve layout (expert banks FSDP over data, the rest replicated over data),
# against MP_FULL's 1 x 4 run
MOE_GRID = (2, 2, "replicated")
CARD_BYTES = 80e9
# (m)'s logits against the 1 x 4 group's: bf16 activations round each
# layout's sums in its own order, and that drift grows with depth.
# --grid-only's witness (``long_context_witness``, NVIDIA H100 80GB HBM3,
# 700.00 W) at 7 layers: with f32 activations 4 x 1 and 2 x 2 are within
# 4.2e-6 / 2.8e-6 of 1 x 4, so the grids compute the group's function; in
# bf16 every layout, 1 x 4 included, is 1.60e-2 from that f32 run, and the
# grids 1.47e-2 / 1.51e-2 from bf16 1 x 4.  That is ~5e-2 at zamba2's 81
# layers if it grows as the square root of depth (6.2e-2 / 6.3e-2 read on
# four cards); LM_REL_L2 holds at one period.  A miss fails the run after
# the later phases have run.
LONG_REL_L2 = 1e-1
# the witness: zamba2-7b at published widths cut to 7 layers (its f32
# weights), B 1, a 1,024-token prompt and 4 tokens, 2 sessions, into a
# 2,048-deep cache: slabs of 512 on 4 x 1 (the prompt fills two, decode
# writes the third, the fourth stays empty) and of 1,024 on 2 x 2 (decode
# writes the second), so the combine sums slabs that all hold data, where
# (m)'s 32,768-token prompt and 32 tokens stay inside slab 0 of 131,072 /
# 262,144
WITNESS_ARGS = ["--arch", "zamba2-7b", "--full", "--batch", "1", "--cache-len", "2048",
                "--prompt-len", "1024", "--gen", "4", "--sessions", "2"]
WITNESS_CUT = {"n_layers": 7, "vocab_size": TRAIN_VOCAB}
DEFERRED: list = []  # failures reported at the end of --nccl, after every phase ran
# --nccl (k): ``launch/train.run`` of starcoder2-7b whole on a 2 x 2 grid of
# cards (FSDP over data), phase (g)'s flags and seed; (l)
# ``launch/federated_llm.run`` of llama3.2-1b as published on a 2 x 2 grid,
# (h)'s run
GRID_FULL = (2, 2)  # (data, model)
# (k) against (g) and (l) against (h), step by step: the same seed, batches
# and draws; the grid sums each gradient in another order (NCCL's
# reduce-scatter over data, half-width all-reduces over model), and bf16
# training lets that grow over the steps.  About four times the largest
# relative gaps of the first four-card run (NVIDIA H100 80GB HBM3, 700.00
# W): losses 7.3e-4 and grad norms 1.01e-2 (k); round losses 3.4e-5 and
# momentum norms 1.3e-5 (l)
GRID_TRAIN_LOSS_REL, GRID_TRAIN_NORM_REL = 3e-3, 4e-2
GRID_STEP1_REL = 1e-3  # step 1's loss, taken before any update
GRID_FED_REL = 1.5e-4
# (k)'s snapshot: starcoder2-7b at its published widths cut to two layers,
# drawn on the 2 x 2 grid of cards and written with ``save_checkpoint_shares``
GRID_SNAPSHOT_FULL = ("starcoder2-7b", {"n_layers": 2})
# phase 4h: the per-leaf tree path.  f32 relative L2 of every plane after
# TREE_ROUNDS rounds, against the card's flat kernel path and the CPU's tree
# path; the mixed bf16/f32 tree card vs CPU at the tests' bf16 bar
TREE_ROUNDS, TREE_TIMED = 3, 10
TREE_VS_FLAT, TREE_VS_CPU, TREE_BF16_VS_CPU = 1e-5, 1e-4, 2e-2
TREE_SPEC = "_tree_normalized"
TREE_TASK = {}  # device -> (params, momentum, FlatSpec, FederatedData) of phase 4h's runs
OTHER_ALGOS = ("fedprox", "fedavgm", "fedacg", "fedadam", "fedadagrad", "fedyogi", "mimelite",
               "scaffold", "feddyn")
# the reference benchmark's per-algorithm settings (benchmarks/common.py: η_g
# 0.03 and α 0.1 for fedadam), also for fedadagrad and fedyogi, which take the
# same absolute-lr preconditioned step; a copy, so nothing of the benchmarks
# is imported
ALGO_SETTINGS = {a: {"eta_g": 0.03, "alpha": 0.1} for a in ("fedadam", "fedadagrad", "fedyogi")}
# (server_update, dequant_update) launches a fold by uplink, sync round and
# ring alike: one per fold row; under int8 every row over a plane that
# arrives compressed is a dequant launch (scaffold's state delta included:
# the fold decodes it once more for the client-state scatter)
FOLDS_PER_ROUND = {"scaffold": {None: (2, 0), "int8": (0, 2)},
                   "mimelite": {None: (2, 0), "int8": (0, 2)}}
# the async ring (phase 4c): (algo, uplink, D, S), each at γ = RING_GAMMA
ASYNC_RUNS = (("fedcm", None, 2, 1), ("fedcm", None, 4, 2), ("scaffold", "int8", 2, 1),
              ("mimelite", None, 2, 1))
RING_GAMMA = 0.9
FLEET_N = 1_000_000  # the host store's population (phase 4d)
PAIR_ROUNDS = 6  # rounds of each bitwise store pair (phase 4d)
# phase 4e: the kill/resume cases (fed_train flags beside the CLI defaults)
# and the launches predicted for each resumed half (10 rounds) as
# (fed_direction, server_update, dequant_update)
KILL_CASES = (
    ("fedcm drops 0.1", ["--fault-drop-rate", "0.1"], (100, 10, 0)),
    ("scaffold int8", ["--algo", "scaffold", "--uplink-compress", "int8"], (100, 0, 20)),
    ("scaffold host store N=1e6", ["--algo", "scaffold", "--population-store", "host",
                                   "--clients", str(FLEET_N)], (100, 20, 0)),
)
KILL_ARGS = ["--rounds", str(ROUNDS), "--eval-every", str(EVAL_EVERY), "--ckpt-every", "10"]
# fed_train's CLI as ``python -m`` runs it, printing the federated kernels'
# launch counts of the process when it exits normally
CLI_WITH_COUNTS = (
    "import json, runpy, sys\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.fed_train', run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    from repro_torch.kernels.fed_direction import kernel as fd\n"
    "    from repro_torch.kernels.server_update import kernel as su\n"
    "    print('LAUNCHES ' + json.dumps([fd.KERNEL.launches, su.KERNEL.launches,\n"
    "                                   su.DEQUANT_KERNEL.launches]), flush=True)\n"
)
# phase 4e (c): llama3.2-1b at its published widths cut to 2 layers
LM_FLEET_ARGS = ["--arch", "llama3.2-1b", "--full", "--batch", "4", "--prompt-len", "1024",
                 "--gen", "8"]
# phase D: the dry-run (``launch/dryrun.py``, ``launch/fed_dryrun.py``) of
# configurations the card phases run, at their cut, batch and length, in a
# CPU subprocess on fake tensors (no card visible to it) beside the card
# phases: phase 6's serving of DRY_SERVE (a session of SERVE_ARGS' shape cut
# to its prefill and one decode step: the card's launches are its 2 sessions'
# prefills, twice the dry-run's), phase 8
# (a)'s train steps of DRY_TRAIN, phase 4's main path (ROUNDS rounds of the
# MLP); under --nccl each rank of 6b's DRY_MP on MP_FULL_RANKS cards and of
# 8 (h).  Phase 9 holds each entry's kernel launches and each rank's
# collective census (ParallelContext.counts) to the card's run exactly, and
# the card's peak (max_memory_allocated less the phase's base, read with no
# cuBLAS workspace held: ``witness_base``) P_c to the dry-run's P_d (its
# MemTracker peak plus the cuBLAS workspaces its GEMMs take on the card)
# within DRY_PEAK_LO·P_d ≤ P_c ≤ DRY_PEAK_HI·P_d + DRY_PEAK_SLACK: the
# caching allocator rounds each block up to 512 bytes (PERF.md §6)
DRY_SERVE = ("llama3.2-1b", "mamba2-1.3b", "qwen3-14b")
DRY_TRAIN = "llama3.2-1b"
DRY_MP = "chameleon-34b"
DRY_PEAK_LO, DRY_PEAK_HI, DRY_PEAK_SLACK = 0.99, 1.05, 2 * 2 ** 20
DRY_JOBS, DRY_JOBS_NCCL = 3, 8  # the subprocess's workers: one card's host has 8 cores, four's 32
DRY_WAIT_S = 600.0  # phase 9 waits this long for the subprocess at most
DRY_CARD: dict = {}  # entry name -> the card's launches, counts and peak, filled by the phases


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------- timing
def graph_ms(torch, fn, reps: int, samples: int = 21) -> float:
    """Median device ms per call: ``reps`` calls captured in a CUDA graph,
    each sample one replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def eager_ms(torch, fn, iters: int = 50) -> float:
    """ms per call when Python launches each call (host cost included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def within(torch, actual, expected) -> bool:
    rtol = 2.0 ** -7 if expected.dtype == torch.bfloat16 else 1e-6
    return bool(torch.allclose(actual.float(), expected.float(), rtol=rtol, atol=1e-6))


# ---------------------------------------------------------------------- phase 2
def _kernel_name(mangled: str) -> str:
    """``attn_mma_kernel<64>`` from its Itanium-mangled name: walks the
    length-prefixed names of ``_ZN...`` to the one that ends in ``_kernel``,
    and adds an int template argument if one follows."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else 0
    while (d := re.match(r"\d+", mangled[pos:])):
        ident = mangled[pos + d.end():pos + d.end() + int(d.group())]
        pos += d.end() + len(ident)
        if ident.endswith("_kernel"):
            arg = re.match(r"ILi(\d+)E", mangled[pos:])
            return f"{ident}<{arg.group(1)}>" if arg else ident
    return mangled


def sass_counts(lib: Path, mnemonics: dict) -> list:
    """``[(kernel, {key: instructions})]`` for every kernel compiled into
    ``lib``, one entry per compiled function (template instantiations of one
    kernel share its name), counting the SASS lines that match each regex of
    ``mnemonics`` in ``cuobjdump -sass`` (names demangled down to the
    kernel's own name and int template arguments)."""
    from repro_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {lib.name} failed: {out.stderr.strip()[:500]}")
    funcs = []
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            funcs.append((_kernel_name(m.group(1)), dict.fromkeys(mnemonics, 0)))
        elif funcs:
            for key, pattern in mnemonics.items():
                if re.search(pattern, line):
                    funcs[-1][1][key] += 1
    return funcs


# ---------------------------------------------------------------------- phase 3
# fed_direction's aux layouts: the first n_aux of (broadcast f32, per-client
# f32, broadcast bf16), and the orders the other specs produce — SCAFFOLD's
# [c_i (C, P), c (P,)] and FedDyn's [λ_i (C, P), x_t (P,)], FedProx's
# [x_t (P,)]; every case has c_x = 0.01 ≠ 0 (FedDyn, FedProx).
FD_LAYOUTS = {"scaffold/feddyn": ("client", "bcast"), "fedprox": ("bcast",)}


def check_fed_direction(torch, fd_kernel, fd_ref, C, P, n_aux, dtype, gen, layout=None):
    dev = "cuda"
    x = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    g = torch.randn((C, P), generator=gen, device=dev).to(dtype)
    make = {"bcast": lambda: torch.randn((P,), generator=gen, device=dev),
            "client": lambda: torch.randn((C, P), generator=gen, device=dev),
            "bcast_bf16": lambda: torch.randn((P,), generator=gen,
                                              device=dev).to(torch.bfloat16)}
    kinds = FD_LAYOUTS[layout] if layout else ("bcast", "client", "bcast_bf16")[:n_aux]
    auxes = [make[k]() for k in kinds]
    n_aux = len(auxes)
    coefs = torch.tensor([0.1, 0.3, 0.01, 0.7, -0.2, 0.05][:3 + n_aux],
                         dtype=torch.float32, device=dev)
    out = fd_kernel.fed_direction_flat(x, g, auxes, coefs)
    ref = fd_ref.fed_direction_ref(x, g, auxes, coefs)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref)
    ok = within(torch, out, ref)
    n = C * P
    nbytes = (x.numel() * x.element_size() + g.numel() * g.element_size()
              + sum(a.numel() * a.element_size() for a in auxes)
              + coefs.numel() * 4 + out.numel() * out.element_size())
    del out, ref  # at the full plane each is 9.9 GB: the timing needs the room
    torch.cuda.empty_cache()
    b_ms, b_by = bound(nbytes, n * (5 + 2 * n_aux))
    reps = 20 if n < 10_000_000 else 5 if n < 1_000_000_000 else 1
    ms = graph_ms(torch, lambda: fd_kernel.fed_direction_flat(x, g, auxes, coefs), reps)
    plain = graph_ms(torch, lambda: fd_ref.fed_direction_ref(x, g, auxes, coefs), reps)
    eager = eager_ms(torch, lambda: fd_kernel.fed_direction_flat(x, g, auxes, coefs),
                     50 if n < 10_000_000 else 5)
    return {"C": C, "P": P, "n_aux": n_aux, "layout": layout or "pool", "aux": list(kinds),
            "x": str(dtype).split(".")[-1], "max_abs_err": err, "ok": ok, "ms": ms,
            "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def shifted(torch, t, offset: int):
    """``t`` as a contiguous view ``offset`` elements into a larger buffer:
    the same values at a data_ptr that is no longer 16-byte aligned."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def fold_inputs(torch, C, P, m_dtype, gen, offset: int = 0, gamma: float = 1.0):
    """wn (the first 2C/5 rows active, at least one), x and m of a fold
    case; with ``offset``, x and m are views 1 element into their buffers;
    ``gamma`` is the staleness discount γ, coefs[3]."""
    dev = "cuda"
    mask = torch.arange(C, device=dev) < max(1, (C * 2) // 5)
    wn = mask.float() / mask.float().sum()
    x = shifted(torch, torch.randn((P,), generator=gen, device=dev), min(offset, 1))
    m = shifted(torch, torch.randn((P,), generator=gen, device=dev).to(m_dtype), min(offset, 1))
    coefs = torch.tensor([0.0, -1.0, 1.0, gamma], dtype=torch.float32, device=dev)
    return wn, x, m, coefs


def check_server_update(torch, su_kernel, su_ref, C, P, write_x, write_m, m_dtype, gen,
                        d_dtype=None, offset: int = 0, gamma: float = 1.0):
    """``offset``: the plane (and x, m) as views ``offset`` elements into
    their buffers, so their data_ptr is misaligned."""
    dev = "cuda"
    d_dtype = d_dtype or torch.float32
    deltas = shifted(torch, (torch.randn((C, P), generator=gen, device=dev) * 1e-2).to(d_dtype),
                     offset)
    wn, x, m, coefs = fold_inputs(torch, C, P, m_dtype, gen, offset, gamma)

    def run():
        return su_kernel.server_update_flat(deltas, wn, x, m, coefs,
                                            write_x=write_x, write_m=write_m)

    out1 = run()
    out2 = run()
    deterministic = all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(out1, out2))
    del out2  # the full plane's plain fold needs the room
    ref = su_ref.server_update_ref(deltas, wn, x, m, coefs, write_x=write_x, write_m=write_m)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for a, b in zip(out1, ref):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            err = max(err, max_err(torch, a, b))
            ok = ok and torch.equal(a, b)  # bitwise: the same f32 operations
    del out1, ref
    torch.cuda.empty_cache()
    nbytes = (deltas.numel() * deltas.element_size() + C * 4 + 16 + P * 4  # deltas, wn, coefs, mean
              + (2 * P * 4 if write_x else 0)
              + (2 * P * m.element_size() if write_m else 0))
    flops = 2 * C * P + P + (2 * P if write_x else 0) + (3 * P if write_m else 0)
    b_ms, b_by = bound(nbytes, flops)
    reps = 20 if C * P < 10_000_000 else 5 if C * P < 1_000_000_000 else 1
    ms = graph_ms(torch, run, reps)
    plain = graph_ms(torch, lambda: su_ref.server_update_ref(
        deltas, wn, x, m, coefs, write_x=write_x, write_m=write_m), reps)
    eager = eager_ms(torch, run, 50 if C * P < 10_000_000 else 5)
    return {"C": C, "P": P, "d": str(d_dtype).split(".")[-1], "offset": offset,
            "gamma": gamma, "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


def check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, write_x, write_m, m_dtype,
                         gen, offset: int = 0, gamma: float = 1.0):
    """``offset``: the plane as a view ``offset`` elements into its buffer
    (3 for int8, so its data_ptr is 3 bytes past an aligned one), x and m
    1 element."""
    dev = "cuda"
    if q_kind == "int8":
        q = torch.randint(-127, 128, (C, P), generator=gen, device=dev, dtype=torch.int8)
        scale = torch.rand((C, 1), generator=gen, device=dev) * 1e-3
    else:
        q = (torch.randn((C, P), generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
        scale = torch.ones((C, 1), device=dev)
    q = shifted(torch, q, offset)
    wn, x, m, coefs = fold_inputs(torch, C, P, m_dtype, gen, offset, gamma)

    def run():
        return su_kernel.dequant_update_flat(q, scale, wn, x, m, coefs,
                                             write_x=write_x, write_m=write_m)

    def plain():
        return su_ref.dequant_server_update_ref(q, scale, wn, x, m, coefs,
                                                write_x=write_x, write_m=write_m)

    out1 = run()
    out2 = run()
    ref = plain()
    torch.cuda.synchronize()
    deterministic = all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(out1, out2))
    err, ok = 0.0, True
    for a, b in zip(out1, ref):
        if (a is None) != (b is None):
            ok = False
        elif a is not None:
            err = max(err, max_err(torch, a, b))
            ok = ok and torch.equal(a, b)  # bitwise: the same f32 operations
    nbytes = (q.numel() * q.element_size() + 2 * C * 4 + 16 + P * 4  # q, scale, wn, coefs, mean
              + (2 * P * 4 if write_x else 0)
              + (2 * P * m.element_size() if write_m else 0))
    flops = 3 * C * P + P + (2 * P if write_x else 0) + (3 * P if write_m else 0)
    b_ms, b_by = bound(nbytes, flops)
    reps = 20 if C * P < 10_000_000 else 5
    ms = graph_ms(torch, run, reps)
    plain_ms = graph_ms(torch, plain, reps)
    eager = eager_ms(torch, run, 50 if C * P < 10_000_000 else 5)
    return {"C": C, "P": P, "q": q_kind, "offset": offset, "gamma": gamma,
            "write_x": write_x, "write_m": write_m,
            "m": str(m_dtype).split(".")[-1], "max_abs_err": err, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
            "eager_ms": eager, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}


# (C, P, offset) of the fold's edge cases: a misaligned contiguous plane
# view (1 element for f32 / bf16, 3 bytes for int8; x and m 1 element), a
# cohort of 1 and of 100 at the main P, ragged narrow planes, and a cohort
# of 1000 whose rows stream through the ring in several groups.
FOLD_EDGES = ((MAIN_C, MAIN_P, 1), (1, MAIN_P, 0), (100, MAIN_P, 0), (MAIN_C, 1, 0),
              (MAIN_C, 17, 0), (MAIN_C, 4099, 0), (1000, 4099, 0))


def fold_edge_cases(torch, su_kernel, su_ref, gen):
    """Both folds at ``FOLD_EDGES``, x and m written, f32 momentum: f32 and
    bf16 deltas, int8 and bf16 q; each bitwise against its plain version and
    launched twice for determinism."""
    su, dq = [], []
    for C, P, offset in FOLD_EDGES:
        for d_dtype in (torch.float32, torch.bfloat16):
            r = check_server_update(torch, su_kernel, su_ref, C, P, True, True, torch.float32,
                                    gen, d_dtype=d_dtype, offset=offset)
            su.append(r)
            say(f"server_update edge {json.dumps(r)}")
        for q_kind in ("int8", "bf16"):
            r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, True, True,
                                     torch.float32, gen,
                                     offset=3 if offset and q_kind == "int8" else offset)
            dq.append(r)
            say(f"dequant_update edge {json.dumps(r)}")
    torch.cuda.empty_cache()
    return su, dq


# the staleness discounts of the γ cases: γ and γ², the async ring's fold
# weight γ^(D−1) at D = 2 and 3 for staleness_discount 0.9
GAMMAS = (0.9, 0.81)


def full_plane_cases(torch, fd_kernel, fd_ref, su_kernel, su_ref, gen, smi_line: str):
    """Both kernels of the federated LM's round at its cohort plane
    ``(FULL_C, FULL_P)``, each alone with the card emptied before it (the
    plain fold there holds ~50 GB): ``fed_direction`` with one broadcast f32
    aux (FedCM's Δ_t), f32 x, within tolerance; ``server_update`` with f32
    m, x and m written, bitwise.  Each printed with its time beside its
    bound and its plain version's."""
    out = {}
    for name, check in (
            ("fed_direction", lambda: check_fed_direction(
                torch, fd_kernel, fd_ref, FULL_C, FULL_P, 1, torch.float32, gen)),
            ("server_update", lambda: check_server_update(
                torch, su_kernel, su_ref, FULL_C, FULL_P, True, True, torch.float32, gen))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        r = check()
        torch.cuda.empty_cache()
        say(f"{name} at the full-width federated LM plane ({FULL_C}, {FULL_P}): "
            f"{json.dumps(r)}; {r['ms']:.3f} ms against a {r['bound_ms']:.3f} ms bound "
            f"({r['bound_ms'] / r['ms']:.1%} of it), plain {r['plain_ms']:.3f} ms; "
            f"{time.perf_counter() - t0:.1f} s; {smi_line}")
        out[name] = r
    return out


def fold_gamma_cases(torch, su_kernel, su_ref, gen):
    """Both folds with the staleness discount γ ≠ 1 on coefs[3], at the main
    and the large plane, x and m written: ``server_update`` with f32 and
    bf16 momentum, ``dequant_update`` with int8 and bf16 q (f32 momentum);
    each launched twice, bitwise against the first launch and its plain
    version."""
    out = []
    for C, P in ((MAIN_C, MAIN_P), (BIG_C, BIG_P)):
        for gamma in GAMMAS:
            for m_dtype in (torch.float32, torch.bfloat16):
                r = check_server_update(torch, su_kernel, su_ref, C, P, True, True, m_dtype, gen,
                                        gamma=gamma)
                out.append(r)
                say(f"server_update gamma {json.dumps(r)}")
            for q_kind in ("int8", "bf16"):
                r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, True, True,
                                         torch.float32, gen, gamma=gamma)
                out.append(r)
                say(f"dequant_update gamma {json.dumps(r)}")
        torch.cuda.empty_cache()
    return out


def gamma_line(r, cases) -> str:
    """One γ case's time beside its γ = 1 twin (same shape and dtypes)."""
    keys = ("C", "P", "m", "d", "q")
    twin = next(c for c in cases if c.get("offset") == 0 and c["write_x"] and c["write_m"]
                and all(c.get(k) == r.get(k) for k in keys))
    name = f"server_update m {r['m']}" if "d" in r else f"dequant_update {r['q']}"
    return (f"{name} ({r['C']}, {r['P']}) gamma {r['gamma']}: {r['ms']:.6f} "
            f"(gamma 1: {twin['ms']:.6f})")


def launch_floor_ms(torch) -> float:
    """Device ms of the least launch: a one-element ``fill_``, timed as the
    fold cases are (CUDA-graph replay)."""
    one = torch.empty(1, device="cuda")
    return graph_ms(torch, lambda: one.fill_(1.0), 20)


def close_to(torch, actual, expected, rtol: float, atol_rel: float) -> bool:
    """|actual − expected| ≤ rtol·|expected| + atol_rel·max|expected|."""
    a, e = actual.float(), expected.float()
    atol = atol_rel * float(e.abs().max()) if e.numel() else 0.0
    return bool(((a - e).abs() <= rtol * e.abs() + atol).all())


def peak_flops(torch, dtype) -> float:
    """The card's peak for products of ``dtype`` inputs: the bf16 tensor
    cores for bf16, f32 outside the tensor cores for f32 (TF32 would not
    keep the plain version's f32)."""
    return BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S


def check_flash_attention(torch, fa_kernel, fa_ref, B, Sq, Skv, H, Hkv, hd, dtype, causal,
                          window, q_offset, gen, library: bool):
    """The kernel against its plain version on one case; the bound counts
    the (q, k) pairs the masks keep on these shapes."""
    dev = "cuda"
    q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa_kernel.flash_attention_bshd(q, k, v, **kw)
    ref = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    rtol, atol_rel = LM_KERNEL_TOL[name]
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    kpos = torch.arange(Skv, device=dev)[None, :]
    keep = qpos >= kpos if causal else torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if window is not None:
        keep &= qpos - kpos < window
    pairs = int(keep.sum())
    empty_rows = int((keep.sum(dim=1) == 0).sum())
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 0)
    f_ms = 4 * hd * B * H * pairs / peak_flops(torch, dtype) * 1e3
    if f_ms > b_ms:
        b_ms, b_by = f_ms, "operations"
    reps = 5 if Sq >= 1024 else 20
    res = {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv, "hd": hd, "dtype": name,
           "causal": causal, "window": window, "q_offset": q_offset, "rows_without_keys": empty_rows,
           "max_abs_err": max_err(torch, out, ref), "max_abs_plain": float(ref.float().abs().max()),
           "ok": close_to(torch, out, ref, rtol, atol_rel) and bool(torch.isfinite(out).all()),
           "ms": graph_ms(torch, lambda: fa_kernel.flash_attention_bshd(q, k, v, **kw), reps),
           "plain_ms": graph_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v, **kw), reps),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": 4 * hd * B * H * pairs, "library_ms": None}
    if library:  # the yardstick: one PyTorch call, (B, H, S, hd) layout, never on the path
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None and q_offset == 0:  # the built-in masks: no mask tensor
            lkw = dict(is_causal=causal, enable_gqa=True)
        else:
            lkw = dict(attn_mask=keep, enable_gqa=True)
        lib = sdpa(qt, kt, vt, **lkw).transpose(1, 2)
        res["library_max_abs_diff"] = max_err(torch, lib, ref)
        res["library_ms"] = graph_ms(torch, lambda: sdpa(qt, kt, vt, **lkw), reps)
    return res


def check_ssd_scan(torch, ssd_kernel, ssd_ref, B, S, H, P, N, L, dtype, gen):
    """The kernel against its plain version; x, B and C in ``dtype``, dt =
    softplus(normal − 4) as the model's dt_bias init gives, A = −(1..H)."""
    dev = "cuda"
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=dev) - 4.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    y, st = ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=L)
    y_ref, st_ref = ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    ok = (close_to(torch, y, y_ref, *LM_KERNEL_TOL[name])
          and close_to(torch, st, st_ref, *LM_KERNEL_TOL["float32"])
          and bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()))
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size() + y.numel() * y.element_size()
              + st.numel() * 4)
    # per chunk of l steps: C·Bᵀ on the causal triangle once per (b, chunk)
    # (the heads share B and C), then per (b, h, chunk) y_diag on the
    # triangle, y_off and the state update
    flops = 0
    for c0 in range(0, S, L):
        l = min(L, S - c0)
        tri = l * (l + 1) // 2
        flops += B * 2 * N * tri + B * H * (2 * P * tri + 4 * l * P * N)
    b_ms, b_by = bound(nbytes, 0)
    f_ms = flops / peak_flops(torch, dtype) * 1e3
    if f_ms > b_ms:
        b_ms, b_by = f_ms, "operations"
    reps = 5 if S >= 1024 else 20
    return {"B": B, "S": S, "H": H, "P": P, "N": N, "L": L, "dtype": name,
            "max_abs_err": max(max_err(torch, y, y_ref), max_err(torch, st, st_ref)),
            "max_abs_plain": float(y_ref.float().abs().max()), "ok": ok,
            "ms": graph_ms(torch, lambda: ssd_kernel.ssd_scan(x, dt, A, Bm, Cm, chunk=L), reps),
            "plain_ms": graph_ms(torch, lambda: ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L),
                                 reps),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "library_ms": None}


# ---------------------------------------------------------------------- phase 6
def serve_full_width(torch, np, bindings):
    """``repro_torch.launch.serve.run`` at full width for every arch of
    ``SERVE_ARCHS`` (its cut passed as ``cfg``), each with the launch counts
    set to 0 just before and read just after, and the peak device memory
    of the run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    out = {}
    for arch, cut, want in SERVE_ARCHS:
        args = serve.build_parser().parse_args(["--arch", arch, *SERVE_ARGS])
        cfg = replace(get_config(arch), **cut)
        base = witness_base(torch)  # what earlier phases still hold
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        res = serve.run(args, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        # the encoder-decoder serves one session of --gen steps, as the reference's
        sessions, steps = (1, args.gen) if cfg.is_encoder_decoder else (args.sessions,
                                                                       args.gen - 1)
        expected = {k: want.get(k, 0) * sessions for k in bindings}
        if launches != expected:
            fail(f"serving {arch}: launch counts {launches}, expected {expected}")
        if res.tokens.shape != (args.batch, args.gen) or not (
                (res.tokens >= 0).all() and (res.tokens < cfg.padded_vocab).all()):
            fail(f"serving {arch}: tokens of shape {res.tokens.shape} outside "
                 f"[0, {cfg.padded_vocab})")
        if not res.finite:
            fail(f"serving {arch}: non-finite logits")
        rows = []
        for s, (tp, td) in enumerate(zip(res.prefill_s, res.decode_s)):
            rows.append({"session": s, "prefill_ms": tp * 1e3,
                         "prefill_tok_s": args.batch * args.prompt_len / tp,
                         "decode_ms": td * 1e3,
                         "decode_tok_s": args.batch * steps / td})
            say(f"serving {arch}: {json.dumps(rows[-1])}")
        peak = torch.cuda.max_memory_allocated()
        say(f"serving {arch} (n_layers {cfg.n_layers} of {get_config(arch).n_layers}, params "
            f"{cfg.param_dtype}): launches {launches} in {sessions} sessions "
            f"({wall:.1f} s with init), peak device memory {peak} B; first tokens "
            f"{res.tokens[0, :8].tolist()}")
        out[arch] = {"launches": launches, "sessions": sessions, "rows": rows,
                     "n_layers": cfg.n_layers, "peak_bytes": peak}
        if arch in DRY_SERVE:  # phase D's witness: the dry-run serves one session's prefill
            DRY_CARD[f"serve {arch}"] = {"launches": launches, "peak": peak - base,
                                         "per": sessions}
        del res
        torch.cuda.empty_cache()
    return out


def decode_step_breakdown(torch, arch: str):
    """One full-width decode step of ``arch`` at the serving shape (B=4,
    after a 1024-token prefill): ms per step (10 steps synchronized at both
    ends), and the device operations of one step with their summed device
    time (torch.profiler).  A step launches more operations than the
    launch queue holds, so the sleep probe of ``device_ms_per_round``
    cannot time it."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import make_synthetic_lm
    from repro_torch.launch.serve import merge
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_map

    model = build_model(get_config(arch))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    prompts = torch.as_tensor(make_synthetic_lm(512, 1024, 4, seed=0), device="cuda")
    logits, pre, _ = model.apply(params, prompts, return_cache=True)
    st = {"tok": torch.argmax(logits[:, -1].float(), dim=-1)[:, None], "pos": 1024,
          "cache": tree_map(merge, model.init_cache(params, 4, 1024 + 32), pre)}
    del logits, pre

    def step():  # greedy, as the serving loop's decode step
        lg, st["cache"] = model.decode_step(params, st["tok"], st["cache"], st["pos"])
        st["tok"] = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
        st["pos"] += 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    ops, dev_ms = device_profile(torch, step)
    del st, params
    torch.cuda.empty_cache()
    return {"arch": arch, "ms_per_step": host_ms, "device_ops_per_step": ops,
            "device_op_ms_per_step": dev_ms, "device_busy_share": dev_ms / host_ms}


# ---------------------------------------------------------------------- phase 6b
def mp_drive(torch, model, params, toks, parallel=None):
    """A session of the model group's check: prefill ``toks[:, :MP_PROMPT]``
    (the encoder-decoder: encode MP_PROMPT seeded source frames), then
    MP_STEPS decode steps fed the next tokens of ``toks`` (the
    encoder-decoder: its first tokens, from position 0), recording every
    router call's experts.  Returns numpy outputs: the prefill logits (the
    encoder output), each step's logits, the cache leaves after the last
    step with the last key of each leaf's path, and the routes."""
    import numpy as np

    from repro_torch.data.synthetic import source_frames
    from repro_torch.launch.serve import merge
    from repro_torch.models import encdec, layers
    from repro_torch.sharding.rules import _keys
    from repro_torch.utils.trees import tree_flatten_with_path, tree_map

    cfg = model.cfg
    routes, router = [], layers._router

    def recording_router(p, x, c):
        got = router(p, x, c)
        routes.append(got[1].cpu().numpy())
        return got

    layers._router = recording_router
    try:
        t = torch.as_tensor(toks, device=params["embed"].device)
        out = {"decode": []}
        if cfg.is_encoder_decoder:
            src = source_frames(MP_B, MP_PROMPT, cfg.d_model, MP_SEED, t.device)
            enc = encdec.encode(params, src, cfg=cfg, use_kernels=True, parallel=parallel)
            out["prefill"] = enc.float().cpu().numpy()
            cache = model.init_cache(params, MP_B, MP_STEPS, enc_out=enc, parallel=parallel)
            first = 0
        else:
            logits, pre, _ = model.apply(params, t[:, :MP_PROMPT], return_cache=True,
                                         parallel=parallel)
            out["prefill"] = logits.float().cpu().numpy()
            cache = tree_map(merge, model.init_cache(params, MP_B, MP_PROMPT + MP_STEPS,
                                                     parallel), pre)
            first = MP_PROMPT
        for i in range(first, first + MP_STEPS):
            lg, cache = model.decode_step(params, t[:, i:i + 1], cache, i, parallel)
            out["decode"].append(lg.float().cpu().numpy())
        flat = tree_flatten_with_path(cache)[0]
        out["cache"] = [x.float().cpu().numpy() for _, x in flat]
        out["cache_keys"] = [_keys(p)[-1] for p, _ in flat]
    finally:
        layers._router = router
    out["routes"] = routes
    out["finite"] = bool(np.isfinite(out["prefill"]).all()) and all(
        np.isfinite(x).all() for x in out["decode"])
    return out


def mp_expected_launches(cfg) -> dict:
    """The LM kernels' launches in one prefill of ``cfg``: flash once an
    attention layer (the encoder-decoder: once an encoder layer), the SSD
    scan once a mamba layer."""
    from repro_torch.models.transformer import period_layout

    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.n_encoder_layers, "ssd_scan": 0}
    slots, n_periods, tail = period_layout(cfg)
    kinds = [s_.kind for s_ in slots] * n_periods + [s_.kind for s_ in tail]
    return {"flash_attention": kinds.count("attn"), "ssd_scan": kinds.count("mamba")}


def mp_cache_part(np, key: str, leaf, cfg, rank: int, n: int):
    """Rank ``rank``'s part of an unsharded cache leaf: the kv heads
    ``kv_heads_of`` names (self and cross K/V); the SSD heads of the SSM
    state (…, B, H, P, N); of the conv state (…, B, k−1, d_inner + 2N)
    those heads' x channels and B's and C's whole; the whole leaf when the
    group does not divide the SSD heads."""
    from repro_torch.models.layers import ParallelContext, kv_heads_of
    from repro_torch.models.mamba2 import local_heads

    ctx = ParallelContext(None, rank, n)
    if key in ("k", "v", "cross_k", "cross_v"):
        return leaf[..., kv_heads_of(cfg, ctx), :]
    h = local_heads(cfg, ctx)
    if h == cfg.ssm_heads:
        return leaf
    if key == "ssm":
        return leaf[..., rank * h:(rank + 1) * h, :, :]
    d, dl = cfg.ssm_expand * cfg.d_model, h * cfg.ssm_head_dim
    return np.concatenate([leaf[..., rank * dl:(rank + 1) * dl], leaf[..., d:]], axis=-1)


def mp_rank(rank, device, cases):
    """A rank of phase 6b: for each case its share of the weights drawn on
    the card (``init_params_sharded``, staged on the host) and
    ``mp_drive`` on the model group, with the flash and SSD launch counts
    set to 0 just before and read just after.  Rank 0 returns the logits;
    every rank returns a digest of them, its cache leaves, routes, launches
    and collective counts."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import synchronize
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.mesh import make_model_group
    from repro_torch.models.model import build_model
    from repro_torch.sharding.shard import init_params_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for arch, cut in cases:
        cfg = replace(get_config(arch), **cut)
        parallel = make_model_group()
        gen = torch.Generator(device=device)
        gen.manual_seed(MP_SEED)
        params = init_params_sharded(gen, cfg, parallel.rank, parallel.size, stage="cpu")
        toks = np.random.default_rng(MP_SEED).integers(0, cfg.vocab_size,
                                                       size=(MP_B, MP_PROMPT + MP_STEPS))
        fa_kernel.KERNEL.launches = 0
        ssd_kernel.KERNEL.launches = 0
        got = mp_drive(torch, build_model(cfg), params, toks, parallel)
        synchronize(device)
        got["launches"] = {"flash_attention": fa_kernel.KERNEL.launches,
                           "ssd_scan": ssd_kernel.KERNEL.launches}
        got["counts"] = dict(parallel.counts)
        got["digest"] = hashlib.sha1(b"".join(
            x.tobytes() for x in [got["prefill"], *got["decode"]])).hexdigest()
        if rank:
            del got["prefill"], got["decode"]
        out.append(got)
        del params
        torch.cuda.empty_cache()
    return out


def rel_l2_host(torch, a, b) -> float:
    """``rel_l2`` of two numpy arrays."""
    return rel_l2(torch, torch.from_numpy(a), torch.from_numpy(b))


def model_group_one_card(torch, np, cases=MP_CASES, device="cuda"):
    """Phase 6b: ``cases`` on ``MP_WORLDS`` gloo ranks sharing ``device``
    (cuda:0; the worlds run at once) against the unsharded model there (the
    same seed's weights: each rank's share is bitwise its slice of the
    unsharded draw).  Every rank's logits must be rank 0's byte for byte;
    rank 0's logits and each rank's cache (its heads of the unsharded
    cache: ``mp_cache_part``) within ``LM_REL_L2`` (bf16) or ``F32_REL_L2``
    (f32), no MoE route flipped, and ``flash_attention`` / ``ssd_scan``
    launched in each rank's prefill as ``mp_expected_launches`` says (a
    mamba case that launches no SSD scan fails).  Returns each kernel's
    launches per rank by world."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn_cohort
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    plain = {}
    for i, (arch, cut) in enumerate(cases):
        cfg = replace(get_config(arch), **cut)
        model = build_model(cfg)
        g = torch.Generator(device=device)
        g.manual_seed(MP_SEED)
        params = model.init(g)
        toks = np.random.default_rng(MP_SEED).integers(0, cfg.vocab_size,
                                                       size=(MP_B, MP_PROMPT + MP_STEPS))
        plain[i] = mp_drive(torch, model, params, toks)
        del params
        torch.cuda.empty_cache()
    say(f"model group on one card: the unsharded model's {len(cases)} cases in "
        f"{time.perf_counter() - t0:.1f} s")

    def world(n):
        tw = time.perf_counter()
        ranks = spawn_cohort(mp_rank, n, args=(cases,), device=device, backend="gloo",
                             timeout_s=MP_TIMEOUT_S, deadline_s=MP_DEADLINE_S)
        return ranks, time.perf_counter() - tw

    with ThreadPoolExecutor(len(MP_WORLDS)) as pool:
        worlds = dict(zip(MP_WORLDS, pool.map(world, MP_WORLDS)))
    launches = {}
    for n, (ranks, wall) in worlds.items():
        launches[n] = {k: [sum(c["launches"][k] for c in r) for r in ranks]
                       for k in ("flash_attention", "ssd_scan")}
        for i, (arch, cut) in enumerate(cases):
            cfg = replace(get_config(arch), **cut)
            tol = F32_REL_L2 if cfg.dtype == "float32" else LM_REL_L2
            want, got = plain[i], ranks[0][i]
            rel = {"prefill logits": rel_l2_host(torch, got["prefill"], want["prefill"])}
            for s_, (a, b) in enumerate(zip(got["decode"], want["decode"])):
                rel[f"decode {s_} logits"] = rel_l2_host(torch, a, b)
            for r in range(n):
                if ranks[r][i]["cache_keys"] != want["cache_keys"]:
                    fail(f"model group {arch} on {n} ranks: rank {r}'s cache leaves "
                         f"{ranks[r][i]['cache_keys']} are not {want['cache_keys']}")
                for j, (key, a, b) in enumerate(zip(want["cache_keys"], ranks[r][i]["cache"],
                                                    want["cache"])):
                    part = mp_cache_part(np, key, b, cfg, r, n)
                    if a.shape != part.shape:
                        fail(f"model group {arch} on {n} ranks: rank {r}'s cache {key} "
                             f"{a.shape}, its part of the unsharded one {part.shape}")
                    rel[f"rank {r} cache {j} ({key})"] = rel_l2_host(torch, a, part)
            worst = max(rel.values())
            flips = sum(int((a != b).sum()) for a, b in zip(got["routes"], want["routes"]))
            per_rank = {k: [r[i]["launches"][k] for r in ranks]
                        for k in ("flash_attention", "ssd_scan")}
            expected = {k: [v] * n for k, v in mp_expected_launches(cfg).items()}
            row = {"arch": arch, "cut": cut, "ranks": n, "B": MP_B, "prompt": MP_PROMPT,
                   "decode_steps": MP_STEPS, "max_rel_l2": worst, "rel_l2_limit": tol,
                   "route_flips": flips, "router_calls": len(want["routes"]),
                   "launches_per_rank": per_rank, "collectives_rank0": got["counts"]}
            say(f"model group on one card (gloo, ranks sharing cuda:0): {json.dumps(row)}")
            if any(r[i]["digest"] != got["digest"] for r in ranks):
                fail(f"model group {arch} on {n} ranks: a rank's logits differ from rank 0's")
            if not all(r[i]["finite"] for r in ranks) or worst > tol:
                fail(f"model group {arch} on {n} ranks vs unsharded: relative L2 {worst:.3e} "
                     f"> {tol} or non-finite ({rel})")
            if flips or len(got["routes"]) != len(want["routes"]):
                fail(f"model group {arch} on {n} ranks: {flips} MoE routes differ")
            if per_rank != expected:
                fail(f"model group {arch} on {n} ranks: kernel launches per rank {per_rank}, "
                     f"expected {expected} (flash once an attention layer, the SSD scan "
                     f"once a mamba layer)")
        say(f"model group of {n} gloo ranks sharing {device}: {wall:.1f} s wall (start-up "
            f"included, the worlds at once); launches per rank {json.dumps(launches[n])}")
    say(f"model group on one card: {time.perf_counter() - t0:.1f} s")
    return launches


def model_group_kernels(torch, fa_kernel, fa_ref, ssd_kernel, ssd_ref, gen):
    """Phase 6b: ``flash_attention`` and ``ssd_scan`` against their plain
    versions at the model groups' rank-local head counts (``MP_FLASH``,
    ``MP_SSD``)."""
    fa_cases, ssd_cases = [], []
    for H, Hkv, hd, causal in MP_FLASH:
        r = check_flash_attention(torch, fa_kernel, fa_ref, 4, 1024, 1024, H, Hkv, hd,
                                  torch.bfloat16, causal, None, 0, gen, library=True)
        say(f"flash_attention (model group rank-local) {json.dumps(r)}")
        if not r["ok"]:
            fail(f"flash_attention disagrees with its plain version at {H} / {Hkv} heads, "
                 f"hd {hd}")
        fa_cases.append(r)
    for H, N in MP_SSD:
        r = check_ssd_scan(torch, ssd_kernel, ssd_ref, 4, 1024, H, 64, N, 64, torch.bfloat16,
                           gen)
        say(f"ssd_scan (model group rank-local) {json.dumps(r)}")
        if not r["ok"]:
            fail(f"ssd_scan disagrees with its plain version at {H} heads, N {N}")
        ssd_cases.append(r)
    return fa_cases, ssd_cases


def mp_serve_rank(rank, device, arch, cut, keep_logits=False):
    """A rank of the four-card runs: ``serve.run`` (``SERVE_ARGS``) on the
    model group, with the flash and SSD launch counts and the peak memory
    reset just before and read just after; with ``keep_logits`` rank 0's
    sampled-from logits of every step (phase (n)'s reference)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_model_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = serve.build_parser().parse_args(["--arch", arch, *SERVE_ARGS])
    args.device = str(device)
    parallel = make_model_group(MP_FULL_RANKS)
    torch.cuda.reset_peak_memory_stats(device)
    fa_kernel.KERNEL.launches = 0
    ssd_kernel.KERNEL.launches = 0
    logits = {}

    def on_logits(s, i, lg):
        if keep_logits and rank == 0:
            logits[(s, i)] = lg.cpu().numpy()

    t0 = time.perf_counter()
    res = serve.run(args, cfg=replace(get_config(arch), **cut), parallel=parallel,
                    on_logits=on_logits)
    torch.cuda.synchronize(device)
    return {"wall_s": time.perf_counter() - t0, "logits": logits,
            "launches": {"flash_attention": fa_kernel.KERNEL.launches,
                         "ssd_scan": ssd_kernel.KERNEL.launches},
            "peak_bytes": torch.cuda.max_memory_allocated(device), "tokens": res.tokens,
            "finite": res.finite, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "counts": dict(parallel.counts)}


def mp_collective_rank(rank, device, shapes):
    """A rank of the four-card runs' collective probe: the ms of one
    ``all_reduce`` of a bf16 tensor of each shape in ``shapes`` (a decode
    step's and a prefill's activation), CUDA events around 50 calls after
    5 warm-up calls, and the host's ms a call over the same loop."""
    import torch
    import torch.distributed as dist

    out = []
    for shape in shapes:
        x = torch.ones(shape, dtype=torch.bfloat16, device=device)
        for _ in range(5):
            dist.all_reduce(x)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(50):
            dist.all_reduce(x)
        end.record()
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        end.synchronize()
        out.append({"shape": list(shape), "bytes": x.numel() * 2,
                    "device_ms": start.elapsed_time(end) / 50, "host_ms": host_ms})
    return out


def model_group_four_cards(torch, np, smi_line: str, cases=MP_FULL):
    """``--nccl``: first the ms of one NCCL ``all_reduce`` of a decode
    step's and of a prefill's activation (``mp_collective_rank``), then
    ``MP_FULL`` served on ``MP_FULL_RANKS`` cards over NCCL through
    ``serve.run``: tokens in range, finite and the same on every rank, the
    flash and SSD launches of ``mp_expected_launches`` a prefill on each
    rank (seamless serves one session); prefill (encode) and decode ms of
    each session, the peak device memory of each rank.  Returns rank 0's
    result of the MoE grid's reference (``MOE_GRID``'s arch, dbrx-132b)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import spawn_cohort
    from repro_torch.sharding.shard import share_bytes

    d = get_config("chameleon-34b").d_model  # a decode step's and a prefill's activation
    probe = spawn_cohort(mp_collective_rank, MP_FULL_RANKS, args=([(4, 1, d), (4, 1024, d)],),
                         device="cuda", backend="nccl", timeout_s=120.0, deadline_s=300.0)
    say(f"nccl all_reduce on {MP_FULL_RANKS} cards, bf16, ms a call (rank 0; 50 calls after 5 "
        f"warm-up): {json.dumps(probe[0])}; {smi_line}")
    moe_reference = None
    for arch, cut in cases:
        cfg = replace(get_config(arch), **cut)
        t0 = time.perf_counter()
        ranks = spawn_cohort(mp_serve_rank, MP_FULL_RANKS, args=(arch, cut, arch == "dbrx-132b"),
                             device="cuda", backend="nccl", timeout_s=600.0, deadline_s=1500.0)
        if arch == "dbrx-132b":
            moe_reference = ranks[0]
        wall = time.perf_counter() - t0
        toks = ranks[0]["tokens"]
        sessions = 1 if cfg.is_encoder_decoder else 2
        expected = {k: v * sessions for k, v in mp_expected_launches(cfg).items()}
        for r, got in enumerate(ranks):
            if not np.array_equal(got["tokens"], toks):
                fail(f"model group {arch} on {MP_FULL_RANKS} cards: rank {r}'s tokens differ")
            if got["launches"] != expected or not got["finite"]:
                fail(f"model group {arch} on {MP_FULL_RANKS} cards: rank {r} launched "
                     f"{got['launches']} (expected {expected}) or non-finite")
        if toks.shape != (4, 32) or not ((toks >= 0).all() and (toks < cfg.padded_vocab).all()):
            fail(f"model group {arch}: tokens of shape {toks.shape} outside the vocabulary")
        if arch == DRY_MP:  # phase D's witness: each rank's launches, census and peak
            for r, got in enumerate(ranks):
                DRY_CARD[f"6b {arch} rank {r}"] = {"launches": got["launches"],
                                                   "counts": got["counts"],
                                                   "peak": got["peak_bytes"]}
        steps = 32 if cfg.is_encoder_decoder else 31  # the first token comes from prefill
        for s_ in range(sessions):
            say(f"model group {arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers, "
                f"{MP_FULL_RANKS} cards, nccl): " + json.dumps({
                    "session": s_, "prefill_ms": [g["prefill_s"][s_] * 1e3 for g in ranks],
                    "decode_ms": [g["decode_s"][s_] * 1e3 for g in ranks],
                    "prefill_tok_s": 4 * 1024 / ranks[0]["prefill_s"][s_],
                    "decode_tok_s": 4 * steps / ranks[0]["decode_s"][s_]}))
        say(f"model group {arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers) on "
            f"{MP_FULL_RANKS} cards over nccl: " + json.dumps({
                "share_bytes": share_bytes(cfg, MP_FULL_RANKS),
                "peak_bytes_per_rank": [g["peak_bytes"] for g in ranks],
                "launches_per_rank": [g["launches"] for g in ranks],
                "collectives_rank0": ranks[0]["counts"],
                "run_s_per_rank": [g["wall_s"] for g in ranks], "wall_s": wall,
                "first_tokens": toks[0, :8].tolist()}) + f"; {smi_line}")
    return moe_reference


# ---------------------------------------------------------------------- phase 7
def serve_card_vs_cpu(torch, np, arch: str, cut: dict):
    """The published widths with ``cut`` (``CARD_VS_CPU``), B=2, prompt 128:
    prefill logits and cache, then 4 teacher-forced decode steps on the
    card and on the CPU from the same f32 weights (drawn on the card),
    each within ``LM_REL_L2`` (bf16 activations) or ``F32_REL_L2`` (f32).
    An MoE arch is also held to the same top-k route for every (token,
    choice) of every router call on both devices; the smallest gap between
    the k-th and (k+1)-th router probability is reported.  Beside the
    gaps, the scale of bf16 rounding at that depth: the largest relative
    L2 between the CPU's prefill in bf16 and in f32 (logits, cache)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import merge
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_leaves, tree_map

    cfg = replace(get_config(arch), **cut)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    params = {"cuda": model.init(gen)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    moe = cfg.n_experts > 0
    tol = F32_REL_L2 if cfg.dtype == "float32" else LM_REL_L2
    B, S, steps = 2, 128, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, S + steps))
    outs, routes = {}, {}
    router = layers._router

    for dev in ("cuda", "cpu"):
        calls = routes[dev] = []

        def recording_router(p, x, c):  # every MoE layer's routing decision, in call order
            got = router(p, x, c)
            calls.append((got[1].cpu(), got[2].float().cpu()))
            return got

        layers._router = recording_router
        try:
            p = params[dev]
            t = torch.as_tensor(toks, device=dev)
            logits, pre, _ = model.apply(p, t[:, :S], return_cache=True)
            seq = [("prefill logits", logits)]
            seq += [(f"prefill cache {i}", x) for i, x in enumerate(tree_leaves(pre))]
            cache = tree_map(merge, model.init_cache(p, B, S + steps), pre)
            for i in range(steps):
                lg, cache = model.decode_step(p, t[:, S + i:S + i + 1], cache, S + i)
                seq.append((f"decode {i} logits", lg))
            seq += [(f"decode cache {i}", x) for i, x in enumerate(tree_leaves(cache))]
            outs[dev] = [(name, x.detach().float().cpu()) for name, x in seq]
        finally:
            layers._router = router
    # the scale of bf16 rounding at this depth: the CPU's prefill with the
    # other activation dtype (f32 for a bf16 row, bf16 for an f32 row)
    alt = build_model(replace(cfg, dtype="float32" if cfg.dtype == "bfloat16" else "bfloat16"))
    a_logits, a_pre, _ = alt.apply(params["cpu"], torch.as_tensor(toks[:, :S]), return_cache=True)
    drift = max(float((x.float() - y).norm() / y.norm().clamp_min(1e-30)) for x, (_, y) in zip(
        [a_logits, *tree_leaves(a_pre)], outs["cpu"]))
    del params, a_logits, a_pre
    torch.cuda.empty_cache()
    worst = {}
    for (name, a), (_, b) in zip(outs["cuda"], outs["cpu"]):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worst[name] = rel
        if not (rel <= tol and bool(torch.isfinite(a).all())):
            fail(f"card vs CPU serving {arch}: {name} relative L2 error {rel:.3e} "
                 f"> {tol} (max abs diff {float((a - b).abs().max()):.3e})")
    row = {"arch": arch, "cut": cut, "B": B, "prompt": S, "decode_steps": steps,
           "max_rel_l2_logits": max(v for k, v in worst.items() if "logits" in k),
           "max_rel_l2_cache": max(v for k, v in worst.items() if "cache" in k),
           "rel_l2_limit": tol, "cpu_bf16_vs_f32_prefill_rel_l2": drift}
    if moe:
        if len(routes["cuda"]) != len(routes["cpu"]) or not routes["cpu"]:
            fail(f"card vs CPU serving {arch}: {len(routes['cuda'])} router calls on the card, "
                 f"{len(routes['cpu'])} on the CPU")
        flips = sum(int((a[0] != b[0]).sum()) for a, b in zip(routes["cuda"], routes["cpu"]))
        k = cfg.top_k
        gap = min(float((pr.sort(dim=-1, descending=True).values[:, k - 1]
                         - pr.sort(dim=-1, descending=True).values[:, k]).min())
                  for _, pr in routes["cpu"])
        row.update(router_calls=len(routes["cpu"]), route_flips=flips,
                   min_kth_prob_gap=gap)
        if flips:
            fail(f"card vs CPU serving {arch}: {flips} (token, choice) routes differ")
    return row


def encdec_card_vs_cpu(torch, np, arch: str, cut: dict):
    """The encoder-decoder at its published widths with ``cut``, bf16
    activations, from the same f32 weights (drawn on the card) on both
    devices, B=2, 128 source frames: the encoder output (its attention
    through the flash kernel on the card, its plain version on the CPU),
    the cross-attention K/V, then 4 teacher-forced decode steps' logits and
    the self-attention cache, each within ``LM_REL_L2``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_map

    cfg = replace(get_config(arch), **cut)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    params = {"cuda": model.init(gen)}
    params["cpu"] = tree_map(lambda t: t.cpu(), params["cuda"])
    B, S, steps = 2, 128, 4
    rng = np.random.default_rng(5)
    src = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, steps))
    outs = {}
    for dev in ("cuda", "cpu"):
        p = params[dev]
        enc = encdec.encode(p, torch.as_tensor(src, device=dev), cfg=cfg, use_kernels=True)
        cache = model.init_cache(p, B, steps, enc_out=enc)
        seq = [("encoder output", enc), ("cross k", cache["cross_k"]),
               ("cross v", cache["cross_v"])]
        t = torch.as_tensor(toks, device=dev)
        for i in range(steps):
            lg, cache = model.decode_step(p, t[:, i:i + 1], cache, i)
            seq.append((f"decode {i} logits", lg))
        seq += [("self cache k", cache["k"]), ("self cache v", cache["v"])]
        outs[dev] = [(name, x.detach().float().cpu()) for name, x in seq]
    del params
    torch.cuda.empty_cache()
    worst = {}
    for (name, a), (_, b) in zip(outs["cuda"], outs["cpu"]):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worst[name] = rel
        if not (rel <= LM_REL_L2 and bool(torch.isfinite(a).all())):
            fail(f"card vs CPU serving {arch}: {name} relative L2 error {rel:.3e} > {LM_REL_L2}")
    return {"arch": arch, "cut": cut, "B": B, "source_frames": S, "decode_steps": steps,
            "rel_l2": worst, "rel_l2_limit": LM_REL_L2}


# ---------------------------------------------------------------------- phase 8
def rel_l2(torch, a, b) -> float:
    """‖a − b‖ / ‖b‖ in f64, on ``a``'s device (the card's, for phase 8)."""
    a = a.detach().double()
    b = b.detach().to(a.device).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def train_matmul_flops(cfg, counts: dict, batch: int, seq: int) -> int:
    """A train step's matmul FLOPs by the 6 · params · tokens rule, part by
    part (``counts``: params by top-level key, ``TrainResult.param_counts``),
    for the dense archs of ``TRAIN_FULL``: the encoder's params see the
    source frames (``seq`` of them, as ``launch/train`` draws them), the
    rest the target tokens; the input ``embed`` is a gather and does no
    matmul unless it is tied (then it is also the unembedding).  Attention's
    score and value products are left out, as the rule leaves them out."""
    src_tokens = tgt_tokens = batch * seq
    matmul = {k: n for k, n in counts.items() if k != "embed" or cfg.tie_embeddings}
    enc = sum(n for k, n in matmul.items() if k.startswith("enc"))
    return 6 * (enc * src_tokens + (sum(matmul.values()) - enc) * tgt_tokens)


def train_card_vs_cpu(torch, np, bindings, arch: str, cut: dict):
    """Two ``launch/steps.py`` train steps (AdamW at ``TRAIN_LR``, clip 1,
    f32 activations) of ``arch`` with ``cut`` and ``TRAIN_VOCAB`` on the CPU
    and on the card from the same f32 weights (drawn on the card) and the
    same ``dummy_batch``: each step's loss and grad norm, every updated param
    leaf and both AdamW moments within ``F32_REL_L2`` (a leaf that starts at
    0 within ``UPDATE_REL_L2``), and no kernel launched on the card
    (training takes the plain route).  The CPU runs first and keeps only
    its new state, so the host holds one run at a time."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import Knobs, build_train_step
    from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map

    cfg = replace(get_config(arch), dtype="float32", vocab_size=TRAIN_VOCAB, **cut)
    step = build_train_step(cfg, Knobs(remat="none", learning_rate=TRAIN_LR))
    base = witness_base(torch)  # the card's peak from here: weights, state, steps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    params = step.model.init(gen)
    zero = [not bool(t.any()) for t in tree_leaves(params)]
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = step.model.dummy_batch(TRAIN_B, TRAIN_S)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.cpu(), params) if dev == "cpu" else params
        params = None if dev == "cuda" else params  # the card run consumes the drawn weights
        o = step.opt.init(p)
        b = tree_map(lambda t: t.to(dev), batch)
        for k in bindings.values():
            k.launches = 0
        metrics, t0 = [], time.perf_counter()
        for _ in range(2):
            p, o, m = step.fn(p, o, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = {"state": (p, o[1], o[2]), "metrics": metrics,
                     "s": time.perf_counter() - t0,
                     "launches": {k: v.launches for k, v in bindings.items()}}
        del o, p
    card_peak = torch.cuda.max_memory_allocated() - base
    if arch == DRY_TRAIN:  # phase D's witness
        DRY_CARD[f"train {arch}"] = {"launches": runs["cuda"]["launches"], "peak": card_peak}
    torch.cuda.empty_cache()
    if any(runs["cuda"]["launches"].values()):
        fail(f"card vs CPU training {arch}: kernels launched in training: "
             f"{runs['cuda']['launches']}")
    worst_metric = 0.0
    for card, cpu in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        if not np.isfinite(card).all():
            fail(f"card vs CPU training {arch}: non-finite loss or grad norm {card}")
        worst_metric = max(worst_metric, *(abs(a - b) / max(abs(b), 1e-30)
                                           for a, b in zip(card, cpu)))
    worst = {}
    for name, card, cpu in zip(("params", "m", "v"), runs["cuda"]["state"],
                               runs["cpu"]["state"]):
        for (path, a), b, z in zip(tree_flatten_with_path(card)[0], tree_leaves(cpu), zero):
            if not bool(torch.isfinite(a).all()):
                fail(f"card vs CPU training {arch}: non-finite {name} {path}")
            limit = UPDATE_REL_L2 if name == "params" and z else F32_REL_L2
            rel = rel_l2(torch, a, b)
            if rel > limit:
                fail(f"card vs CPU training {arch}: {name} {path} relative L2 {rel:.3e} > "
                     f"{limit}")
            key = f"{name} {'from 0' if name == 'params' and z else ''}".strip()
            if rel >= worst.get(key, (-1.0, ""))[0]:
                worst[key] = (rel, path)
    row = {"arch": arch, "cut": dict(cut, vocab_size=TRAIN_VOCAB), "params": n_params,
           "B": TRAIN_B, "S": TRAIN_S, "loss_grad_norm_max_rel": worst_metric,
           "max_rel_l2": worst, "limits": [F32_REL_L2, UPDATE_REL_L2],
           "losses": [m[0] for m in runs["cuda"]["metrics"]],
           "card_s_2_steps": runs["cuda"]["s"], "cpu_s_2_steps": runs["cpu"]["s"],
           "card_peak_bytes": card_peak}
    del runs
    torch.cuda.empty_cache()
    if worst_metric > F32_REL_L2:
        fail(f"card vs CPU training {arch}: {json.dumps(row)}")
    return row


def train_full_width(torch, np, bindings):
    """``repro_torch.launch.train.run`` at full width for ``TRAIN_FULL``
    (``TRAIN_ARGS``: 30 steps of 512 tokens a row, warmup 5), with the launch
    counts set to 0 just before each and read just after (training launches
    no kernel): a finite loss whose last logged value is below the first,
    ms/step and tok/s of the steps after the first ``TRAIN_WARM``, the peak
    device memory, and the share of the card's bf16 peak that the step's
    matmul FLOPs (``train_matmul_flops``) over its time reach.  A batch the card cannot hold
    is halved and the cut printed; the width is never cut."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train

    rows = []
    for arch, batch in TRAIN_FULL:
        while True:
            args = train.build_parser().parse_args(["--arch", arch, "--batch", str(batch),
                                                    *TRAIN_ARGS])
            torch.cuda.empty_cache()
            for b in bindings.values():
                b.launches = 0
            t0 = time.perf_counter()
            try:
                res = train.run(args, echo=False)
                break
            except torch.cuda.OutOfMemoryError:
                say(f"training {arch}: batch {batch} does not fit the card; cut to {batch // 2}")
                torch.cuda.empty_cache()
                if batch == 1:
                    fail(f"training {arch}: batch 1 does not fit the card")
                batch //= 2
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        if any(launches.values()):
            fail(f"training {arch}: kernels launched in training: {launches}")
        logged = [r["loss"] for r in res.rows]
        if not (np.isfinite(res.losses).all() and logged[-1] < logged[0]):
            fail(f"training {arch}: losses {res.losses} (logged {logged})")
        steady = res.step_s[TRAIN_WARM:]
        step_s = statistics.mean(steady)
        tokens = batch * args.seq
        flops = train_matmul_flops(get_config(arch), res.param_counts, batch, args.seq)
        row = {"arch": arch, "params": sum(res.param_counts.values()),
               "matmul_flops_per_step": flops, "batch": batch, "seq": args.seq,
               "steps": len(res.losses), "logged_losses": logged,
               "ms_per_step": step_s * 1e3, "ms_per_step_median": statistics.median(steady) * 1e3,
               "tok_s": tokens / step_s, "peak_bytes": res.peak_bytes,
               "bf16_peak_share": flops / step_s / BF16_FLOPS_PER_S,
               "wall_s_with_init": wall}
        say(f"training at full width: {json.dumps(row)}")
        rows.append(row)
        del res
        torch.cuda.empty_cache()
    return rows


def fed_lm_card_vs_cpu(torch, np, bindings, smi_line: str):
    """Phase 8 (c): ``FED_LM_RUN`` rounds of FedCM over ``FED_LM_VS_CPU`` on
    the card and on the CPU through ``FederatedEngine.round_step``
    (``cohort_loss_fn``; ``LMFederatedData`` from ``federated_lm_corpora``),
    from one converted state, with the same ids, masks and minibatch
    indices: params within ``PARITY_RTOL`` / ``PARITY_ATOL``, momentum within
    ``F32_REL_L2``, each round's loss too; on the card K ``fed_direction``
    and one ``server_update`` a round, no other kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, metrics_to_host
    from repro_torch.data import LMFederatedData, federated_lm_corpora, gather_round_batches
    from repro_torch.models.model import build_model, cohort_loss_fn

    arch, cut = FED_LM_VS_CPU
    cfg = replace(get_config(arch), **cut)
    model = build_model(cfg)
    B, S = FED_LM_VS_CPU_BATCH
    n, C, K, R = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps", "rounds"))
    fed = fed_lm_config()
    params = params_to_numpy(model.init(torch.Generator().manual_seed(8)))
    toks = federated_lm_corpora(cfg.vocab_size, n, S + 1, 64)
    rng = np.random.default_rng(8)
    draws = [(rng.permutation(n)[:C], rng.integers(0, toks.shape[1], size=(C, K, B)))
             for _ in range(R)]
    runs = {}
    for dev in ("cuda", "cpu"):
        data = LMFederatedData(toks, device=dev)
        state, spec = state_from_numpy(params, fed, device=dev)
        eng = FederatedEngine(fed, cohort_loss_fn(model), spec, batch_size=B, device=dev)
        for b in bindings.values():
            b.launches = 0
        losses, t0 = [], time.perf_counter()
        for ids, idx in draws:
            ids_t = torch.as_tensor(ids, device=dev)
            batches = gather_round_batches(data.client_x, data.client_y, None, ids_t, K, B,
                                           idx=torch.as_tensor(idx))
            state, m = eng.round_step(state, batches, ids_t,
                                      torch.ones(C, dtype=torch.bool, device=dev))
            losses.append(float(metrics_to_host(m)["loss"][0]))
        runs[dev] = {"state": state_to_numpy(state), "losses": losses,
                     "s": time.perf_counter() - t0,
                     "launches": {k: b.launches for k, b in bindings.items()}}
        del state, eng, data
    torch.cuda.empty_cache()
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    if runs["cuda"]["launches"] != expected:
        fail(f"federated LM card vs CPU: launch counts {runs['cuda']['launches']}, "
             f"expected {expected}")
    card, cpu = runs["cuda"], runs["cpu"]
    p_diff = float(np.max(np.abs(card["state"]["params"] - cpu["state"]["params"])))
    m_rel = rel_l2(torch, torch.from_numpy(card["state"]["momentum"]),
                   torch.from_numpy(cpu["state"]["momentum"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    row = {"arch": arch, "cut": cut, "params": int(card["state"]["params"].size), "N": n,
           "cohort": C, "K": K, "B": B, "S": S, "rounds": R, "losses": card["losses"],
           "loss_max_rel": loss_rel, "params_max_abs_diff": p_diff,
           "momentum_rel_l2": m_rel, "launches": card["launches"],
           "card_s": card["s"], "cpu_s": cpu["s"], "card": smi_line,
           "limits": {"params": [PARITY_RTOL, PARITY_ATOL], "momentum": F32_REL_L2}}
    if not (np.isfinite(card["losses"]).all()
            and np.allclose(card["state"]["params"], cpu["state"]["params"], rtol=PARITY_RTOL,
                            atol=PARITY_ATOL)
            and m_rel <= F32_REL_L2 and loss_rel <= F32_REL_L2):
        fail(f"federated LM card vs CPU: {json.dumps(row)}")
    say(f"federated LM card vs CPU: {json.dumps(row)}")
    return card["launches"]


def fed_lm_full_width(torch, np, bindings, smi_line: str):
    """Phase 8 (d): ``launch/federated_llm.run`` over ``FED_LM_FULL`` with
    ``FED_LM_RUN`` and ``FED_LM_FULL_BATCH``, the launch counts set to 0
    just before and read just after: K ``fed_direction`` and one
    ``server_update`` a round, no other kernel; finite losses, the last
    round's mean local loss below the first's; ms a round and the peak
    device memory printed.  An out-of-memory error fails the phase: nothing
    is retried smaller."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import federated_llm

    cfg = get_config(FED_LM_FULL)
    B, S = FED_LM_FULL_BATCH
    torch.cuda.empty_cache()
    for b in bindings.values():
        b.launches = 0
    t0 = time.perf_counter()
    res = federated_llm.run(cfg, **FED_LM_RUN, batch=B, seq=S, device="cuda")
    wall = time.perf_counter() - t0
    launches = {k: b.launches for k, b in bindings.items()}
    R, K = FED_LM_RUN["rounds"], FED_LM_RUN["local_steps"]
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    losses = [r["loss"] for r in res.rounds]
    row = {"arch": FED_LM_FULL, "cut": "none (published config)", "params": res.n_params,
           "cohort_plane_bytes": FED_LM_RUN["cohort"] * res.n_params * 4,
           **FED_LM_RUN, "B": B, "S": S, "losses": losses,
           "momentum_norm": [r["momentum_norm"] for r in res.rounds],
           "ms_per_round": res.round_ms, "peak_gb": res.peak_bytes / 1e9,
           "launches": launches, "wall_s_with_init": wall, "card": smi_line}
    say(f"federated LM at full width: {json.dumps(row)}")
    if launches != expected:
        fail(f"federated LM at full width: launch counts {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"federated LM at full width: losses {losses} do not fall")
    del res
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 8 (e)-(h)
def replicated_digest(torch, leaves, parts) -> str:
    """A hash of the bytes of every part a model group replicates (whole
    and partial, ``rules.group_parts``), in order: equal on every rank iff
    those parts are bitwise equal."""
    import hashlib

    h = hashlib.sha256()
    for t, (dim, pieces) in zip(leaves, parts):
        for off, width, use in pieces:
            if use != "split":
                seg = t if dim is None else t.narrow(dim, off, width)
                h.update(seg.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def group_train_case(torch, arch, cut, parallel, device):
    """Phase 8 (e) in one rank: the unsharded step on the card (the ranks
    take turns, so that one holds its whole train state at a time) and this
    rank's slice of its params and moments; then two steps of this rank's
    share (``init_params_sharded`` from the same seed: its slice of the same
    draw), with the kernels' launch counts set just before and read just
    after; every leaf against the unsharded slice."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import synchronize
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.launch.steps import Knobs, build_train_step
    from repro_torch.sharding.rules import param_specs
    from repro_torch.sharding.shard import init_params_sharded, share_parts, take
    from repro_torch.utils.trees import tree_leaves

    cfg = replace(get_config(arch), dtype="float32", vocab_size=TRAIN_VOCAB, **cut)
    knobs = Knobs(remat="none", learning_rate=TRAIN_LR)
    n, rank = parallel.size, parallel.rank
    for r in range(n):
        if r == rank:
            step = build_train_step(cfg, knobs)
            gen = torch.Generator(device=device)
            gen.manual_seed(GROUP_SEED)
            params = step.model.init(gen)
            specs = tree_leaves(param_specs(params, cfg, n))
            zero = [not bool(t.any()) for t in tree_leaves(params)]
            batch = step.model.dummy_batch(TRAIN_B, TRAIN_S, device)
            o, whole_metrics = step.opt.init(params), []
            for _ in range(2):
                params, o, m = step.fn(params, o, batch)
                whole_metrics.append((float(m["loss"]), float(m["grad_norm"])))
            want = {name: [take(t, d, rank, n) for t, d in zip(tree_leaves(tree), specs)]
                    for name, tree in (("params", params), ("m", o[1]), ("v", o[2]))}
            del params, o, step
            torch.cuda.empty_cache()
        dist.barrier(group=parallel.group)
    gstep = build_train_step(cfg, knobs, parallel)
    gen = torch.Generator(device=device)
    gen.manual_seed(GROUP_SEED)
    share = init_params_sharded(gen, cfg, rank, n)
    for k in parallel.counts:
        parallel.counts[k] = 0
    before = launch_counts()
    synchronize(device)
    t0 = time.perf_counter()
    p, o, metrics = share, gstep.opt.init(share), []
    for _ in range(2):
        p, o, m = gstep.fn(p, o, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    s = time.perf_counter() - t0
    launches = launches_since(before)
    worst, bad = {}, []
    for name, tree in (("params", p), ("m", o[1]), ("v", o[2])):
        for i, (a, b, z) in enumerate(zip(tree_leaves(tree), want[name], zero)):
            limit = UPDATE_REL_L2 if name == "params" and z else F32_REL_L2
            rel = rel_l2(torch, a, b)
            key = f"{name} {'from 0' if name == 'params' and z else ''}".strip()
            worst[key] = max(worst.get(key, 0.0), rel)
            if not (rel <= limit and bool(torch.isfinite(a).all())):
                bad.append((name, i, rel, limit))
    parts = share_parts(cfg, n)
    return {"arch": arch, "metrics": metrics, "unsharded_metrics": whole_metrics,
            "max_rel_l2": worst, "bad": bad, "launches": launches, "s_2_steps": s,
            "counts": dict(parallel.counts),
            "digest": [replicated_digest(torch, tree_leaves(t), parts) for t in (p, o[1], o[2])]}


def group_fed_case(torch, parallel, device, draws, cohort_group=None):
    """Phase 8 (f) in one rank: ``FED_LM_RUN`` rounds of FedCM over
    ``FED_LM_VS_CPU`` through ``round_step`` on the injected ``draws`` (phase
    8 (c)'s weights and draws), each client this rank's share of the model
    group (``model_group``), the cohort over ``cohort_group`` when given (a
    grid's data group, phase 8 (j)), the kernels' launch counts set just
    before and read just after; then one round on the engine's own draws
    from a generator seeded alike on every rank (the engine checks the
    ranks drew alike).  Returns this rank's params and momentum planes, each
    round's loss, a digest of the ids and minibatches it used, the
    launches."""
    import hashlib

    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import FederatedEngine, metrics_to_host
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import LMFederatedData, federated_lm_corpora, gather_round_batches
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.models.model import build_model, cohort_loss_fn
    from repro_torch.sharding.rules import param_specs
    from repro_torch.sharding.shard import group_plane, shard_params
    from repro_torch.utils.trees import tree_map

    arch, cut = FED_LM_VS_CPU
    cfg = replace(get_config(arch), **cut)
    model = build_model(cfg)
    B, S = FED_LM_VS_CPU_BATCH
    n_cl, C, K = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps"))
    fed = fed_lm_config()
    if device.type == "cuda":  # this phase's peak, not (e)'s
        torch.cuda.reset_peak_memory_stats(device)
    whole = model.init(torch.Generator().manual_seed(8))  # phase 8 (c)'s weights
    share = tree_map(lambda t: t.to(device), shard_params(
        whole, param_specs(whole, cfg, parallel.size), parallel.rank, parallel.size))
    del whole
    spec = FlatSpec.from_tree(share)
    eng = FederatedEngine(fed, cohort_loss_fn(model, parallel), spec, batch_size=B,
                          device=device, cohort_group=cohort_group,
                          model_group=group_plane(spec, cfg, parallel))
    data = LMFederatedData(federated_lm_corpora(cfg.vocab_size, n_cl, S + 1, 64), device=device)
    state = eng.init(share)
    seen, losses = hashlib.sha256(), []
    before = launch_counts()
    for ids, idx in draws:
        ids_t = torch.as_tensor(ids, device=device)
        batches = gather_round_batches(data.client_x, data.client_y, None, ids_t, K, B,
                                       idx=torch.as_tensor(idx))
        seen.update(ids_t.cpu().numpy().tobytes())
        seen.update(batches["x"].cpu().numpy().tobytes())
        state, m = eng.round_step(state, batches, ids_t,
                                  torch.ones(C, dtype=torch.bool, device=device))
        losses.append(float(metrics_to_host(m)["loss"][0]))
    launches = launches_since(before)
    rng = torch.Generator(device=device)
    rng.manual_seed(GROUP_SEED)
    drawn, dm = eng.run_round(eng.init(share, rng), data)
    out = {"params": state.params.cpu().numpy(), "momentum": state.server.momentum.cpu().numpy(),
           "losses": losses, "draws_digest": seen.hexdigest(), "launches": launches,
           "share_params": spec.size, "drawn_round_loss": float(metrics_to_host(dm)["loss"][0]),
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                          else None)}
    if cohort_group is None:
        del state, drawn, eng
        out["variants"] = fed_variant_rounds(torch, cfg, share, data, device, parallel)
    return out


def fed_lm_config(**variant):
    """Phase 8 (c)'s FedCM round over ``FED_LM_VS_CPU`` (``FED_LM_RUN``, a
    fixed cohort, ``federated_llm``'s constants), ``variant`` setting any
    other field."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.launch import federated_llm

    n_cl, C, K = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps"))
    return FedConfig(**{**dict(algo="fedcm", num_clients=n_cl, cohort_size=C, local_steps=K,
                               alpha=federated_llm.ALPHA, eta_l=0.05,
                               weight_decay=federated_llm.WEIGHT_DECAY, participation="fixed"),
                        **variant})


def fed_variant_rounds(torch, cfg, params, data, device, parallel=None):
    """Phase 8 (f)'s variants (``GROUP_FED_VARIANTS``): for each,
    ``GROUP_FED_VARIANT_ROUNDS`` rounds of ``fed_lm_config`` with its fields
    over ``cfg`` from ``params`` — this rank's share on the model group
    ``parallel``, else the whole model — on the engine's own draws from a
    generator seeded ``GROUP_SEED`` on ``device``, the kernels' launch
    counts set just before and read just after.  Returns per variant the
    params and momentum planes (a tree's leaves raveled in order), each
    round's loss, ``n_active`` / ``n_dropped`` / ``n_quarantined`` and ms,
    the launches and the variant's wall seconds (set-up and planes on the
    host included)."""
    from repro_torch.configs.base import FaultConfig
    from repro_torch.core.engine import FederatedEngine, metrics_to_host, synchronize
    from repro_torch.core.flat import FlatSpec
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.models.model import build_model, cohort_loss_fn
    from repro_torch.sharding.shard import group_plane
    from repro_torch.utils.trees import tree_leaves

    B, _ = FED_LM_VS_CPU_BATCH
    model = build_model(cfg)
    spec = FlatSpec.from_tree(params)
    group = None if parallel is None else group_plane(spec, cfg, parallel)

    def plane(x):
        return torch.cat([t.reshape(-1) for t in tree_leaves(x)]).cpu().numpy()

    out = {}
    register_user_specs()
    try:
        for name, (kw, _) in GROUP_FED_VARIANTS.items():
            if "fault" in kw:
                kw = {**kw, "fault": FaultConfig(**kw["fault"])}
            t_set = time.perf_counter()
            eng = FederatedEngine(fed_lm_config(**kw), cohort_loss_fn(model, parallel), spec,
                                  batch_size=B, device=device, model_group=group)
            rng = torch.Generator(device=device)
            rng.manual_seed(GROUP_SEED)
            state = eng.init(params, rng)
            before = launch_counts()
            rows, round_ms = [], []
            for _ in range(GROUP_FED_VARIANT_ROUNDS):
                synchronize(torch.device(device))
                t0 = time.perf_counter()
                state, m = eng.run_round(state, data)
                synchronize(torch.device(device))
                round_ms.append((time.perf_counter() - t0) * 1e3)
                rows.append(metrics_to_host(m))
            out[name] = {"params": plane(state.params), "momentum": plane(state.server.momentum),
                         "losses": [float(r["loss"][0]) for r in rows],
                         "counters": {k: [float(r[k][0]) for r in rows]
                                      for k in ("n_active", "n_dropped", "n_quarantined")},
                         "launches": launches_since(before), "ms_per_round": round_ms,
                         "wall_s": time.perf_counter() - t_set}
            del state, eng
    finally:
        unregister_user_specs()
    return out


def group_rank(rank, device, draws):
    """A rank of phases 8 (e) and (f) on one card."""
    import torch

    from repro_torch.launch.mesh import make_model_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel = make_model_group()
    t0 = time.perf_counter()
    train = [group_train_case(torch, arch, cut, parallel, device) for arch, cut in GROUP_TRAIN]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fed = group_fed_case(torch, parallel, device, draws)
    return {"train": train, "fed": fed,
            "s": {"(e)": t1 - t0, "(f)": time.perf_counter() - t1}}


def remat_dots_on_card(torch, np, device="cuda"):
    """Phase 8 (e), its last part: the loss and every gradient of
    ``REMAT_CASE`` under ``remat="dots"`` against ``"none"`` within
    ``F32_REL_L2``, and the peak device memory the loss and gradient add
    under ``"none"``, ``"dots"`` and ``"full"``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

    arch, cut = REMAT_CASE
    model = build_model(replace(get_config(arch), **cut))
    cuda = device == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(GROUP_SEED)
    params = model.init(gen)
    batch = model.dummy_batch(REMAT_B, REMAT_S, device)
    runs = {}
    for remat in ("none", "dots", "full"):
        base = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(lambda p, b: model.loss_fn(p, b, remat=remat), params,
                                          batch)
        if cuda:
            torch.cuda.synchronize()
        runs[remat] = {"loss": loss, "grads": grads, "s": time.perf_counter() - t0,
                       "peak": torch.cuda.max_memory_allocated() - base if cuda else 0}
    loss_rel = abs(float(runs["dots"]["loss"]) - float(runs["none"]["loss"])) / abs(
        float(runs["none"]["loss"]))
    worst, where = 0.0, ""
    for (path, a), b in zip(tree_flatten_with_path(runs["dots"]["grads"])[0],
                            tree_leaves(runs["none"]["grads"])):
        rel = rel_l2(torch, a, b)
        if rel >= worst:
            worst, where = rel, path
    peaks = {k: runs[k]["peak"] for k in runs}
    row = {"arch": arch, "cut": cut, "B": REMAT_B, "S": REMAT_S, "loss_rel": loss_rel,
           "grad_max_rel_l2": worst, "worst_leaf": where, "limit": F32_REL_L2,
           "peak_bytes": peaks, "dots_between": peaks["none"] >= peaks["dots"] >= peaks["full"],
           "s": {k: runs[k]["s"] for k in runs}}
    del runs, params
    torch.cuda.empty_cache()
    if not (loss_rel <= F32_REL_L2 and worst <= F32_REL_L2):
        fail(f"remat dots vs none on the card: {json.dumps(row)}")
    say(f"remat dots vs none on the card: {json.dumps(row)}")
    return row


def fed_lm_draws(np):
    """Phase 8 (c)'s FedCM config, corpora and injected draws: each round's
    cohort ids and every client's minibatch indices."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import federated_lm_corpora

    arch, cut = FED_LM_VS_CPU
    cfg = replace(get_config(arch), **cut)
    B, S = FED_LM_VS_CPU_BATCH
    n_cl, C, K, R = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps", "rounds"))
    toks = federated_lm_corpora(cfg.vocab_size, n_cl, S + 1, 64)
    rng = np.random.default_rng(8)
    draws = [(rng.permutation(n_cl)[:C], rng.integers(0, toks.shape[1], size=(C, K, B)))
             for _ in range(R)]
    return cfg, toks, draws


def model_group_training_one_card(torch, np, smi_line: str, device="cuda", world=None):
    """Phases 8 (e) and (f): one world of ``GROUP_RANKS`` gloo ranks sharing
    cuda:0 (``group_rank``; ``world``: its ranks' results and wall seconds
    when the caller ran it), against the unsharded step (each rank runs it)
    and the unsharded FedCM round on the card (here, phase 8 (c)'s weights
    and draws).  (e): each rank's updated share and both moments within
    ``F32_REL_L2`` of the unsharded slice (a leaf from 0 within
    ``UPDATE_REL_L2``), the replicated parts bitwise equal across ranks, the
    same loss and grad norm on every rank, no kernel launched; then
    ``remat_dots_on_card``.  (f): the ranks' planes joined within
    ``PARITY_RTOL`` / ``PARITY_ATOL`` (params) and ``F32_REL_L2``
    (momentum, each round's loss) of the unsharded round's, the draws equal
    on every rank, K ``fed_direction`` and one ``server_update`` a round on
    each rank's share.  Returns each rank's (f) launches."""
    arch, cut = FED_LM_VS_CPU
    cfg, toks, draws = fed_lm_draws(np)
    B, S = FED_LM_VS_CPU_BATCH
    n_cl, C, K, R = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps", "rounds"))
    t0 = time.perf_counter()
    ranks, wall = group_world_one_card(torch, group_rank, GROUP_RANKS, (draws,), device) \
        if world is None else world
    # (e)
    for i, (arch_i, cut_i) in enumerate(GROUP_TRAIN):
        rows = [got["train"][i] for got in ranks]
        first = rows[0]
        for r, got in enumerate(rows):
            if got["bad"] or any(got["launches"].values()):
                fail(f"training on a model group, {arch_i}: rank {r}: leaves beyond their "
                     f"bound {got['bad'][:5]}, launches {got['launches']}")
            if got["digest"] != first["digest"] or got["metrics"] != first["metrics"]:
                fail(f"training on a model group, {arch_i}: rank {r}'s replicated parts or "
                     f"loss / grad norm differ from rank 0's")
        worst_metric = max(abs(a - b) / max(abs(b), 1e-30)
                           for got, want in zip(first["metrics"], first["unsharded_metrics"])
                           for a, b in zip(got, want))
        if not (np.isfinite(first["metrics"]).all() and worst_metric <= F32_REL_L2):
            fail(f"training on a model group, {arch_i}: metrics {first['metrics']} against "
                 f"{first['unsharded_metrics']}")
        say(f"training on a model group ({GROUP_RANKS} gloo ranks sharing cuda:0): " + json.dumps({
            "arch": arch_i, "cut": dict(cut_i, vocab_size=TRAIN_VOCAB), "B": TRAIN_B,
            "S": TRAIN_S, "losses": [m[0] for m in first["metrics"]],
            "loss_grad_norm_max_rel": worst_metric,
            "max_rel_l2_per_rank": [got["max_rel_l2"] for got in rows],
            "limits": [F32_REL_L2, UPDATE_REL_L2], "launches_per_rank": [
                got["launches"] for got in rows], "collectives_rank0": first["counts"],
            "s_2_steps_per_rank": [got["s_2_steps"] for got in rows]}))
    remat = remat_dots_on_card(torch, np, device)
    lap_e = time.perf_counter() - t0
    # (f): the unsharded round on the card, phase 8 (c)'s
    want, losses = fed_lm_unsharded_on_card(torch, cfg, draws, toks, device)
    n = GROUP_RANKS
    got = {k: joined_fed_planes(torch, np, cfg, [r["fed"][k] for r in ranks], n)
           for k in ("params", "momentum")}
    fed_rows = [r["fed"] for r in ranks]
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    p_diff = float(np.max(np.abs(got["params"] - want["params"])))
    m_rel = rel_l2_host(torch, got["momentum"], want["momentum"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fed_rows[0]["losses"], losses))
    row = {"arch": arch, "cut": cut, "ranks": n, "share_params": [f["share_params"] for f in fed_rows],
           "params": int(want["params"].size), "N": n_cl, "cohort": C, "K": K, "B": B, "S": S,
           "rounds": R, "losses": fed_rows[0]["losses"], "loss_max_rel": loss_rel,
           "params_max_abs_diff": p_diff, "momentum_rel_l2": m_rel,
           "launches_per_rank": [f["launches"] for f in fed_rows],
           "draws_equal": len({f["draws_digest"] for f in fed_rows}) == 1,
           "drawn_round_loss_per_rank": [f["drawn_round_loss"] for f in fed_rows],
           "peak_bytes_per_rank": [f["peak_bytes"] for f in fed_rows], "card": smi_line,
           "limits": {"params": [PARITY_RTOL, PARITY_ATOL], "momentum": F32_REL_L2}}
    say(f"FedCM on a model group ({n} gloo ranks sharing cuda:0) vs the unsharded card round: "
        f"{json.dumps(row)}")
    if not (row["draws_equal"] and len(set(row["drawn_round_loss_per_rank"])) == 1):
        fail("FedCM on a model group: the ranks' draws differ")
    if any(f["launches"] != expected for f in fed_rows):
        fail(f"FedCM on a model group: launches {row['launches_per_rank']}, expected {expected} "
             f"on each rank")
    if not (np.isfinite(fed_rows[0]["losses"]).all()
            and np.allclose(got["params"], want["params"], rtol=PARITY_RTOL, atol=PARITY_ATOL)
            and m_rel <= F32_REL_L2 and loss_rel <= F32_REL_L2
            and all(f["losses"] == fed_rows[0]["losses"] for f in fed_rows)):
        fail(f"FedCM on a model group: {json.dumps(row)}")
    by_path = {f"fed_lm_group_rank{r}": f["launches"] for r, f in enumerate(fed_rows)}
    by_path.update(fed_variants_on_card(torch, np, cfg, toks, fed_rows, smi_line, device))
    say(f"phases 8 (e)-(f): the world {wall:.1f} s (rank 0's (e) / (f) "
        f"{ranks[0]['s']['(e)']:.1f} / {ranks[0]['s']['(f)']:.1f} s), (e) with remat "
        f"{lap_e:.1f} s, the whole "
        f"{time.perf_counter() - t0:.1f} s; remat peaks {json.dumps(remat['peak_bytes'])}")
    return by_path


def fed_variants_on_card(torch, np, cfg, toks, fed_rows, smi_line: str, device):
    """Phase 8 (f)'s variants (``GROUP_FED_VARIANTS``): the ranks' rounds
    (``fed_rows[r]["variants"]``) against the same rounds unsharded on the
    card (``fed_variant_rounds``): the counters (``n_active``,
    ``n_dropped``, ``n_quarantined``) equal on every rank and to the
    unsharded run's, the joined params within ``PARITY_RTOL`` /
    ``PARITY_ATOL``, the momentum and each round's loss within
    ``F32_REL_L2``, each rank's launches the variant's.  Returns each rank's
    launches by path."""
    from repro_torch.data import LMFederatedData
    from repro_torch.models.model import build_model

    n, K, R = GROUP_RANKS, FED_LM_RUN["local_steps"], GROUP_FED_VARIANT_ROUNDS
    whole = build_model(cfg).init(torch.Generator().manual_seed(8))  # phase 8 (c)'s weights
    want_all = fed_variant_rounds(torch, cfg, whole, LMFederatedData(toks, device=device), device)
    del whole
    torch.cuda.empty_cache()
    by_path = {}
    for name, (kw, (per_step, per_round)) in GROUP_FED_VARIANTS.items():
        rows = [f["variants"][name] for f in fed_rows]
        want = want_all[name]
        got = {k: joined_fed_planes(torch, np, cfg, [r[k] for r in rows], n)
               for k in ("params", "momentum")}
        expected = {"fed_direction": R * K * per_step, "server_update": R * per_round,
                    "dequant_update": 0, "flash_attention": 0, "ssd_scan": 0}
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"], want["losses"]))
        row = {"variant": name, "config": {k: v for k, v in kw.items()}, "ranks": n,
               "rounds": R, "losses": rows[0]["losses"], "loss_max_rel": loss_rel,
               "counters": rows[0]["counters"], "unsharded_counters": want["counters"],
               "params_max_abs_diff": float(np.max(np.abs(got["params"] - want["params"]))),
               "momentum_rel_l2": rel_l2_host(torch, got["momentum"], want["momentum"]),
               "ms_per_round_per_rank": [r["ms_per_round"] for r in rows],
               "unsharded_ms_per_round": want["ms_per_round"],
               "wall_s_per_rank": [r["wall_s"] for r in rows],
               "unsharded_wall_s": want["wall_s"],
               "launches_per_rank": [r["launches"] for r in rows], "card": smi_line,
               "limits": {"params": [PARITY_RTOL, PARITY_ATOL], "momentum": F32_REL_L2}}
        say(f"FedCM on a model group ({n} gloo ranks sharing cuda:0), {name}, on the engine's "
            f"own draws vs the unsharded card rounds: {json.dumps(row)}")
        if any(r["launches"] != expected for r in rows):
            fail(f"FedCM on a model group, {name}: launches {row['launches_per_rank']}, "
                 f"expected {expected} on each rank")
        if not (all(r["counters"] == want["counters"] and r["losses"] == rows[0]["losses"]
                    for r in rows)
                and np.isfinite(rows[0]["losses"]).all()
                and np.allclose(got["params"], want["params"], rtol=PARITY_RTOL, atol=PARITY_ATOL)
                and row["momentum_rel_l2"] <= F32_REL_L2 and loss_rel <= F32_REL_L2):
            fail(f"FedCM on a model group, {name}: {json.dumps(row)}")
        by_path.update({f"fed_lm_group_{name}_rank{r}": rows[r]["launches"] for r in range(n)})
    return by_path


def fed_lm_unsharded_on_card(torch, cfg, draws, toks, device):
    """Phase 8 (c)'s FedCM rounds on the card, unsharded: ``FED_LM_RUN``
    rounds over ``cfg`` from phase 8 (c)'s weights on the injected
    ``draws`` (ids, minibatch indices into ``toks``).  Returns the params
    and momentum planes after them (numpy) and each round's loss."""
    from repro_torch.core.engine import FederatedEngine, metrics_to_host
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import LMFederatedData, gather_round_batches
    from repro_torch.models.model import build_model, cohort_loss_fn

    B, _ = FED_LM_VS_CPU_BATCH
    n_cl, C, K = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps"))
    model = build_model(cfg)
    fed = fed_lm_config()
    whole = model.init(torch.Generator().manual_seed(8))
    eng = FederatedEngine(fed, cohort_loss_fn(model), FlatSpec.from_tree(whole), batch_size=B,
                          device=device)
    data = LMFederatedData(toks, device=device)
    state = eng.init(whole)
    losses = []
    for ids, idx in draws:
        ids_t = torch.as_tensor(ids, device=device)
        batches = gather_round_batches(data.client_x, data.client_y, None, ids_t, K, B,
                                       idx=torch.as_tensor(idx))
        state, m = eng.round_step(state, batches, ids_t,
                                  torch.ones(C, dtype=torch.bool, device=device))
        losses.append(float(metrics_to_host(m)["loss"][0]))
    want = {"params": state.params.cpu().numpy(), "momentum": state.server.momentum.cpu().numpy()}
    del state, eng, data
    torch.cuda.empty_cache()
    return want, losses


def joined_fed_planes(torch, np, cfg, planes, n: int):
    """The whole ``(P,)`` plane from the ``(P_r,)`` planes of a model
    group's ``n`` ranks (rank order)."""
    from repro_torch.core.flat import FlatSpec
    from repro_torch.sharding.rules import param_specs
    from repro_torch.sharding.shard import join_shares, param_shapes, shard_params
    from repro_torch.utils.trees import tree_leaves

    shapes = param_shapes(cfg)
    specs = param_specs(shapes, cfg, n)
    per_rank = [FlatSpec.from_tree(shard_params(shapes, specs, r, n)).views(
        torch.from_numpy(planes[r])) for r in range(n)]
    return np.concatenate([join_shares([v[i] for v in per_rank], d, n).reshape(-1).numpy()
                           for i, d in enumerate(tree_leaves(specs))])


def group_train_four_cards(torch, np, smi_line: str):
    """``--nccl`` (g): ``launch/train.run`` of ``GROUP_TRAIN_FULL``
    (starcoder2-7b whole, ``--model-parallel`` MP_FULL_RANKS over NCCL, B 8
    x 512, ``remat="dots"``, 10 steps, warmup 2).  The per-rank train state
    is reckoned and printed first; then a loss that falls and is the same
    on every rank, ms a step and tok/s after ``GROUP_TRAIN_WARM`` steps, the
    share of the cards' summed bf16 peak that the step's matmul FLOPs reach
    (phase 8 (b)'s ``train_matmul_flops``), each rank's peak memory, no
    kernel launched.  Returns the losses and grad norms, for (k)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.sharding.shard import share_bytes

    arch, argv = GROUP_TRAIN_FULL
    n = MP_FULL_RANKS
    cfg = get_config(arch)
    share = share_bytes(cfg, n)
    say(f"training {arch} whole on {n} cards, reckoned before the run: share {share / 1e9:.2f} "
        f"GB a rank; params + gradients + two AdamW moments {4 * share / 1e9:.2f} GB a rank "
        f"(whole: {4 * share_bytes(cfg, 1) / 1e9:.2f} GB)")
    args = train.build_parser().parse_args(["--arch", arch, *argv, "--model-parallel", str(n)])
    t0 = time.perf_counter()
    res = train.run(args, echo=False)
    wall = time.perf_counter() - t0
    steady = res.step_s[GROUP_TRAIN_WARM:]
    step_s = statistics.mean(steady)
    tokens = args.batch * args.seq
    flops = train_matmul_flops(cfg, res.param_counts, args.batch, args.seq)
    row = {"arch": arch, "cut": "none (published config)", "cards": n,
           "params": sum(res.param_counts.values()), "share_bytes": share, "B": args.batch,
           "S": args.seq, "remat": args.remat, "losses": res.losses,
           "grad_norms": res.grad_norms, "ms_per_step": step_s * 1e3,
           "ms_per_step_median": statistics.median(steady) * 1e3, "tok_s": tokens / step_s,
           "matmul_flops_per_step": flops,
           "bf16_peak_share_of_the_cards": flops / step_s / (n * BF16_FLOPS_PER_S),
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res.by_rank],
           "launches_per_rank": [r["launches"] for r in res.by_rank],
           "wall_s_with_init": wall, "card": smi_line}
    say(f"training on a model group of {n} cards: {json.dumps(row)}")
    if any(any(r["launches"].values()) for r in res.by_rank):
        fail(f"training {arch} on {n} cards: kernels launched in training")
    if any(r["losses"] != res.losses for r in res.by_rank):
        fail(f"training {arch} on {n} cards: the ranks' losses differ")
    if not (np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
        fail(f"training {arch} on {n} cards: losses {res.losses} do not fall")
    return res.losses, res.grad_norms


def group_fed_four_cards(torch, np, smi_line: str):
    """``--nccl`` (h): ``launch/federated_llm.run`` of ``FED_LM_FULL`` as
    published, ``GROUP_FED_RUN`` (N 16, a fixed cohort of 8, K 2, B 4 x 64,
    3 rounds), each client a model group of MP_FULL_RANKS cards over NCCL.
    The per-rank planes are reckoned and printed first; then on each rank
    K ``fed_direction`` and one ``server_update`` a round, finite losses,
    the last round's below the first's, ms a round and each rank's peak
    memory.  An out-of-memory error fails the phase: nothing is retried
    smaller.  Returns each round's loss and momentum norm, for (l)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import federated_llm
    from repro_torch.sharding.shard import share_bytes

    cfg = get_config(FED_LM_FULL)
    n = MP_FULL_RANKS
    C, R, K = (GROUP_FED_RUN[k] for k in ("cohort", "rounds", "local_steps"))
    p_r = share_bytes(cfg, n) // 4
    plane = C * p_r * 4
    say(f"federating {FED_LM_FULL} with a cohort of {C} on {n} cards, reckoned before the run: "
        f"P_r = {p_r:,} f32 a rank, a (C, P_r) plane {plane / 1e9:.2f} GB; phase 8 (d)'s one-card "
        f"peak (59.4-60.0 GB) held ~6 planes of that size, so ~{6 * plane / 1e9:.0f} GB a rank")
    t0 = time.perf_counter()
    res = federated_llm.run(cfg, **GROUP_FED_RUN, device="cuda", model_parallel=n)
    wall = time.perf_counter() - t0
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    losses = [r["loss"] for r in res.rounds]
    row = {"arch": FED_LM_FULL, "cut": "none (published config)", "cards": n,
           "params": res.n_params, "share_params": [r["share_params"] for r in res.by_rank],
           **GROUP_FED_RUN, "losses": losses,
           "momentum_norm": [r["momentum_norm"] for r in res.rounds],
           "ms_per_round": res.round_ms,
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res.by_rank],
           "launches_per_rank": [r["launches"] for r in res.by_rank],
           "wall_s_with_init": wall, "card": smi_line}
    say(f"FedCM with each client a model group of {n} cards: {json.dumps(row)}")
    if any(r["launches"] != expected for r in res.by_rank):
        fail(f"FedCM on {n} cards: launches {row['launches_per_rank']}, expected {expected}")
    for r, mine in enumerate(res.by_rank):  # phase D's witness
        DRY_CARD[f"8 (h) rank {r}"] = {"launches": mine["launches"],
                                       "counts": mine["collectives"], "peak": mine["peak_bytes"]}
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"FedCM on {n} cards: losses {losses} do not fall")
    for name, variant, per in GROUP_FED_FULL_VARIANTS:
        group_fed_variant_four_cards(torch, np, smi_line, name, variant, per, res.round_ms)
    return losses, [r["momentum_norm"] for r in res.rounds]


def group_fed_variant_four_cards(torch, np, smi_line: str, name: str, variant: dict, per,
                                 flat_ms):
    """(h)'s run again as ``name``: ``launch/federated_llm.run`` with the
    ``FedConfig`` fields ``variant`` (a fault config as a dict), beside the
    flat round's ms a round ``flat_ms``.  On each rank ``per`` = (launches
    of ``fed_direction`` a local step, of ``server_update`` a round),
    finite losses, the same round metrics on every rank (``run`` raises
    otherwise); ms a round, each rank's peak and the fault counters
    printed."""
    from repro_torch.configs.base import FaultConfig, get_config
    from repro_torch.launch import federated_llm

    cfg = get_config(FED_LM_FULL)
    n = MP_FULL_RANKS
    R, K = GROUP_FED_RUN["rounds"], GROUP_FED_RUN["local_steps"]
    if "fault" in variant:
        variant = {**variant, "fault": FaultConfig(**variant["fault"])}
    t0 = time.perf_counter()
    res = federated_llm.run(cfg, **GROUP_FED_RUN, device="cuda", model_parallel=n,
                            variant=variant)
    wall = time.perf_counter() - t0
    expected = {"fed_direction": R * K * per[0], "server_update": R * per[1],
                "dequant_update": 0, "flash_attention": 0, "ssd_scan": 0}
    losses = [r["loss"] for r in res.rounds]
    row = {"arch": FED_LM_FULL, "variant": name, "cards": n, **GROUP_FED_RUN, "losses": losses,
           "n_dropped": [r["n_dropped"] for r in res.rounds],
           "n_quarantined": [r["n_quarantined"] for r in res.rounds],
           "ms_per_round": res.round_ms, "flat_ms_per_round": flat_ms,
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res.by_rank],
           "launches_per_rank": [r["launches"] for r in res.by_rank],
           "wall_s_with_init": wall, "card": smi_line}
    say(f"FedCM with each client a model group of {n} cards, {name}: {json.dumps(row)}")
    if any(r["launches"] != expected for r in res.by_rank):
        fail(f"FedCM on {n} cards, {name}: launches {row['launches_per_rank']}, expected "
             f"{expected}")
    if not np.isfinite(losses).all():
        fail(f"FedCM on {n} cards, {name}: losses {losses}")


# ------------------------------------------------------ phases 8 (i)-(l), 6c
def grid_digests(torch, cfg, leaves, parallel):
    """Two hashes of a grid rank's tree: of every part its model group
    replicates (equal along a model row iff bitwise equal), and of every
    leaf its data group replicates (equal down a data column)."""
    import hashlib

    from repro_torch.sharding.shard import share_fsdp, share_parts

    row, col = hashlib.sha256(), hashlib.sha256()
    fsdp = share_fsdp(cfg, parallel.size, parallel.data_size)
    for t, (dim, pieces), f in zip(leaves, share_parts(cfg, parallel.size), fsdp):
        for off, width, use in pieces:
            if use != "split":
                seg = t if dim is None else t.narrow(dim, off, width)
                row.update(seg.detach().contiguous().cpu().numpy().tobytes())
        if f is None:
            col.update(t.detach().contiguous().cpu().numpy().tobytes())
    return row.hexdigest(), col.hexdigest()


def grid_cfg(arch, cut):
    """Phase 8 (i)'s config of ``arch``: f32, ``TRAIN_VOCAB``, cut by ``cut``."""
    from repro_torch.configs.base import get_config

    return replace(get_config(arch), dtype="float32", vocab_size=TRAIN_VOCAB, **cut)


def grid_unsharded(torch, work, device):
    """Phase 8 (i)'s reference, once, in the parent: for each arch of
    ``GRID_TRAIN`` two unsharded steps on the card from ``GROUP_SEED``'s
    draw, saved to ``work / "unsharded_<arch>.pt"``: the params and both
    moments after them (leaves in tree order), each step's loss and grad
    norm, and which params were drawn zero."""
    from repro_torch.launch.steps import Knobs, build_train_step
    from repro_torch.utils.trees import tree_leaves

    for arch, cut in GRID_TRAIN:
        step = build_train_step(grid_cfg(arch, cut), Knobs(remat="none", learning_rate=TRAIN_LR))
        gen = torch.Generator(device=device)
        gen.manual_seed(GROUP_SEED)
        params = step.model.init(gen)
        zero = [not bool(t.any()) for t in tree_leaves(params)]
        batch = step.model.dummy_batch(GRID_B, TRAIN_S, device)
        o, metrics = step.opt.init(params), []
        for _ in range(2):
            params, o, m = step.fn(params, o, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        torch.save({"params": tree_leaves(params), "m": tree_leaves(o[1]),
                    "v": tree_leaves(o[2]), "metrics": metrics, "zero": zero},
                   work / f"unsharded_{arch}.pt")
        del params, o, step
    torch.cuda.empty_cache()


def grid_train_case(torch, arch, cut, grids, device, work, snapshot: bool):
    """Phase 8 (i) in one rank of the world: this rank's share on each grid
    of the unsharded params and moments after two steps (``grid_unsharded``,
    read from ``work``); then, on each grid, two steps of this rank's FSDP
    share (``init_params_sharded`` from the same seed) on its data row's
    block of the batch, with the kernels' launch counts set just before and
    read just after, every leaf against the unsharded share.  With
    ``snapshot`` the 2 x 2 run is snapshotted after step 1
    (``save_checkpoint_shares``; each rank also saves its shares for the
    parent to join) and resumed on 1 x 2 (this rank's model row, no data
    group), whose step 2 is held to the straight 2 x 2 step 2 gathered over
    data."""
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint_shares
    from repro_torch.core.engine import synchronize
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.launch.steps import Knobs, build_train_step, make_parallel
    from repro_torch.sharding.rules import _keys
    from repro_torch.sharding.shard import (
        grid_take, init_params_sharded, join_shares, param_shapes, share_fsdp, snapshot_join,
        snapshot_take,
    )
    from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves

    cfg = grid_cfg(arch, cut)
    knobs = Knobs(remat="none", learning_rate=TRAIN_LR)
    rank = dist.get_rank()
    t_start = time.perf_counter()
    keys = [_keys(p) for p, _ in tree_flatten_with_path(param_shapes(cfg))[0]]
    whole = torch.load(work / f"unsharded_{arch}.pt", map_location=device)
    zero, whole_metrics = whole["zero"], whole["metrics"]
    batch = None
    want = {(D, M): {name: [grid_take(t, k, cfg, rank % M, M, rank // M, D)
                            for t, k in zip(whole[name], keys)]
                     for name in ("params", "m", "v")}
            for D, M in GRID_SHAPES}
    del whole
    rows = {"reference_load_s": time.perf_counter() - t_start}
    for D, M in GRID_SHAPES:
        parallel = make_parallel(*grids[(D, M)], cfg=cfg)
        gstep = build_train_step(cfg, knobs, parallel)
        if batch is None:
            batch = gstep.model.dummy_batch(GRID_B, TRAIN_S, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(GROUP_SEED)
        share = init_params_sharded(gen, cfg, parallel.rank, M, data=D,
                                    data_rank=parallel.data_rank)
        n = GRID_B // D
        mine = {k: v[parallel.data_rank * n:(parallel.data_rank + 1) * n]
                for k, v in batch.items()}
        before = launch_counts()
        synchronize(device)
        t0 = time.perf_counter()
        p, o, metrics = share, gstep.opt.init(share), []
        for i in range(2):
            p, o, m = gstep.fn(p, o, mine)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0 and snapshot and (D, M) == (2, 2):
                tree = {"params": p, "opt": o}
                save_checkpoint_shares(str(work / "grid_ckpt"), 1, tree,
                                       snapshot_join(cfg, M, D))
                torch.save(tree, work / f"grid_shares_{rank}.pt")
                snap = o
        s = time.perf_counter() - t0
        launches = launches_since(before)
        worst, bad = {}, []
        for name, tree in (("params", p), ("m", o[1]), ("v", o[2])):
            for i, (a, b, z) in enumerate(zip(tree_leaves(tree), want[(D, M)][name], zero)):
                limit = UPDATE_REL_L2 if name == "params" and z else F32_REL_L2
                rel = rel_l2(torch, a, b)
                key = f"{name} {'from 0' if name == 'params' and z else ''}".strip()
                worst[key] = max(worst.get(key, 0.0), rel)
                if not (rel <= limit and bool(torch.isfinite(a).all())):
                    bad.append((name, i, rel, limit))
        row = {"metrics": metrics, "unsharded_metrics": whole_metrics, "max_rel_l2": worst,
               "bad": bad, "launches": launches, "s_2_steps": s, "s_with_checks": 0.0,
               "digests": [grid_digests(torch, cfg, tree_leaves(t), parallel)
                           for t in (p, o[1], o[2])]}
        if snapshot and (D, M) == (2, 2):
            # resume the step-1 snapshot on 1 x 2: this rank's model row alone
            row_par = make_parallel(grids[(D, M)][0])
            rstep = build_train_step(cfg, knobs, row_par)
            gen.manual_seed(GROUP_SEED)
            tmpl = init_params_sharded(gen, cfg, row_par.rank, M)
            tree, _ = load_checkpoint(str(work / "grid_ckpt"), 1,
                                      {"params": tmpl, "opt": rstep.opt.init(tmpl)},
                                      snapshot_take(cfg, row_par.rank, M))
            rp, ro, rm = rstep.fn(tree["params"], tree["opt"], batch)
            fsdp = share_fsdp(cfg, M, D)
            worst_resume = 0.0
            for name, a_tree, b_tree in (("params", rp, p), ("m", ro[1], o[1]),
                                         ("v", ro[2], o[2])):
                for a, b, f in zip(tree_leaves(a_tree), tree_leaves(b_tree), fsdp):
                    parts = [torch.empty_like(b) for _ in range(D)]
                    dist.all_gather(parts, b.contiguous(), group=parallel.data_group)
                    whole = join_shares(parts, None, 1, f, D)
                    worst_resume = max(worst_resume, rel_l2(torch, a, whole))
            row.update(resume_1x2_max_rel_l2=worst_resume,
                       resume_metrics=(float(rm["loss"]), float(rm["grad_norm"])),
                       snapshot_step=int(snap[0]))
        row["s_with_checks"] = time.perf_counter() - t0
        rows[f"{D}x{M}"] = row
    return rows


def grid_serve_case(torch, parallel, device, work):
    """Phase 6c in one rank of a model group of 2 (the grid's first model
    row): ``serve.run`` of ``GRID_SERVE_ARGS`` on version 1 published in
    ``work / "pub_group"``, rank 0 publishing version 2 there after decode
    step ``GRID_PUBLISH_AFTER``; the kernels' launch counts set just before
    and read just after.  Returns the tokens, the swap steps, the versions
    swapped in and the launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.fleet.publisher import ModelPublisher
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.launch import serve

    cfg = replace(get_config("llama3.2-1b"), **GRID_SERVE_CUT)
    args = serve.build_parser().parse_args(
        [*GRID_SERVE_ARGS, "--ckpt", str(work / "pub_group"), "--device", str(device)])
    publish = (lambda stats: None)
    if parallel.rank == 0:
        pub = ModelPublisher(str(work / "pub_group"), retain=2)
        gen = torch.Generator(device=device)
        gen.manual_seed(12)
        later = serve.build_model(cfg).init(gen)

        def publish(stats):
            if stats.steps == GRID_PUBLISH_AFTER:
                pub.publish(later, step=2)

    before = launch_counts()
    res = serve.run(args, on_step=publish, cfg=cfg, parallel=parallel)
    return {"tokens": res.tokens, "swap_steps": list(res.stats.swap_steps),
            "versions": list(res.stats.versions), "launches": launches_since(before),
            "prefill_ms": [t * 1e3 for t in res.prefill_s]}


def serve_grid_cfg(arch, cut):
    """Phase 6d's config of ``arch``: bf16 weights, ``TRAIN_VOCAB``, cut by ``cut``."""
    from repro_torch.configs.base import get_config

    return replace(get_config(arch), **{"param_dtype": "bfloat16", "vocab_size": TRAIN_VOCAB,
                                        **cut})


def serve_grid_drive(torch, model, params, toks, prompt: int, steps: int, cache_len: int,
                     batch: int, parallel=None):
    """A session of phase 6d: prefill ``toks[:, :prompt]`` into a cache of
    ``cache_len`` positions (``batch``: the served batch, the rows of
    ``toks`` unsharded) and decode ``steps`` tokens fed the next ones of
    ``toks``.  Returns the last position's logits of the prefill and of each
    step and the cache leaves after the prefill and after the last step
    (f32 numpy, with the last key of each leaf's path), and for each step
    whether the first attention K leaf changed and the ``all_reduce``s of
    the data group."""
    from repro_torch.launch.serve import merge_prefill
    from repro_torch.sharding.rules import _keys
    from repro_torch.utils.trees import tree_flatten_with_path

    def leaves(cache):
        return [(_keys(p)[-1], x.float().cpu().numpy())
                for p, x in tree_flatten_with_path(cache)[0]]

    t = torch.as_tensor(toks, device=params["embed"].device)
    logits, pre, _ = model.apply(params, t[:, :prompt], return_cache=True, parallel=parallel)
    cache = merge_prefill(model.init_cache(params, batch, cache_len, parallel), pre, parallel)
    del pre
    out = {"logits": [logits[:, -1].float().cpu().numpy()], "written": [], "combines": [],
           "cache_prefill": leaves(cache)}
    first_k = next((x for p, x in tree_flatten_with_path(cache)[0] if _keys(p)[-1] == "k"), None)
    for i in range(prompt, prompt + steps):
        before = None if first_k is None else first_k.clone()
        n0 = 0 if parallel is None else parallel.counts["data_all_reduce"]
        lg, cache = model.decode_step(params, t[:, i:i + 1], cache, i, parallel)
        out["logits"].append(lg[:, -1].float().cpu().numpy())
        out["written"].append(None if first_k is None else bool((first_k != before).any()))
        out["combines"].append(0 if parallel is None else parallel.counts["data_all_reduce"] - n0)
    out["cache"] = leaves(cache)
    return out


def serve_grid_blocks(batch: int):
    """The row blocks ``(lo, n)`` phase 6d's oracles serve: the whole batch
    where no grid of ``GRID_SHAPES`` splits it, else each data row's block
    on each grid."""
    blocks = {(0, batch)}
    for D, _ in GRID_SHAPES:
        if batch % D == 0:
            blocks |= {(d * batch // D, batch // D) for d in range(D)}
    return sorted(blocks)


def serve_grid_unsharded(torch, np, work, device):
    """Phase 6d's oracles, once, in the parent: for each case of
    ``GRID_SERVE`` and each of its runs the unsharded model on the card
    (``GRID_SERVE_SEED``'s draw) serving each row block of
    ``serve_grid_blocks`` alone (a MoE routes each block at its own
    capacity), saved to ``work / "serve_<name>_B<B>_<lo>_<n>.pt"``."""
    from repro_torch.models.model import build_model

    for name, arch, cut, runs in GRID_SERVE:
        cfg = serve_grid_cfg(arch, cut)
        model = build_model(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(GRID_SERVE_SEED)
        params = model.init(gen)
        for B, prompt, cache_len, steps, _ in runs:
            toks = np.random.default_rng(GRID_SERVE_SEED).integers(0, cfg.vocab_size,
                                                                   size=(B, prompt + steps))
            for lo, n in serve_grid_blocks(B):
                got = serve_grid_drive(torch, model, params, toks[lo:lo + n], prompt, steps,
                                       cache_len, n)
                torch.save(got, work / f"serve_{name}_B{B}_{lo}_{n}.pt")
        del params
    torch.cuda.empty_cache()


def serve_grid_case(torch, grids, device, work):
    """Phase 6d in one rank of the grid world: for each case of
    ``GRID_SERVE``, its whole draw on the card (``GRID_SERVE_SEED``) and, on
    each grid and layout of its runs, this rank's share of it
    (``grid_take``, the ``serve_params`` layout) served by
    ``serve_grid_drive`` on the grid's serving context, with the kernels'
    launch counts read just before and just after.  Each run against its
    oracle (``serve_grid_unsharded``, read from ``work``): the relative L2
    of every step's logits, and of each cache leaf after the prefill and
    after the last step against its part of the oracle's (the rank's kv or
    SSD heads, then its slab where the sequence splits).  Returns those, a
    digest of the logits, the written flags and data-group ``all_reduce``s
    of each step, the launches and the share's bytes."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.launch.steps import Knobs, make_parallel, param_mode
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import _keys, row_block, seq_slab
    from repro_torch.sharding.shard import grid_take, param_shapes
    from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten

    rank = dist.get_rank()
    rows = []
    for name, arch, cut, runs in GRID_SERVE:
        cfg = serve_grid_cfg(arch, cut)
        model = build_model(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(GRID_SERVE_SEED)
        whole = tree_flatten_with_path(model.init(gen))
        keys = [_keys(p) for p, _ in tree_flatten_with_path(param_shapes(cfg))[0]]
        for B, prompt, cache_len, steps, layouts in runs:
            toks = np.random.default_rng(GRID_SERVE_SEED).integers(0, cfg.vocab_size,
                                                                   size=(B, prompt + steps))
            for (D, M), modes in layouts.items():
                m, d = rank % M, rank // M
                for serve_params in modes:
                    knobs = Knobs(serve_params=serve_params)
                    mode = param_mode(knobs)
                    parallel = make_parallel(*grids[(D, M)], cfg=cfg, knobs=knobs, batch=B)
                    share = tree_unflatten(whole[1], [grid_take(t, k, cfg, m, M, d, D, mode=mode)
                                                      for (_, t), k in zip(whole[0], keys)])
                    lo, n = row_block(B, D, d) if not parallel.seq_split else (0, B)
                    before = launch_counts()
                    got = serve_grid_drive(torch, model, share, toks[lo:lo + n], prompt, steps,
                                           cache_len, B, parallel)
                    launches = launches_since(before)
                    want = torch.load(work / f"serve_{name}_B{B}_{lo}_{n}.pt", weights_only=False)
                    logit_rel = [rel_l2_host(torch, a, b)
                                 for a, b in zip(got["logits"], want["logits"])]
                    cache_rel = {}
                    for when in ("cache_prefill", "cache"):
                        for (key, a), (_, b) in zip(got[when], want[when]):
                            part = mp_cache_part(np, key, b, cfg, m, M)
                            if parallel.seq_split and key in ("k", "v"):
                                s0, sn = seq_slab(cache_len, D, d)
                                part = part[:, :, s0:s0 + sn]
                            if a.shape != part.shape:
                                cache_rel[f"{when} {key}"] = float("inf")
                                continue
                            rel = rel_l2_host(torch, a, part) if np.abs(part).max() else \
                                float(np.abs(a).max())
                            cache_rel[f"{when} {key}"] = max(cache_rel.get(f"{when} {key}", 0.0),
                                                             rel)
                    rows.append({
                        "case": name, "B": B, "grid": [D, M], "serve_params": serve_params,
                        "seq_split": parallel.seq_split, "rows": [lo, n],
                        "logits_max_rel_l2": max(logit_rel), "cache_max_rel_l2": cache_rel,
                        "digest": hashlib.sha1(b"".join(x.tobytes() for x in got["logits"]))
                        .hexdigest(), "written": got["written"], "combines": got["combines"],
                        "launches": {k: launches[k] for k in ("flash_attention", "ssd_scan")},
                        "other_launches": sum(v for k, v in launches.items()
                                              if k not in ("flash_attention", "ssd_scan")),
                        "data_all_gather": parallel.counts["data_all_gather"],
                        "share_bytes": sum(t.numel() * t.element_size()
                                           for t in tree_leaves_of(share)),
                        "finite": all(np.isfinite(x).all() for x in got["logits"])})
                    del share, got
        del whole
        torch.cuda.empty_cache()
    return rows


def tree_leaves_of(tree):
    from repro_torch.utils.trees import tree_leaves

    return tree_leaves(tree)


def serve_grid_checks(np, ranks, smi_line: str) -> dict:
    """Phase 6d's bounds over the world's results (each rank's list of
    ``serve_grid_case`` rows, in the same order): every step's logits and
    every cache leaf within ``LM_REL_L2`` of the oracle (``F32_REL_L2`` in
    f32); the logits byte for
    byte equal on the ranks that serve the same rows (a model row, or the
    world where the sequence splits); where the sequence splits the token
    written on exactly the data rank whose slab holds its position and
    three ``all_reduce``s over the data group an attention application a
    step, elsewhere none; a prefill's flash / SSD launches on each rank,
    and no other kernel; no data-group gather of a leaf outside ``moe`` in
    the replicated layout.  Returns the launches by path."""
    from repro_torch.models.transformer import period_layout
    from repro_torch.sharding.rules import seq_slab

    by_path = {}
    for i, first in enumerate(ranks[0]):
        rows = [r[i] for r in ranks]
        D, M = first["grid"]
        _, arch, cut, runs = next(c for c in GRID_SERVE if c[0] == first["case"])
        cfg = serve_grid_cfg(arch, cut)
        limit = F32_REL_L2 if cfg.dtype == "float32" else LM_REL_L2
        slots, n_periods, tail = period_layout(cfg)
        n_attn = [s.kind for s in slots].count("attn") * n_periods
        B, prompt, cache_len, steps, _ = next(r for r in runs if r[0] == first["B"])
        expected = mp_expected_launches(cfg)
        what = f"{first['case']} B {first['B']} on {D} x {M} ({first['serve_params']})"
        for r, got in enumerate(rows):
            same = rows[0] if first["seq_split"] else rows[r - r % M]
            if not (got["finite"] and got["logits_max_rel_l2"] <= limit
                    and max(got["cache_max_rel_l2"].values()) <= limit):
                fail(f"serving on a grid, {what}: rank {r}: {json.dumps(got)}")
            if got["digest"] != same["digest"]:
                fail(f"serving on a grid, {what}: rank {r}'s logits differ from its row's")
            if got["launches"] != expected or got["other_launches"]:
                fail(f"serving on a grid, {what}: rank {r} launched {got['launches']} "
                     f"(+{got['other_launches']} others), expected {expected}")
            if got["combines"] != [3 * n_attn if got["seq_split"] else 0] * steps:
                fail(f"serving on a grid, {what}: rank {r}'s data-group all_reduces a step "
                     f"{got['combines']}")
            if got["serve_params"] == "replicated" and not cfg.n_experts and got["data_all_gather"]:
                fail(f"serving on a grid, {what}: rank {r} gathered over data in the replicated "
                     f"layout")
        for s in range(steps):
            for m in range(M):
                writers = [d for d in range(D) if rows[d * M + m]["written"][s]]
                want = ([(prompt + s) // seq_slab(cache_len, D, 0)[1]] if first["seq_split"]
                        else list(range(D)))
                if n_attn and writers != want:
                    fail(f"serving on a grid, {what}: step {s} written on data ranks {writers}, "
                         f"expected {want}")
        say(f"serving on a grid ({GRID_RANKS} gloo ranks sharing cuda:0), phase 6d: " + json.dumps({
            "case": first["case"], "cut": cut, "B": B,
            "prompt": prompt, "cache": cache_len, "steps": steps, "grid": [D, M],
            "serve_params": first["serve_params"], "split": "sequence" if first["seq_split"]
            else "batch", "logits_max_rel_l2": max(g["logits_max_rel_l2"] for g in rows),
            "cache_max_rel_l2": max(max(g["cache_max_rel_l2"].values()) for g in rows),
            "limit": limit, "launches_per_rank": [g["launches"] for g in rows],
            "data_all_reduce_a_step": first["combines"][0],
            "data_all_gather_rank0": first["data_all_gather"],
            "share_bytes_per_rank": [g["share_bytes"] for g in rows]}) + f"; {smi_line}")
        for r, got in enumerate(rows):
            key = f"serve_grid_{D}x{M}_rank{r}"
            for k, v in got["launches"].items():
                by_path.setdefault(k, {}).setdefault(key, 0)
                by_path[k][key] += v
    return by_path


def serve_grid_rank(rank, device, argv, D, M, serve_params, cut, feed, keep_logits):
    """A rank of phases (m) and (n): ``serve.run`` of ``argv`` on a ``D`` ×
    ``M`` grid (``serve.grid_context``; the model group at D = 1) in the
    ``serve_params`` layout, its config cut by ``cut``, fed ``feed`` (the
    reference layout's tokens) when given; the flash and SSD launch counts
    and the peak memory reset just before and read just after, the cache's
    bytes on this rank, the data group's collectives, and with
    ``keep_logits`` rank 0's sampled-from logits of every step."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = serve.build_parser().parse_args([*argv, "--data-parallel", str(D), "--model-parallel",
                                            str(M), "--serve-params", serve_params])
    args.device = str(device)
    cfg = replace(get_config(args.arch), **cut)
    parallel = serve.grid_context(args, cfg)
    shaped = serve.with_shape(args)
    cache_len = shaped.cache_len or shaped.prompt_len + shaped.gen
    meta = transformer.init_cache(cfg, shaped.batch, cache_len, device="meta", parallel=parallel)
    logits = {}

    def on_logits(s, i, lg):
        if keep_logits and rank == 0:
            logits[(s, i)] = lg.cpu().numpy()

    torch.cuda.reset_peak_memory_stats(device)
    fa_kernel.KERNEL.launches = 0
    ssd_kernel.KERNEL.launches = 0
    t0 = time.perf_counter()
    res = serve.run(args, cfg=cfg, parallel=parallel, on_logits=on_logits, feed=feed)
    torch.cuda.synchronize(device)
    return {"wall_s": time.perf_counter() - t0,
            "launches": {"flash_attention": fa_kernel.KERNEL.launches,
                         "ssd_scan": ssd_kernel.KERNEL.launches},
            "peak_bytes": torch.cuda.max_memory_allocated(device), "tokens": res.tokens,
            "finite": res.finite, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "cache_bytes": sum(t.numel() * t.element_size() for t in tree_leaves_of(meta)),
            "counts": dict(parallel.counts), "seq_split": parallel.seq_split,
            "logits": logits}


def serve_share_gb(arch, cut, data: int, model: int) -> float:
    """A rank's share of ``arch`` cut by ``cut`` in GB: on ``model`` ranks,
    or on a ``data`` × ``model`` grid in the serve layout."""
    from repro_torch.configs.base import get_config
    from repro_torch.sharding.shard import share_bytes

    return share_bytes(replace(get_config(arch), **cut), model, data, "serve") / 1e9


def serve_grid_layouts(torch, np, smi_line: str, argv, layouts, cut, *, device="cuda",
                       backend="nccl", name="long context", reference=None,
                       limit=LM_REL_L2):
    """Phases (m) and (n): ``argv`` served by ``serve_grid_rank`` on each
    ``(D, M, serve_params)`` of ``layouts`` in turn, a world of four ranks
    each (``backend``: NCCL, one card a rank; gloo ranks sharing cuda:0 in
    ``--grid-only``'s witness and rehearsal).  The first layout (or
    ``reference``, an earlier run's rank-0 result) is the reference: the
    others are fed its tokens, and every step's logits of rank 0 are held to
    its, within ``limit`` relative L2 (None: reported, not gated).  Gated on
    every layout: finite logits, the tokens equal on the ranks that serve
    the same rows, a prefill's flash / SSD launches on each rank, where the
    sequence splits three data-group ``all_reduce``s an attention
    application a decode step, and a peak under ``CARD_BYTES`` a rank.
    Returns the launches by path and each layout's rank-0 result."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import spawn_cohort
    from repro_torch.models.transformer import period_layout

    args = serve.with_shape(serve.build_parser().parse_args(argv))
    cfg = replace(get_config(args.arch), **cut)
    slots, n_periods, tail = period_layout(cfg)
    n_attn = [s.kind for s in slots].count("attn") * n_periods
    expected = {k: v * args.sessions for k, v in mp_expected_launches(cfg).items()}
    decode_steps = args.sessions * (args.gen - 1)
    by_path, firsts = {}, []
    for D, M, serve_params in layouts:
        t0 = time.perf_counter()
        ranks = spawn_cohort(serve_grid_rank, D * M, args=(
            argv, D, M, serve_params, cut, None if reference is None else reference["tokens"],
            True), device=device, backend=backend, timeout_s=900.0, deadline_s=1500.0)
        wall = time.perf_counter() - t0
        first = ranks[0]
        what = f"{name} {cfg.name} on {D} x {M} ({serve_params})"
        for r, got in enumerate(ranks):
            same = ranks[0] if (got["seq_split"] or D == 1) else ranks[r - r % M]
            if not got["finite"] or not np.array_equal(got["tokens"], same["tokens"]):
                fail(f"{what}: rank {r}'s logits non-finite or its tokens differ from its row's")
            if got["launches"] != expected:
                fail(f"{what}: rank {r} launched {got['launches']}, expected {expected}")
            combines = got["counts"]["data_all_reduce"]
            if combines != (3 * n_attn * decode_steps if got["seq_split"] else 0):
                fail(f"{what}: rank {r} ran {combines} data-group all_reduces over "
                     f"{decode_steps} decode steps")
            if got["peak_bytes"] >= CARD_BYTES:
                fail(f"{what}: rank {r}'s peak {got['peak_bytes']} B")
        rels = None if reference is None else logit_gaps(torch, first, reference)
        if rels is not None:
            if limit is not None and not max(rels) <= limit:
                DEFERRED.append(f"{what}: logits against the reference layout's, relative L2 "
                                f"{rels}")
        row = {"layout": [D, M], "serve_params": serve_params, "B": args.batch,
               "cache_len": args.cache_len or args.prompt_len + args.gen,
               "prompt": args.prompt_len, "gen": args.gen,
               "split": "sequence" if first["seq_split"] else ("batch" if D > 1 else "none"),
               "prefill_ms": [[g["prefill_s"][s] * 1e3 for s in range(args.sessions)]
                              for g in ranks],
               "decode_ms_a_step": [[g["decode_s"][s] * 1e3 / (args.gen - 1)
                                     for s in range(args.sessions)] for g in ranks],
               "peak_gb_per_rank": [g["peak_bytes"] / 1e9 for g in ranks],
               "cache_gb_per_rank": [g["cache_bytes"] / 1e9 for g in ranks],
               "launches_per_rank": [g["launches"] for g in ranks],
               "data_all_reduce_a_step": first["counts"]["data_all_reduce"] / decode_steps,
               "data_all_gather_a_forward": first["counts"]["data_all_gather"] / (
                   decode_steps + args.sessions),
               "max_rel_l2_vs_reference": None if rels is None else max(rels),
               "rel_l2_limit": limit, "wall_s": wall}
        say(f"{name}: {json.dumps(row)}; {smi_line}")
        if reference is None:
            reference = first
        firsts.append(first)
        for r, got in enumerate(ranks):
            by_path[f"{name.replace(' ', '_')}_{D}x{M}_rank{r}"] = got["launches"]
    return by_path, firsts


def logit_gaps(torch, got, want) -> list:
    """The relative L2 of each step's rank-0 logits of ``got`` against
    ``want``'s (two ``serve_grid_rank`` results fed the same tokens)."""
    return [rel_l2_host(torch, got["logits"][k], want["logits"][k][:len(got["logits"][k])])
            for k in sorted(got["logits"])]


def long_context_witness(torch, np, smi_line: str):
    """``--grid-only``'s witness of (m)'s gate, on 4 gloo ranks sharing
    cuda:0: ``WITNESS_ARGS`` served by ``serve_grid_layouts`` on each layout
    of ``LONG_LAYOUTS``, first with f32 activations (the 1 x 4 group the
    reference, the grids within ``F32_REL_L2`` of it at every step), then
    in bf16 as (m) serves it, each layout against that f32 run (reported)
    and the grids against the bf16 1 x 4 group, within ``LONG_REL_L2``."""
    _, f32 = serve_grid_layouts(torch, np, smi_line, WITNESS_ARGS, LONG_LAYOUTS,
                                {**WITNESS_CUT, "dtype": "float32"}, backend="gloo",
                                name="long context witness f32", limit=F32_REL_L2)
    _, bf16 = serve_grid_layouts(torch, np, smi_line, WITNESS_ARGS, LONG_LAYOUTS, WITNESS_CUT,
                                 backend="gloo", name="long context witness bf16",
                                 reference=f32[0], limit=None)
    row = {}
    for (D, M, _), got in zip(LONG_LAYOUTS, bf16):
        row[f"{D}x{M}"] = {"bf16_vs_f32_1x4": max(logit_gaps(torch, got, f32[0])),
                           "bf16_vs_bf16_1x4": max(logit_gaps(torch, got, bf16[0]))}
    say(f"long context witness ({WITNESS_CUT['n_layers']} layers, relative L2 of the logits, "
        f"the largest over the steps): {json.dumps(row)}; limit {LONG_REL_L2}; {smi_line}")
    if not max(r["bf16_vs_bf16_1x4"] for r in row.values()) <= LONG_REL_L2:
        fail(f"long context witness: a bf16 grid past LONG_REL_L2 of the bf16 1 x 4 group: "
             f"{json.dumps(row)}")


def plane_digest(a) -> str:
    """A hash of a numpy plane's bytes."""
    import hashlib

    return hashlib.sha256(a.tobytes()).hexdigest()


def grid_rank(rank, device, draws, work):
    """A rank of phases 8 (i), (j), 6c and 6d on one card."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_grid
    from repro_torch.launch.steps import make_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps, t0 = {}, time.perf_counter()
    grids = {shape: make_grid(*shape) for shape in GRID_SHAPES}
    train = []
    for arch, cut in GRID_TRAIN:
        train.append(grid_train_case(torch, arch, cut, grids, device, work,
                                     arch == GRID_SNAPSHOT))
        laps[arch] = time.perf_counter() - t0 - sum(laps.values())
    torch.cuda.empty_cache()
    model_group, data_group = grids[(2, 2)]
    fed = group_fed_case(torch, make_parallel(model_group), device, draws, data_group)
    if dist.get_rank(data_group):  # data rank 0's planes come back; the others' digests
        fed.update({k: plane_digest(fed[k]) for k in ("params", "momentum")})
    laps["fed"] = time.perf_counter() - t0 - sum(laps.values())
    torch.cuda.empty_cache()
    served = grid_serve_case(torch, make_parallel(model_group), device, work) if rank < 2 \
        else None
    dist.barrier()
    laps["serve"] = time.perf_counter() - t0 - sum(laps.values())
    torch.cuda.empty_cache()
    serve_grid = serve_grid_case(torch, grids, device, work)
    laps["serve_grid"] = time.perf_counter() - t0 - sum(laps.values())
    return {"train": train, "fed": fed, "serve": served, "serve_grid": serve_grid, "laps_s": laps}


def group_world_one_card(torch, body, n: int, args, device):
    """``body``'s world of ``n`` gloo ranks sharing ``device``: the ranks'
    results and the world's wall seconds."""
    from repro_torch.launch.mesh import spawn_cohort

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_cohort(body, n, args=args, device=device, backend="gloo", timeout_s=600.0,
                         deadline_s=900.0)
    return ranks, time.perf_counter() - t0


def grid_setup(torch, np, device="cuda"):
    """The work directory of phases 8 (i), (j), 6c and 6d, with version 1 of
    6c's model published in two directories (the group's and the unsharded
    server's), 8 (i)'s unsharded steps (``grid_unsharded``) and 6d's
    oracles (``serve_grid_unsharded``); ``grid_rank``'s arguments."""
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch.fleet.publisher import ModelPublisher
    from repro_torch.models.model import build_model

    work = ROOT / "build" / "smoke_grid"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    first = build_model(replace(get_config("llama3.2-1b"), **GRID_SERVE_CUT)).init(gen)
    for name in ("pub_group", "pub_plain"):
        ModelPublisher(str(work / name), retain=2).publish(first, step=1)
    del first
    grid_unsharded(torch, work, device)
    serve_grid_unsharded(torch, np, work, device)
    return fed_lm_draws(np)[2], work


def both_group_worlds_one_card(torch, np, smi_line: str, device="cuda"):
    """Phases 8 (e)–(f) and 8 (i), (j), 6c, 6d: their two worlds of gloo
    ranks sharing cuda:0 run at once (2 and 4 ranks), then each phase's
    checks.  Returns the launches by path of (f) and (j), and of 6c and 6d
    by kernel."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    grid_args = grid_setup(torch, np, device)
    with ThreadPoolExecutor(2) as pool:
        group = pool.submit(group_world_one_card, torch, group_rank, GROUP_RANKS,
                            (fed_lm_draws(np)[2],), device)
        grid = pool.submit(group_world_one_card, torch, grid_rank, GRID_RANKS, grid_args,
                           device)
        group, grid = group.result(), grid.result()
    say(f"phases 8 (e)-(f) and 8 (i)-(j), 6c, 6d: their worlds at once in "
        f"{time.perf_counter() - t0:.1f} s (the worlds {group[1]:.1f} / {grid[1]:.1f} s)")
    by_path = model_group_training_one_card(torch, np, smi_line, device, world=group)
    grid_fed, grid_serve = grid_one_card(torch, np, smi_line, device, world=grid,
                                         work=grid_args[1])
    return {**by_path, **grid_fed}, grid_serve


def grid_one_card(torch, np, smi_line: str, device="cuda", world=None, work=None):
    """Phases 8 (i), (j) and 6c: one world of ``GRID_RANKS`` gloo ranks
    sharing cuda:0 (``grid_rank``).  (i): on each grid of ``GRID_SHAPES``
    each rank's FSDP share and both moments after two steps within
    ``F32_REL_L2`` of the unsharded share (a leaf from 0 within
    ``UPDATE_REL_L2``), the model-replicated parts bitwise equal along each
    row and the data-replicated leaves down each column, one loss and one
    grad norm, no kernel launched; the 2 x 2 snapshot after step 1 byte for
    byte the file joined here from the ranks' shares, and its 1 x 2 resume's
    step 2 within ``F32_REL_L2`` of the straight 2 x 2 step 2.  (j): the 2 x
    2 grid's FedCM rounds against the unsharded card round (data rank 0's
    planes joined; params within ``PARITY_RTOL`` / ``PARITY_ATOL``, momentum
    and each round's loss within ``F32_REL_L2``), every data rank's planes
    bitwise data rank 0's, the draws equal on all four ranks, on each rank
    K ``fed_direction`` launches a round on its ``(C_loc, P_r)`` plane and
    one ``server_update`` on its column block.  6c: both ranks swap to
    version 2 at the same step as the unsharded server, with its tokens,
    and launch ``flash_attention`` in their prefill.  6d: serving on both
    grids against the unsharded model (``serve_grid_checks``).  ``world``
    is the world's ranks' results and wall seconds when the caller ran it on
    ``work`` (``grid_setup``).  Returns the launches by path of (j), and of
    6c and 6d by kernel."""
    import shutil

    from repro_torch.checkpoint.ckpt import _map_with_paths, flatten_with_paths, save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.fleet.publisher import ModelPublisher
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.launch import serve
    from repro_torch.sharding.shard import snapshot_join

    t0 = time.perf_counter()
    arch, cut = FED_LM_VS_CPU
    fcfg, toks, draws = fed_lm_draws(np)
    B, S = FED_LM_VS_CPU_BATCH
    n_cl, C, K, R = (FED_LM_RUN[k] for k in ("n_clients", "cohort", "local_steps", "rounds"))
    scfg = replace(get_config("llama3.2-1b"), **GRID_SERVE_CUT)
    if world is None:
        draws, work = grid_setup(torch, np, device)
        world = group_world_one_card(torch, grid_rank, GRID_RANKS, (draws, work), device)
    ranks, wall = world
    laps = {arch: {k: v if isinstance(v, float) else v["s_with_checks"] for k, v in t.items()}
            for (arch, _), t in zip(GRID_TRAIN, ranks[0]["train"])}
    say(f"phases 8 (i), 8 (j), 6c, 6d: the world {wall:.1f} s; rank 0's laps "
        f"{json.dumps(ranks[0]['laps_s'])}; of each arch's, reading the unsharded steps and each "
        f"grid's steps with their checks {json.dumps(laps)}")
    # (i)
    for i, (arch_i, cut_i) in enumerate(GRID_TRAIN):
        for D, M in GRID_SHAPES:
            rows = [got["train"][i][f"{D}x{M}"] for got in ranks]
            first = rows[0]
            for r, got in enumerate(rows):
                if got["bad"] or any(got["launches"].values()):
                    fail(f"training on a {D} x {M} grid, {arch_i}: rank {r}: leaves beyond "
                         f"their bound {got['bad'][:5]}, launches {got['launches']}")
                row_first, col_first = rows[r - r % M], rows[r % M]
                if (any(a[0] != b[0] for a, b in zip(got["digests"], row_first["digests"]))
                        or any(a[1] != b[1] for a, b in zip(got["digests"],
                                                             col_first["digests"]))
                        or got["metrics"] != first["metrics"]):
                    fail(f"training on a {D} x {M} grid, {arch_i}: rank {r}'s replicated "
                         f"parts or loss / grad norm differ")
            worst_metric = max(abs(a - b) / max(abs(b), 1e-30)
                               for got, want in zip(first["metrics"], first["unsharded_metrics"])
                               for a, b in zip(got, want))
            if not (np.isfinite(first["metrics"]).all() and worst_metric <= F32_REL_L2):
                fail(f"training on a {D} x {M} grid, {arch_i}: metrics {first['metrics']} "
                     f"against {first['unsharded_metrics']}")
            row = {"arch": arch_i, "grid": [D, M], "cut": dict(cut_i, vocab_size=TRAIN_VOCAB),
                   "B": GRID_B, "S": TRAIN_S, "losses": [m[0] for m in first["metrics"]],
                   "loss_grad_norm_max_rel": worst_metric,
                   "max_rel_l2_per_rank": [got["max_rel_l2"] for got in rows],
                   "limits": [F32_REL_L2, UPDATE_REL_L2],
                   "launches_per_rank": [got["launches"] for got in rows],
                   "s_2_steps_per_rank": [got["s_2_steps"] for got in rows]}
            if "resume_1x2_max_rel_l2" in first:
                row["resume_1x2_max_rel_l2_per_rank"] = [got["resume_1x2_max_rel_l2"]
                                                         for got in rows]
                if max(row["resume_1x2_max_rel_l2_per_rank"]) > F32_REL_L2:
                    fail(f"the 2 x 2 snapshot resumed on 1 x 2: {json.dumps(row)}")
            say(f"training on a grid ({GRID_RANKS} gloo ranks sharing cuda:0): "
                f"{json.dumps(row)}")
    shares = [torch.load(work / f"grid_shares_{r}.pt") for r in range(GRID_RANKS)]
    join = snapshot_join(grid_cfg(GRID_SNAPSHOT, dict(GRID_TRAIN)[GRID_SNAPSHOT]), 2, 2)
    per_path = {}
    for tree in shares:
        for path, leaf in flatten_with_paths(tree):
            per_path.setdefault(path, []).append(leaf)
    save_checkpoint(str(work / "joined"), 1, _map_with_paths(
        lambda path, leaf: join(path, per_path[path]), shares[0]))
    snap = work / "grid_ckpt" / "step_1.msgpack"
    same = (work / "joined" / "step_1.msgpack").read_bytes() == snap.read_bytes()
    say(f"the 2 x 2 grid's step-1 snapshot ({snap.stat().st_size:,} bytes) is byte for byte "
        f"the file joined from its ranks' shares: {same}")
    if not same:
        fail("the grid's snapshot differs from the file joined from its ranks' shares")
    del shares, per_path
    t_join = time.perf_counter() - t0
    # (j)
    want, losses = fed_lm_unsharded_on_card(torch, fcfg, draws, toks, device)
    fed_rows = [r["fed"] for r in ranks]
    got = {k: joined_fed_planes(torch, np, fcfg, [f[k] for f in fed_rows[:2]], 2)
           for k in ("params", "momentum")}
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    p_diff = float(np.max(np.abs(got["params"] - want["params"])))
    m_rel = rel_l2_host(torch, got["momentum"], want["momentum"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fed_rows[0]["losses"], losses))
    replicated = all(fed_rows[r][k] == plane_digest(fed_rows[r % 2][k])
                     for r in range(2, GRID_RANKS) for k in ("params", "momentum"))
    row = {"arch": arch, "cut": cut, "grid": [2, 2],
           "share_params": [f["share_params"] for f in fed_rows], "N": n_cl, "cohort": C,
           "K": K, "B": B, "S": S, "rounds": R, "losses": fed_rows[0]["losses"],
           "loss_max_rel": loss_rel, "params_max_abs_diff": p_diff, "momentum_rel_l2": m_rel,
           "data_ranks_bitwise": replicated,
           "launches_per_rank": [f["launches"] for f in fed_rows],
           "draws_equal": len({f["draws_digest"] for f in fed_rows}) == 1,
           "drawn_round_loss_per_rank": [f["drawn_round_loss"] for f in fed_rows],
           "peak_bytes_per_rank": [f["peak_bytes"] for f in fed_rows], "card": smi_line,
           "limits": {"params": [PARITY_RTOL, PARITY_ATOL], "momentum": F32_REL_L2}}
    say(f"FedCM on a 2 x 2 grid ({GRID_RANKS} gloo ranks sharing cuda:0) vs the unsharded card "
        f"round: {json.dumps(row)}")
    if not (row["draws_equal"] and len(set(row["drawn_round_loss_per_rank"])) == 1):
        fail("FedCM on a grid: the ranks' draws differ")
    if any(f["launches"] != expected for f in fed_rows):
        fail(f"FedCM on a grid: launches {row['launches_per_rank']}, expected {expected} on "
             f"each rank")
    if not (np.isfinite(fed_rows[0]["losses"]).all() and replicated
            and np.allclose(got["params"], want["params"], rtol=PARITY_RTOL, atol=PARITY_ATOL)
            and m_rel <= F32_REL_L2 and loss_rel <= F32_REL_L2
            and all(f["losses"] == fed_rows[0]["losses"] for f in fed_rows)):
        fail(f"FedCM on a grid: {json.dumps(row)}")
    t_fed = time.perf_counter() - t0 - t_join
    # 6c: the unsharded server on the card, its own directory, the same versions
    args = serve.build_parser().parse_args(
        [*GRID_SERVE_ARGS, "--ckpt", str(work / "pub_plain"), "--device", device])
    pub = ModelPublisher(str(work / "pub_plain"), retain=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    later = serve.build_model(scfg).init(gen)

    def publish(stats):
        if stats.steps == GRID_PUBLISH_AFTER:
            pub.publish(later, step=2)

    before = launch_counts()
    plain = serve.run(args, on_step=publish, cfg=scfg)
    plain_launches = launches_since(before)
    del later
    served = [r["serve"] for r in ranks[:2]]
    row = {"arch": "llama3.2-1b", "cut": GRID_SERVE_CUT, "ranks": 2,
           "swap_steps_per_rank": [g["swap_steps"] for g in served],
           "versions_per_rank": [g["versions"] for g in served],
           "unsharded_swap_steps": list(plain.stats.swap_steps),
           "launches_per_rank": [g["launches"] for g in served],
           "unsharded_launches": plain_launches,
           "prefill_ms_per_rank": [g["prefill_ms"] for g in served]}
    say(f"serve --ckpt --follow on a model group of 2 (gloo ranks sharing cuda:0): "
        f"{json.dumps(row)}")
    for r, g in enumerate(served):
        if (g["swap_steps"] != list(plain.stats.swap_steps) or g["versions"] != [2]
                or not np.array_equal(g["tokens"], plain.tokens)):
            fail(f"serve --ckpt --follow on a group: rank {r} swapped at {g['swap_steps']} to "
                 f"{g['versions']} (unsharded: {plain.stats.swap_steps}) or its tokens differ")
        if g["launches"]["flash_attention"] != GRID_SERVE_CUT["n_layers"]:
            fail(f"serve --ckpt --follow on a group: rank {r} launches {g['launches']}")
    serve_paths = serve_grid_checks(np, [r["serve_grid"] for r in ranks], smi_line)
    serve_paths.setdefault("flash_attention", {}).update(
        {f"serve_ckpt_group_rank{r}": g["launches"]["flash_attention"]
         for r, g in enumerate(served)})
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    say(f"phases 8 (i), 8 (j), 6c and 6d: the world {wall:.1f} s, then the snapshot's join "
        f"{t_join:.1f} s, the unsharded round {t_fed:.1f} s, the unsharded server and 6d's "
        f"checks {time.perf_counter() - t0 - t_join - t_fed:.1f} s")
    return ({f"fed_lm_grid_rank{r}": f["launches"] for r, f in enumerate(fed_rows)},
            serve_paths)


def grid_train_four_cards(torch, np, smi_line: str, g_run):
    """``--nccl`` (k): ``launch/train.run`` of ``GROUP_TRAIN_FULL``
    (starcoder2-7b whole) on a ``GRID_FULL`` grid of cards over NCCL
    (``--data-parallel 2 --model-parallel 2``: FSDP over data), B 8 x 512,
    ``remat="dots"``, 10 steps, warmup 2.  Each rank's share and train
    state are reckoned and printed first; then a loss that falls and is the
    same on every rank, step 1's loss within ``GRID_STEP1_REL`` and every
    step's loss and grad norm within ``GRID_TRAIN_LOSS_REL`` /
    ``GRID_TRAIN_NORM_REL`` relative of (g)'s
    (``g_run``: the same seed and batches; this holds the NCCL
    reduce-scatter of the FSDP gradients to the model group's step), ms a
    step and tok/s, the bf16-peak share as (g) computes it, each rank's peak
    memory, no kernel launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.sharding.rules import _keys, fsdp_dim, local_shape, split_dim
    from repro_torch.sharding.shard import param_shapes
    from repro_torch.utils.trees import tree_flatten_with_path

    arch, argv = GROUP_TRAIN_FULL
    D, M = GRID_FULL
    g_losses, g_norms = g_run
    cfg = get_config(arch)
    share = 0
    for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]:
        keys, shape = _keys(p), tuple(leaf.shape)
        local = list(local_shape(shape, split_dim(keys, shape, M, cfg), M))
        f = fsdp_dim(keys, shape, D, M, cfg)
        if f is not None:
            local[f] //= D
        share += math.prod(local) * leaf.element_size()
    say(f"training {arch} whole on a {D} x {M} grid of cards, reckoned before the run: FSDP "
        f"share {share / 1e9:.2f} GB a rank; params + gradients + two AdamW moments "
        f"{4 * share / 1e9:.2f} GB a rank; B {8 // D} x 512 a rank")
    args = train.build_parser().parse_args(["--arch", arch, *argv, "--data-parallel", str(D),
                                            "--model-parallel", str(M)])
    t0 = time.perf_counter()
    res = train.run(args, echo=False)
    wall = time.perf_counter() - t0
    steady = res.step_s[GROUP_TRAIN_WARM:]
    step_s = statistics.mean(steady)
    n = D * M
    flops = train_matmul_flops(cfg, res.param_counts, args.batch, args.seq)
    row = {"arch": arch, "cut": "none (published config)", "cards": n, "grid": [D, M],
           "params": sum(res.param_counts.values()), "share_bytes": share, "B": args.batch,
           "S": args.seq, "remat": args.remat, "losses": res.losses,
           "grad_norms": res.grad_norms,
           "loss_rel_to_g": [abs(a - b) / abs(b) for a, b in zip(res.losses, g_losses)],
           "grad_norm_rel_to_g": [abs(a - b) / abs(b) for a, b in zip(res.grad_norms, g_norms)],
           "limits": [GRID_TRAIN_LOSS_REL, GRID_TRAIN_NORM_REL], "ms_per_step": step_s * 1e3,
           "ms_per_step_median": statistics.median(steady) * 1e3,
           "tok_s": args.batch * args.seq / step_s, "matmul_flops_per_step": flops,
           "bf16_peak_share_of_the_cards": flops / step_s / (n * BF16_FLOPS_PER_S),
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res.by_rank],
           "launches_per_rank": [r["launches"] for r in res.by_rank],
           "wall_s_with_init": wall, "card": smi_line}
    say(f"training on a {D} x {M} grid of cards: {json.dumps(row)}")
    if any(any(r["launches"].values()) for r in res.by_rank):
        fail(f"training {arch} on a grid: kernels launched in training")
    if any(r["losses"] != res.losses for r in res.by_rank):
        fail(f"training {arch} on a grid: the ranks' losses differ")
    if not (np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]):
        fail(f"training {arch} on a grid: losses {res.losses} do not fall")
    if not (len(res.losses) == len(g_losses) and row["loss_rel_to_g"][0] <= GRID_STEP1_REL
            and max(row["loss_rel_to_g"]) <= GRID_TRAIN_LOSS_REL
            and max(row["grad_norm_rel_to_g"]) <= GRID_TRAIN_NORM_REL):
        fail(f"training {arch} on a grid: losses {res.losses} / grad norms {res.grad_norms} "
             f"against (g)'s {g_losses} / {g_norms}")


def grid_snapshot_rank(rank, device, work):
    """(k)'s snapshot in one rank of the grid of cards: its FSDP share of
    ``GRID_SNAPSHOT_FULL``'s params and of two AdamW moments (drawn as
    params from other seeds, so that no leaf is zero), written whole by
    ``save_checkpoint_shares``.  Returns the device memory the call added on
    this rank (its peak over what was allocated before), the largest share
    of a leaf, the call's seconds, and whether this rank's share read back
    from the file (``load_checkpoint(..., take=snapshot_take(...))``) is
    bitwise what it wrote."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint_shares
    from repro_torch.configs.base import get_config
    from repro_torch.sharding.shard import init_params_sharded, snapshot_join, snapshot_take
    from repro_torch.utils.trees import tree_leaves

    D, M = GRID_FULL
    arch, cut = GRID_SNAPSHOT_FULL
    cfg = replace(get_config(arch), **cut)
    m, d = rank % M, rank // M  # the grid's rank order (launch.mesh.make_grid)
    gen = torch.Generator(device=device)

    def share(seed):
        gen.manual_seed(seed)
        return init_params_sharded(gen, cfg, m, M, stage="cpu", data=D, data_rank=d)

    tree = {"params": share(GROUP_SEED), "opt": [torch.tensor(7, device=device),
                                                 share(GROUP_SEED + 1), share(GROUP_SEED + 2)]}
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    save_checkpoint_shares(str(work), 1, tree, snapshot_join(cfg, M, D))
    torch.cuda.synchronize(device)
    save_s = time.perf_counter() - t0
    added = torch.cuda.max_memory_allocated(device) - before
    t0 = time.perf_counter()
    back, meta = load_checkpoint(str(work), 1, tree, snapshot_take(cfg, m, M, d, D))
    load_s = time.perf_counter() - t0
    same = meta.get("step") == 1 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    dist.barrier()
    return {"added_bytes": added, "largest_share_bytes": max(
        t.numel() * t.element_size() for t in tree_leaves(tree)), "save_s": save_s,
            "load_s": load_s, "bitwise": same}


def grid_snapshot_four_cards(torch, smi_line: str):
    """``--nccl`` (k), its snapshot: ``grid_snapshot_rank`` on a
    ``GRID_FULL`` grid of cards over NCCL.  Rank 0 gathers each leaf's
    shares in blocks of ``SHARE_CHUNK`` elements into one set of ``world``
    receive blocks, so the other ranks add no device memory and rank 0
    ``world`` blocks (held to one more); every rank reads its share back
    bitwise from the file."""
    import shutil

    from repro_torch.checkpoint.ckpt import SHARE_CHUNK
    from repro_torch.launch.mesh import spawn_cohort

    D, M = GRID_FULL
    arch, cut = GRID_SNAPSHOT_FULL
    work = ROOT / "build" / "smoke_snapshot"
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_cohort(grid_snapshot_rank, D * M, args=(work,), device="cuda",
                         timeout_s=600.0, deadline_s=900.0)
    wall = time.perf_counter() - t0
    size = (work / "step_1.msgpack").stat().st_size
    shutil.rmtree(work)
    block = SHARE_CHUNK * 4  # f32
    row = {"arch": arch, "cut": cut, "grid": [D, M], "file_bytes": size,
           "gather_block_bytes": block, "added_gb_per_rank": [r["added_bytes"] / 1e9 for r in ranks],
           "largest_share_gb": ranks[0]["largest_share_bytes"] / 1e9,
           "every_share_of_it_gb": D * M * ranks[0]["largest_share_bytes"] / 1e9,
           "save_s_per_rank": [r["save_s"] for r in ranks],
           "load_s_per_rank": [r["load_s"] for r in ranks],
           "bitwise_per_rank": [r["bitwise"] for r in ranks], "wall_s": wall, "card": smi_line}
    say(f"snapshot of a 2 x 2 grid of cards (save_checkpoint_shares): {json.dumps(row)}")
    if not all(r["bitwise"] for r in ranks):
        fail("the grid's snapshot: a rank's share read back differs from what it wrote")
    if (ranks[0]["added_bytes"] > (D * M + 1) * block
            or any(r["added_bytes"] > block for r in ranks[1:])):
        fail(f"the grid's snapshot added {row['added_gb_per_rank']} GB a rank, beyond "
             f"{D * M + 1} blocks on rank 0 and one on the others")


def grid_fed_four_cards(torch, np, smi_line: str, h_run):
    """``--nccl`` (l): ``launch/federated_llm.run`` of ``FED_LM_FULL`` as
    published, ``GROUP_FED_RUN`` (N 16, a fixed cohort of 8, K 2, B 4 x 64, 3
    rounds) on a ``GRID_FULL`` grid of cards over NCCL: the cohort over data
    (``cohort_shard``), each client over model.  Each rank's planes are
    reckoned and printed first; then on each rank K ``fed_direction`` and one
    ``server_update`` a round, finite losses, the last round's below the
    first's, each round's loss and momentum norm within ``GRID_FED_REL``
    relative of (h)'s (``h_run``: the same draws), ms a round and each
    rank's peak memory.  An out-of-memory error fails the phase: nothing is
    retried smaller."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import federated_llm
    from repro_torch.sharding.shard import share_bytes

    cfg = get_config(FED_LM_FULL)
    D, M = GRID_FULL
    C, R, K = (GROUP_FED_RUN[k] for k in ("cohort", "rounds", "local_steps"))
    p_r = share_bytes(cfg, M) // 4
    rows_plane = (C // D) * p_r * 4
    block = C * -(-p_r // D) * 4
    say(f"federating {FED_LM_FULL} with a cohort of {C} on a {D} x {M} grid of cards, reckoned "
        f"before the run: P_r = {p_r:,} f32 a rank; a ({C // D}, P_r) plane "
        f"{rows_plane / 1e9:.2f} GB and the fold's ({C}, {-(-p_r // D):,}) column block "
        f"{block / 1e9:.2f} GB, {(rows_plane + block) / 1e9:.2f} GB together; (h)'s (8, P/4) "
        f"plane was {C * (share_bytes(cfg, 4) // 4) * 4 / 1e9:.2f} GB")
    t0 = time.perf_counter()
    res = federated_llm.run(cfg, **GROUP_FED_RUN, device="cuda", model_parallel=M,
                            cohort_shard=D)
    wall = time.perf_counter() - t0
    expected = {"fed_direction": R * K, "server_update": R, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    losses = [r["loss"] for r in res.rounds]
    row = {"arch": FED_LM_FULL, "cut": "none (published config)", "cards": D * M,
           "grid": [D, M], "params": res.n_params,
           "share_params": [r["share_params"] for r in res.by_rank], **GROUP_FED_RUN,
           "losses": losses, "momentum_norm": [r["momentum_norm"] for r in res.rounds],
           "loss_rel_to_h": [abs(a - b) / abs(b) for a, b in zip(losses, h_run[0])],
           "momentum_norm_rel_to_h": [abs(r["momentum_norm"] - b) / abs(b)
                                      for r, b in zip(res.rounds, h_run[1]) if b],
           "limit": GRID_FED_REL, "ms_per_round": res.round_ms,
           "peak_gb_per_rank": [r["peak_bytes"] / 1e9 for r in res.by_rank],
           "launches_per_rank": [r["launches"] for r in res.by_rank],
           "wall_s_with_init": wall, "card": smi_line}
    say(f"FedCM on a {D} x {M} grid of cards: {json.dumps(row)}")
    if any(r["launches"] != expected for r in res.by_rank):
        fail(f"FedCM on a grid of cards: launches {row['launches_per_rank']}, expected "
             f"{expected}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"FedCM on a grid of cards: losses {losses} do not fall")
    h_losses, h_norms = h_run
    norms = row["momentum_norm"]
    if not (len(losses) == len(h_losses) and norms[0] == h_norms[0] == 0.0
            and max(row["loss_rel_to_h"]) <= GRID_FED_REL
            and max(row["momentum_norm_rel_to_h"]) <= GRID_FED_REL):
        fail(f"FedCM on a grid of cards: losses {losses} / momentum norms {norms} against "
             f"(h)'s {h_losses} / {h_norms}")


def fed_lm_step_profile(torch, smi_line: str) -> None:
    """``--profile``: one FedCM local step of phase 8 (d)'s run (the
    ``(FED_LM_RUN["cohort"], P)`` plane of ``FED_LM_FULL``, a batch of
    ``FED_LM_FULL_BATCH`` tokens a client): the gradient plane (the
    engine's ``_value_and_grad``), ``g ← wd·x + g``, one ``fed_direction``.
    The gradient is taken two ways on the same x and batch: ``views``, the
    engine's (with respect to the leaf views, copied into one plane), and
    ``plane`` (with respect to the whole plane, where each view's slice
    backward writes a zero plane).  For each: the step's device ms (CUDA
    events, median of 3 after a warm-up), its peak device memory above
    what was allocated before it, the allocations of a plane's bytes or
    more (the allocator's history), the slice / select backward calls and
    the kernels with the most device time (torch.profiler); the two
    gradient planes must be equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import FedConfig, get_config
    from repro_torch.core.engine import FederatedEngine
    from repro_torch.core.flat import FlatSpec
    from repro_torch.kernels.fed_direction.ops import direction_operands, fed_direction
    from repro_torch.launch import federated_llm
    from repro_torch.models.model import build_model, cohort_loss_fn

    cfg = get_config(FED_LM_FULL)
    C, (B, S) = FED_LM_RUN["cohort"], FED_LM_FULL_BATCH
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    spec = FlatSpec.from_tree(params)
    fed = FedConfig(algo="fedcm", num_clients=FED_LM_RUN["n_clients"], cohort_size=C,
                    local_steps=FED_LM_RUN["local_steps"], alpha=federated_llm.ALPHA,
                    eta_l=0.05, weight_decay=federated_llm.WEIGHT_DECAY)
    eng = FederatedEngine(fed, cohort_loss_fn(model), spec, batch_size=B, device="cuda")
    x = spec.ravel(params).expand(C, -1).contiguous()
    del params
    toks = torch.randint(0, 512, (C, B, S + 1), generator=gen, device="cuda")
    batch = {"x": toks[..., :-1], "y": toks[..., 1:]}
    auxes, coefs = direction_operands(eng.algo, fed, torch.zeros(spec.size, device="cuda"),
                                      None, x[0], torch.full((), fed.eta_l, device="cuda"))
    plane_bytes = x.numel() * x.element_size()

    def plane_grad(xx, bb):
        plane = xx.detach().requires_grad_(True)
        with torch.enable_grad():
            losses = eng.loss_fn(spec.unravel(plane), bb)
            (g,) = torch.autograd.grad(losses.sum(), plane)
        return losses.detach(), g

    grads = {}
    for route, grad in (("views", eng._value_and_grad), ("plane", plane_grad)):
        def step():
            _, g = grad(x, batch)
            return fed_direction(x, fed.weight_decay * x + g, auxes, coefs)

        step()
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=100_000)
        step()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"]
        torch.cuda.memory._record_memory_history(enabled=None)
        big = sum(1 for t in trace for e in t
                  if e["action"] == "alloc" and e["size"] >= plane_bytes)
        peak = torch.cuda.max_memory_allocated() - base
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        calls = {e.key: e.count for e in events}
        kernels = sorted(((e.self_device_time_total, e.count, e.key) for e in events
                          if e.device_type == DeviceType.CUDA), reverse=True)
        row = {"route": route, "arch": FED_LM_FULL, "C": C, "P": spec.size,
               "leaves": len(spec.leaves), "B": B, "S": S,
               "step_ms": statistics.median(times), "step_ms_samples": times,
               "peak_bytes_above_base": peak, "allocs_of_a_plane_or_more": big,
               "kernels_device_ms": sum(k[0] for k in kernels) / 1e3,
               "slice_backward_calls": calls.get("aten::slice_backward", 0),
               "select_backward_calls": calls.get("aten::select_backward", 0),
               "top_kernels_device_ms": [[k[:90], n, d / 1e3] for d, n, k in kernels[:10]],
               "card": smi_line}
        say(f"federated LM local step profile: {json.dumps(row)}")
        grads[route] = grad(x, batch)[1]
        torch.cuda.empty_cache()
    if not torch.equal(grads["views"], grads["plane"]):
        fail("federated LM local step profile: the two gradient planes differ")
    say("federated LM local step profile: the gradient planes of both routes are equal")
    del grads, x, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- phase 4b
def other_algorithms(torch, np, bindings):
    """``run_federated`` for each of ``OTHER_ALGOS`` at the CLI defaults,
    then scaffold and mimelite under int8, each with the launch counts set
    to 0 just before and read just after; then the steady seconds per round
    of an engine on the same config."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    rows = []
    for algo, comp in [(a, None) for a in OTHER_ALGOS] + [("scaffold", "int8"),
                                                          ("mimelite", "int8")]:
        cfg = FedConfig(algo=algo, participation="bernoulli", rounds=ROUNDS,
                        compression=None if comp is None else CompressionConfig(kind=comp),
                        **ALGO_SETTINGS.get(algo, {}))
        su, dq = FOLDS_PER_ROUND.get(algo, {None: (1, 0)})[comp]
        expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * su,
                    "dequant_update": ROUNDS * dq, "flash_attention": 0, "ssd_scan": 0}
        name = algo if comp is None else f"{algo} {comp}"
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite loss {losses}")
        if launches != expected:
            fail(f"{name}: launch counts {launches}, expected {expected}")
        s_round, eng, state, _, host = steady_seconds_per_round(torch, cfg)
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"{name}: non-finite loss or params in the steady-state rounds")
        wire = eng.payload_bytes()["up_per_client"]
        if not np.array_equal(host["bytes_up"], host["n_active"] * np.float32(wire)):
            fail(f"{name}: bytes_up is not n_active x {wire}")
        row = {"algo": algo, "uplink": comp or "f32", "rounds": ROUNDS, "launches": launches,
               "losses": losses, "final_test_acc": acc, "wall_s": wall,
               "steady_ms_per_round": s_round * 1e3, "uplink_bytes_per_client": wire}
        say(f"{name}: {json.dumps(row)}")
        rows.append(row)
        del eng, state
    return rows


# ---------------------------------------------------------------------- phase 4c
def async_ring(torch, np, bindings):
    """``run_federated`` on the async ring for each of ``ASYNC_RUNS`` at the
    CLI defaults, γ = 0.9, with the launch counts set to 0 just before and
    read just after (K ``fed_direction`` a round; one fold launch a round
    per fold row, drain included: ``FOLDS_PER_ROUND``); then the steady seconds
    per round of 20 further rounds of an engine, whose ``folded`` must be
    D − 1 zeros and then ones."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    rows = []
    for algo, comp, D, S in ASYNC_RUNS:
        cfg = FedConfig(algo=algo, participation="bernoulli", rounds=ROUNDS, pipeline_depth=D,
                        staleness=S, staleness_discount=RING_GAMMA,
                        compression=None if comp is None else CompressionConfig(kind=comp))
        su, dq = FOLDS_PER_ROUND.get(algo, {None: (1, 0)})[comp]
        expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * su,
                    "dequant_update": ROUNDS * dq, "flash_attention": 0, "ssd_scan": 0}
        name = f"{algo}{'' if comp is None else ' ' + comp} D={D} S={S}"
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not losses or not all(np.isfinite(losses)):
            fail(f"async {name}: non-finite or missing loss {losses}")
        if launches != expected:
            fail(f"async {name}: launch counts {launches}, expected {expected}")
        # the sync twin (same spec and uplink, D = 1, S = 0) before and after
        # the ring, so the two are compared in turns on one host
        sync_cfg = replace(cfg, pipeline_depth=1, staleness=0)
        sync_a = steady_seconds_per_round(torch, sync_cfg)[0]
        s_round, eng, state, _, host = steady_seconds_per_round(torch, cfg, ring=(D, S))
        sync_b = steady_seconds_per_round(torch, sync_cfg)[0]
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"async {name}: non-finite loss or params in the steady-state rounds")
        want = [0.0] * (D - 1) + [1.0] * (ROUNDS - D + 1)
        if host["folded"].tolist() != want:
            fail(f"async {name}: folded {host['folded'].tolist()}, expected {want}")
        row = {"algo": algo, "uplink": comp or "f32", "D": D, "S": S, "gamma": RING_GAMMA,
               "rounds": ROUNDS, "launches": launches, "losses": losses,
               "final_test_acc": acc, "wall_s": wall, "steady_ms_per_round": s_round * 1e3,
               "sync_twin_ms_per_round": [sync_a * 1e3, sync_b * 1e3]}
        say(f"async {name}: {json.dumps(row)}")
        rows.append(row)
        del eng, state
    return rows


# ---------------------------------------------------------------------- phase 4d
def host_store_fleet(torch, np, bindings):
    """The host store at ``FLEET_N`` clients (scaffold, zipf availability,
    dropout 0.1, store failures 0.05, ``StreamingClientData``): for the sync
    loop and the ring at D = 2, S = 1, ``run_federated`` with the launch
    counts set to 0 just before and read just after, then an engine's 20
    rounds (the touched rows, the store's bytes, n_retries) and 20 further
    rounds (steady s/round), the device's peak memory over it all."""
    from repro_torch.configs.base import FaultConfig, FedConfig
    from repro_torch.core.engine import cohort_capacity, metrics_to_host
    from repro_torch.data import StreamingClientData
    from repro_torch.launch.fed_train import run_federated

    base = FedConfig(algo="scaffold", num_clients=FLEET_N, participation="bernoulli",
                     rounds=ROUNDS, population_store="host", availability="zipf",
                     dropout_rate=0.1, fault=FaultConfig(store_failure_rate=0.05),
                     staleness_discount=RING_GAMMA)
    cap = cohort_capacity(base)
    expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS * 2, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rows = []
    for mode, ring in (("sync", None), ("async D=2 S=1", (2, 1))):
        cfg = base if ring is None else replace(base, pipeline_depth=ring[0], staleness=ring[1])
        for b in bindings.values():
            b.launches = 0
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not losses or not all(np.isfinite(losses)):
            fail(f"host store {mode}: non-finite or missing loss {losses}")
        if launches != expected:
            fail(f"host store {mode}: launch counts {launches}, expected {expected}")
        eng, state, data = fresh_engine(torch, cfg, StreamingClientData(FLEET_N, seed=0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ms = run_engine(eng, state, data, ROUNDS, ring)
        torch.cuda.synchronize()
        first_s = (time.perf_counter() - t0) / ROUNDS
        first = metrics_to_host(ms)
        touched, nbytes = eng.population.touched, eng.population.nbytes
        t0 = time.perf_counter()
        state, ms = run_engine(eng, state, data, ROUNDS, ring)
        torch.cuda.synchronize()
        s_round = (time.perf_counter() - t0) / ROUNDS
        host = metrics_to_host(ms)
        if not (np.isfinite(first["loss"]).all() and np.isfinite(host["loss"]).all()
                and torch.isfinite(state.params).all()):
            fail(f"host store {mode}: non-finite loss or params")
        if state.client_states is not None or not 0 < touched <= ROUNDS * cap:
            fail(f"host store {mode}: {touched} touched rows after {ROUNDS} rounds "
                 f"(at most {ROUNDS} x {cap}), or an (N, P) device plane")
        retries = int(first["n_retries"].sum() + host["n_retries"].sum()
                      + sum(log.column("retries")))
        row = {"mode": mode, "N": FLEET_N, "capacity": cap, "launches": launches,
               "losses": losses, "final_test_acc": acc, "touched_rows": touched,
               "store_bytes": nbytes, "n_retries": retries,
               "first_ms_per_round": first_s * 1e3, "steady_ms_per_round": s_round * 1e3,
               "resident_plane_bytes": FLEET_N * eng.spec.size * 4}
        say(f"host store {mode}: {json.dumps(row)}")
        rows.append(row)
        del eng, state, data
    peak = torch.cuda.max_memory_allocated()
    say(f"host store at N={FLEET_N}: device memory allocated {before} B before, peak "
        f"{peak} B over both loops (limit 1 GB); a resident (N, P) f32 plane would take "
        f"{rows[0]['resident_plane_bytes']} B")
    if peak >= 1e9:
        fail(f"host store: peak device memory {peak} B, not under 1 GB")
    if sum(r["n_retries"] for r in rows) == 0:
        fail("host store: no store retry at failure rate 0.05")
    return rows


def bitwise_pairs_on_card(torch, np):
    """Device-resident data (N = 100) on the card, bit for bit: the host
    store against the resident plane for scaffold and feddyn, sync and
    async (D = 2, S = 1), and for scaffold under int8 and under top-k (the
    residual store against the resident residual plane); and the ring at
    D = 1, S = 0 against the sync loop for scaffold under int8."""
    from repro_torch.configs.base import CompressionConfig, FedConfig
    from repro_torch.core.engine import metrics_to_host

    def run(cfg, ring):
        eng, state, data = fresh_engine(torch, cfg)
        state, ms = run_engine(eng, state, data, PAIR_ROUNDS, ring)
        return eng, state, metrics_to_host(ms)

    def rows_of(eng, state):
        if state.client_states is not None:
            return state.client_states.cpu().numpy()
        dense = np.zeros((eng.cfg.num_clients, eng.spec.size), np.float32)
        tree = eng.population.to_pytree()
        dense[tree["ids"]] = tree["rows"]
        return dense

    def same(a, b, what):
        (ea, sa, ma), (eb, sb, mb) = a, b
        ok = torch.equal(sa.params, sb.params) and torch.equal(sa.server.momentum,
                                                               sb.server.momentum)
        ok = ok and all(np.array_equal(ma[f], mb[f]) for f in ma if f in mb)
        ok = ok and np.array_equal(rows_of(ea, sa), rows_of(eb, sb))
        if not ok:
            fail(f"{what}: not bitwise equal on the card")

    pairs = 0
    for algo in ("scaffold", "feddyn"):
        for ring in (None, (2, 1)):
            cfg = FedConfig(algo=algo, participation="bernoulli", staleness_discount=RING_GAMMA)
            same(run(cfg, ring), run(replace(cfg, population_store="host"), ring),
                 f"store vs resident {algo} {'sync' if ring is None else 'async'}")
            pairs += 1
    for kind in ("int8", "topk"):
        cfg = FedConfig(algo="scaffold", participation="bernoulli",
                        compression=CompressionConfig(kind=kind))
        res, host = run(cfg, None), run(replace(cfg, population_store="host"), None)
        same(res, host, f"store vs resident scaffold {kind}")
        if kind == "topk":
            dense = np.zeros((cfg.num_clients, host[0].spec.size), np.float32)
            tree = host[0].residual_population.to_pytree()
            dense[tree["ids"]] = tree["rows"]
            if not np.array_equal(dense, res[1].residuals.cpu().numpy()):
                fail("store vs resident scaffold topk: residual store differs")
        pairs += 1
    cfg = FedConfig(algo="scaffold", participation="bernoulli",
                    compression=CompressionConfig(kind="int8"))
    same(run(cfg, None), run(cfg, (1, 0)), "ring D=1 S=0 vs sync, scaffold int8")
    return pairs + 1


# ---------------------------------------------------------------------- phase 4e
def run_all(cmds, env, timeout: float):
    """Start every command at once, wait for all; returns ``[(rc, stdout,
    stderr)]``.  No process outlives the call."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode, *o) for p, o in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def snapshots_equal(torch, a: Path, b: Path):
    """Plane for plane (``load_flat``), then byte for byte, two snapshots;
    returns the planes' names."""
    from repro_torch.checkpoint import load_flat

    fa, ma = load_flat(str(a.parent), int(a.stem.split("_")[1]))
    fb, mb = load_flat(str(b.parent), int(b.stem.split("_")[1]))
    if fa.keys() != fb.keys() or ma != mb:
        fail(f"snapshots {a} and {b}: keys or meta differ ({ma} / {mb})")
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype or not torch.equal(fa[k], fb[k])]
    if bad or a.read_bytes() != b.read_bytes():
        fail(f"snapshots {a} and {b} differ: planes {bad}")
    return sorted(fa)


def kill_and_resume(torch, np, bindings, work: Path):
    """(a) Each of ``KILL_CASES`` as ``python -m repro_torch.launch.fed_train``
    subprocesses: killed after the snapshot at round 10 (exit code 75), then
    resumed to round 20; its snapshot of round 20 against the same run's
    straight in-process ``run_federated``, plane for plane and byte for
    byte; then the snapshot's load and save ms (``load_fed_run`` /
    ``save_fed_run`` on the card, the re-saved file byte-equal)."""
    import os

    from repro_torch.checkpoint import load_fed_run, save_fed_run
    from repro_torch.data import StreamingClientData
    from repro_torch.launch import fed_train

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dirs = [work / f"kill{i}" for i in range(len(KILL_CASES))]
    argvs = [[*KILL_ARGS, *flags, "--ckpt-dir", str(d)] for (_, flags, _), d in
             zip(KILL_CASES, dirs)]
    t0 = time.perf_counter()
    died = run_all([[sys.executable, "-m", "repro_torch.launch.fed_train", *a, "--die-after",
                     "10"] for a in argvs], env, 600)
    t_die = time.perf_counter() - t0
    for (name, _, _), (rc, out, err), d in zip(KILL_CASES, died, dirs):
        if rc != 75 or sorted(p.name for p in d.glob("step_*")) != ["step_10.msgpack"]:
            fail(f"kill/resume {name}: the killed run exited {rc} with "
                 f"{sorted(p.name for p in d.glob('step_*'))}: {err[-2000:]}")
    t0 = time.perf_counter()
    resumed = run_all([[sys.executable, "-c", CLI_WITH_COUNTS, *a, "--resume"] for a in argvs],
                      env, 600)
    t_resume = time.perf_counter() - t0
    say(f"kill/resume: 3 killed runs (exit code 75 each) in {t_die:.1f} s wall, 3 resumed "
        f"runs in {t_resume:.1f} s wall, in parallel subprocesses")
    rows = []
    for (name, flags, want), (rc, out, err), d in zip(KILL_CASES, resumed, dirs):
        counts = [json.loads(l.split(" ", 1)[1]) for l in out.splitlines()
                  if l.startswith("LAUNCHES ")]
        if rc != 0 or counts != [list(want)]:
            fail(f"kill/resume {name}: the resumed run exited {rc}, launches {counts} "
                 f"(predicted {list(want)}): {err[-2000:]}")
        args = fed_train.build_parser().parse_args([*KILL_ARGS, *flags])
        cfg = fed_train.resolve_config(args)
        straight = d.parent / f"{d.name}-straight"
        for b in bindings.values():
            b.launches = 0
        fed_train.run_federated(cfg, args.dirichlet, eval_every=EVAL_EVERY, seed=0, echo=False,
                                device="cuda", ckpt_every=10, ckpt_dir=str(straight))
        torch.cuda.synchronize()
        got = [bindings[k].launches for k in ("fed_direction", "server_update",
                                              "dequant_update")]
        if got != [2 * n for n in want]:
            fail(f"kill/resume {name}: the straight run launched {got}, expected "
                 f"{[2 * n for n in want]}")
        snap = d / "step_20.msgpack"
        planes = snapshots_equal(torch, snap, straight / "step_20.msgpack")
        host = cfg.population_store == "host"
        eng, like, _ = fresh_engine(torch, cfg, StreamingClientData(FLEET_N, seed=0)
                                    if host else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, pop, res, _ = load_fed_run(str(d), 20, like, eng.spec,
                                          num_clients=cfg.num_clients)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        again = save_fed_run(str(work / f"resave{len(rows)}"), 20, state, eng.spec,
                             population=pop, residuals=res)
        save_ms = (time.perf_counter() - t0) * 1e3
        if Path(again).read_bytes() != snap.read_bytes():
            fail(f"kill/resume {name}: the loaded and re-saved snapshot differs from the file")
        row = {"case": name, "exit_code_killed": 75, "resumed_launches": counts[0],
               "snapshot_bytes": snap.stat().st_size, "planes": len(planes),
               "store_rows": int(pop.touched) if pop is not None else 0,
               "load_ms": load_ms, "save_ms": save_ms}
        say(f"kill/resume {json.dumps(row)}: round 20 byte-equal to the straight run")
        rows.append(row)
        del eng, like, state
    return rows


def fleet_loop(torch, np, bindings, work: Path):
    """(b) ``run_federated(..., ckpt_every=5, serve=True)`` for 20 rounds at
    the CLI defaults against the same run with ``serve=False``: versions
    1-5 published, a hot-swap under load, the served version 5, the in-run
    health probe 200, ``fleet.check`` clean, the final snapshots equal plane
    for plane and byte for byte; then the steady ms a round of an engine
    with and without a serving thread, in turns."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.fleet.check import check
    from repro_torch.fleet.driver import FleetDriver
    from repro_torch.fleet.telemetry import events, replay
    from repro_torch.launch.fed_train import run_federated
    from repro_torch.models.small import mlp_classifier

    cfg = FedConfig(participation="bernoulli", rounds=ROUNDS)
    expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    for serve in (False, True):
        for b in bindings.values():
            b.launches = 0
        acc, _ = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                               device="cuda", ckpt_every=5, ckpt_dir=str(work / f"fleet{serve:d}"),
                               serve=serve)
        torch.cuda.synchronize()
        launches = {k: b.launches for k, b in bindings.items()}
        if launches != expected:
            fail(f"fleet loop (serve={serve}): launch counts {launches}, expected {expected}")
    planes = snapshots_equal(torch, work / "fleet0" / "step_20.msgpack",
                             work / "fleet1" / "step_20.msgpack")
    path = str(work / "fleet1" / "telemetry.jsonl")
    _, rows, _ = replay(path)
    versions = [e["version"] for e in events(rows, "publish")]
    summary = events(rows, "serve_summary")[-1]
    probe = events(rows, "health_probe")[-1]
    fails = check(path, min_rounds=ROUNDS, min_swaps=1, require_health=True)
    if (versions != [1, 2, 3, 4, 5] or summary["swaps"] < 1 or summary["served_version"] != 5
            or probe["status"] != 200 or fails):
        fail(f"fleet loop: versions {versions}, serve summary {summary}, health probe {probe}, "
             f"check {fails}")
    say(f"fleet loop: {len(planes)} planes of the --serve run's round-20 snapshot bitwise "
        f"equal to the plain run's; versions {versions}; {summary['swaps']} hot-swaps "
        f"({summary['swaps_mid_session']} under decode load) over {summary['steps']} "
        f"steps, served version {summary['served_version']}; health {probe['status']}; "
        f"fleet.check clean; final test_acc {acc:.4f}")

    model = mlp_classifier((32, 128, 128, 10))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batch = torch.randn(128, 32, device="cuda", generator=gen)

    def turn(serve: bool, i: int):
        eng, state, data = fresh_engine(torch, cfg)
        state, _ = eng.run_rounds(state, data, 2)
        fleet = None
        if serve:
            fleet = FleetDriver(ckpt_dir=str(work / f"turn{i}"))
            fleet.publish(0, eng.spec.unravel(state.params.cpu()))
            fleet.start_serving(model.apply, template=eng.spec.unravel(state.params),
                                batch_x=batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = eng.run_rounds(state, data, ROUNDS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ROUNDS * 1e3
        steps = fleet.stop()["steps"] if fleet is not None else 0
        return ms, steps

    turns = [(serve, *turn(serve, i)) for i, serve in enumerate((False, True, True, False))]
    say("fleet loop, steady ms/round in turns (plain, serve, serve, plain): " + ", ".join(
        f"{'serve' if s else 'plain'} {ms:.3f}" + (f" ({n} serving steps)" if s else "")
        for s, ms, n in turns))
    return {"turns": turns, "versions": versions, "swaps": summary["swaps"]}


def lm_serving_from_published(torch, np, bindings, work: Path):
    """(c) llama3.2-1b at its published widths cut to 2 layers (random init)
    published as version 1; ``serve.run --ckpt DIR --follow --sessions 3``
    with version 2 (every weight × 0.5) published from another thread after
    session 0: a swap, served version 2, ``flash_attention`` in every
    prefill, and the last session's greedy tokens equal to a fresh
    ``serve.run --ckpt DIR/step_2.msgpack``."""
    import threading
    from dataclasses import replace as dc_replace

    from repro_torch.fleet.publisher import ModelPublisher, load_published
    from repro_torch.launch import serve
    from repro_torch.utils.trees import tree_leaves, tree_map

    pub_dir = work / "lm_pub"
    args = serve.build_parser().parse_args([*LM_FLEET_ARGS, "--ckpt", str(pub_dir),
                                            "--follow", "--sessions", "3"])
    cfg = dc_replace(serve.get_config(args.arch), n_layers=2)
    model = serve.build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    params = model.init(gen)
    pub = ModelPublisher(str(pub_dir), retain=2)
    t0 = time.perf_counter()
    pub.publish(params, step=0)
    publish_ms = (time.perf_counter() - t0) * 1e3
    payload = (pub_dir / "step_1.msgpack").stat().st_size
    halves = tree_map(lambda a: 0.5 * a, params)
    del params
    published = threading.Event()

    def publish_v2():
        pub.publish(halves, step=1)
        published.set()

    def on_step(stats):  # after session 0's last decode step
        if stats.steps == args.gen - 1:
            t = threading.Thread(target=publish_v2)
            t.start()
            t.join(timeout=300)

    for b in bindings.values():
        b.launches = 0
    res = serve.run(args, on_step=on_step, cfg=cfg)
    torch.cuda.synchronize()
    launches = {k: b.launches for k, b in bindings.items()}
    want = {k: 2 * args.sessions if k == "flash_attention" else 0 for k in bindings}
    if (not published.is_set() or launches != want or res.stats.swaps < 1
            or res.stats.served_version != 2):
        fail(f"serving from published params: published {published.is_set()}, launches "
             f"{launches} (expected {want}), stats {res.stats}")
    fresh = serve.run(serve.build_parser().parse_args(
        [*LM_FLEET_ARGS, "--ckpt", str(pub_dir / "step_2.msgpack")]), cfg=cfg)
    if not np.array_equal(res.tokens, fresh.tokens):
        fail("serving from published params: the last session's tokens differ from a "
             "fresh run on version 2")
    del halves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loaded, _ = load_published(str(pub_dir), model.init(gen), 2)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    n_params = sum(t.numel() for t in tree_leaves(loaded))
    del loaded
    row = {"arch": "llama3.2-1b", "n_layers": 2, "params": n_params, "payload_bytes": payload,
           "publish_ms": publish_ms, "load_ms": load_ms, "swaps": res.stats.swaps,
           "swap_steps": res.stats.swap_steps, "served_version": res.stats.served_version,
           "launches": launches, "prefill_ms": [t * 1e3 for t in res.prefill_s]}
    say(f"serving from published params: {json.dumps(row)}; last session's tokens equal a "
        f"fresh run on version 2")
    torch.cuda.empty_cache()
    return row


def checkpoint_and_fleet(torch, np, bindings):
    """Phase 4e: (a) kill and resume, (b) the fleet loop, (c) LM serving
    from published params, in a work directory under ``build/`` (ignored by
    git), removed at the end."""
    import shutil

    work = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    kill_and_resume(torch, np, bindings, work)
    fleet_loop(torch, np, bindings, work)
    lm_serving_from_published(torch, np, bindings, work)
    shutil.rmtree(work)
    say(f"checkpoint and fleet: phase 4e in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------- phase 4f
# (label, algo, uplink, fault, ring (D, S)) of the sharded whole-round runs,
# each SHARD_ROUNDS rounds (iterations on the ring, drain included) at the
# CLI defaults; SHARD_WORLDS ranks share cuda:0 over gloo
SHARD_RUNS = (("fedcm", "fedcm", None, None, None),
              ("scaffold int8", "scaffold", "int8", None, None),
              ("mimelite", "mimelite", None, None, None),
              ("fedcm faults", "fedcm", None, {"drop_rate": 0.1, "corrupt_rate": 0.1,
                                               "corrupt_mode": "nan"}, None),
              ("fedcm ring D=2 S=1", "fedcm", None, None, (2, 1)),
              # registered at runtime (phase 4g's): an affine direction and a
              # server_fn, whose means come from scatter_means
              ("_test_mixed", "_test_mixed", None, None, None))
SHARD_ROUNDS = 4
SHARD_WORLDS = (2, 4)
SHARD_TIMEOUT_S, SHARD_DEADLINE_S = 60.0, 150.0
# phase 4f (d): rounds of each sharded fleet run and its snapshot interval
SERVE_ROUNDS, SERVE_CKPT_EVERY = 10, 2


def shard_fold_cases(torch, su_kernel, gen):
    """Phase 4f (a): a round's uplink split exactly as ``scatter_fold`` lays
    it out (``columns_send`` blocks, as the ``all_to_all`` delivers them;
    x and m as ``plane_chunk`` views, 4 bytes past a 16-byte boundary or
    more), in one process, at both planes for n in ``SHARD_WORLDS``: each
    shard's ``server_update`` (f32 deltas) and ``dequant_update`` (int8 q)
    launch on its ``(C_pad, chunk)`` block; the joined outputs must equal
    the unsharded launch bit for bit.  Returns the rows it printed."""
    from repro_torch.core.flat import columns_send, pad_cohort, plane_chunk
    from repro_torch.sharding.rules import padded_cohort

    rows = []
    for C, P in ((MAIN_C, MAIN_P), (BIG_C, BIG_P)):
        deltas = torch.randn((C, P), generator=gen, device="cuda") * 1e-2
        q = torch.randint(-127, 128, (C, P), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand((C, 1), generator=gen, device="cuda") * 1e-3
        wn, x, m, coefs = fold_inputs(torch, C, P, torch.float32, gen)
        reps = 20 if C * P < 10_000_000 else 5
        kinds = {"server_update": (deltas, None), "dequant_update": (q, scale)}

        def launch(plane, sc, wn_, x_, m_):
            if sc is None:
                return su_kernel.server_update_flat(plane, wn_, x_, m_, coefs)
            return su_kernel.dequant_update_flat(plane, sc, wn_, x_, m_, coefs)

        for kind, (plane, sc) in kinds.items():
            whole = launch(plane, sc, wn, x, m)
            whole_ms = graph_ms(torch, lambda: launch(plane, sc, wn, x, m), reps)
            for n in SHARD_WORLDS:
                c_pad = padded_cohort(C, n)
                c_loc = c_pad // n
                padded = pad_cohort(plane, c_pad)
                sends = [columns_send(padded[s * c_loc:(s + 1) * c_loc], n) for s in range(n)]
                wn_p = pad_cohort(wn, c_pad, "zero")
                sc_p = None if sc is None else pad_cohort(sc, c_pad)
                outs, shard_ms, offsets = [], [], []
                for r in range(n):
                    block = torch.cat([sends[s][r] for s in range(n)])
                    xr, mr = plane_chunk(x, r, n), plane_chunk(m, r, n)
                    offsets.append(xr.data_ptr() % 16)
                    outs.append(launch(block, sc_p, wn_p, xr, mr))
                    shard_ms.append(graph_ms(torch, lambda: launch(block, sc_p, wn_p, xr, mr),
                                             reps))
                chunk = -(-P // n)
                joined = [torch.cat([o[i] for o in outs])[:P] for i in range(3)]
                bitwise = all(torch.equal(a, b) for a, b in zip(joined, whole))
                nbytes = (c_pad * chunk * plane.element_size() + c_pad * 4 + 16 + chunk * 4
                          + 4 * chunk * 4 + (c_pad * 4 if sc is not None else 0))
                flops = (2 if sc is None else 3) * c_pad * chunk + 6 * chunk
                b_ms, b_by = bound(nbytes, flops)
                row = {"kernel": kind, "C": C, "P": P, "n": n, "C_pad": c_pad, "chunk": chunk,
                       "x_m_offset_mod16": offsets, "bitwise": bitwise,
                       "shard_ms": shard_ms, "whole_ms": whole_ms,
                       "shard_bound_ms": b_ms, "shard_bound_by": b_by}
                say(f"shard fold {json.dumps(row)}")
                rows.append(row)
                if not bitwise:
                    fail(f"{kind} on {n} column shards of ({C}, {P}) is not bitwise the "
                         f"unsharded launch")
                del padded, sends, outs, joined
            torch.cuda.empty_cache()
        del deltas, q
        torch.cuda.empty_cache()
    return rows


def shard_run(torch, spec, device, group):
    """One of ``SHARD_RUNS`` at the CLI defaults on ``device``, sharded over
    ``group`` (None: unsharded), with the federated kernels' launch counts
    set to 0 just before and read just after.  Returns numpy planes,
    metrics, launches and the wall seconds of the rounds (synchronized)."""
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.core.convert import state_to_numpy
    from repro_torch.core.engine import FederatedEngine, metrics_to_host
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.kernels.fed_direction import kernel as fd_kernel
    from repro_torch.kernels.server_update import kernel as su_kernel
    from repro_torch.models.small import classification_loss, mlp_classifier

    _, algo, comp, fault, ring = spec
    cfg = FedConfig(algo=algo, participation="bernoulli",
                    compression=None if comp is None else CompressionConfig(kind=comp),
                    fault=None if fault is None else FaultConfig(**fault),
                    **ALGO_SETTINGS.get(algo, {}))
    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=50_000, n_test=10, seed=0)
    data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0,
                         device=device)
    model = mlp_classifier((32, 128, 128, 10))
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          device=device, cohort_group=group)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    state = eng.init(params, gen)
    counted = {"fed_direction": fd_kernel.KERNEL, "server_update": su_kernel.KERNEL,
               "dequant_update": su_kernel.DEQUANT_KERNEL}
    for b in counted.values():
        b.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if ring is None:
        state, ms = eng.run_rounds(state, data, SHARD_ROUNDS)
    else:
        state, ms = eng.run_rounds_async(state, data, SHARD_ROUNDS, pipeline_depth=ring[0],
                                         staleness=ring[1])
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {"state": state_to_numpy(state), "metrics": metrics_to_host(ms),
            "launches": {k: b.launches for k, b in counted.items()}, "seconds": seconds}


def shard_rank(rank, device, runs):
    """A rank of a phase-4f world: a warm-up run of ``runs[0]`` (so no timed
    run pays the process's first CUDA and cuBLAS calls), then every run of
    ``runs`` in turn."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    register_user_specs()
    shard_run(torch, runs[0], device, dist.group.WORLD)
    return [shard_run(torch, spec, device, dist.group.WORLD) for spec in runs]


def _planes_diff(np, a, b):
    """Largest |a − b| over every state plane and metric of two runs, and
    whether they are bitwise equal and within the parity tolerance."""
    worst, same, close = 0.0, True, True
    pairs = [(a["state"][k], b["state"][k]) for k in ("params", "momentum", "second_moment",
                                                       "client_states", "residuals")]
    pairs += [(a["metrics"][k], b["metrics"][k]) for k in b["metrics"]]
    for u, v in pairs:
        if (u is None) != (v is None):
            return float("inf"), False, False
        if u is None:
            continue
        same = same and np.array_equal(u, v, equal_nan=True)
        close = close and np.allclose(u, v, rtol=PARITY_RTOL, atol=PARITY_ATOL, equal_nan=True)
        if u.size:
            worst = max(worst, float(np.nanmax(np.abs(u.astype(np.float64) - v))))
    return worst, same, close


def sharded_worlds(torch, np, n_worlds, backend, plain):
    """Phase 4f (b) / (c): every ``SHARD_RUNS`` run on worlds of
    ``n_worlds`` ranks, checked rank against rank 0 (bitwise), against the
    predicted launch counts, and against the unsharded runs ``plain``
    (bitwise, or within ``PARITY_RTOL`` / ``PARITY_ATOL`` with the largest
    difference printed)."""
    from repro_torch.launch.mesh import spawn_cohort

    where = ("gloo, ranks sharing cuda:0 (collectives staged through the host; not a "
             "multi-card time)" if backend == "gloo" else "nccl, one card a rank")
    for n in n_worlds:
        t0 = time.perf_counter()
        ranks = spawn_cohort(shard_rank, n, args=(SHARD_RUNS,), device="cuda", backend=backend,
                             timeout_s=SHARD_TIMEOUT_S, deadline_s=SHARD_DEADLINE_S)
        wall = time.perf_counter() - t0
        for i, spec in enumerate(SHARD_RUNS):
            label, algo, comp = spec[:3]
            su, dq = FOLDS_PER_ROUND.get(algo, {None: (1, 0), "int8": (0, 1)})[comp]
            expected = {"fed_direction": SHARD_ROUNDS * K, "server_update": SHARD_ROUNDS * su,
                        "dequant_update": SHARD_ROUNDS * dq}
            for r in range(n):
                if ranks[r][i]["launches"] != expected:
                    fail(f"{label} on {n} {backend} ranks: rank {r} launched "
                         f"{ranks[r][i]['launches']}, expected {expected}")
                if r and not _planes_diff(np, ranks[r][i], ranks[0][i])[1]:
                    fail(f"{label} on {n} {backend} ranks: rank {r} differs from rank 0")
            diff, same, close = _planes_diff(np, ranks[0][i], plain[i])
            if not close:
                fail(f"{label} on {n} {backend} ranks vs unsharded on the card: max |diff| "
                     f"{diff:.3e} beyond rtol {PARITY_RTOL} atol {PARITY_ATOL}")
            loss = ranks[0][i]["metrics"]["loss"]
            if not np.isfinite(loss).all():
                fail(f"{label} on {n} {backend} ranks: non-finite loss {loss}")
            row = {"run": label, "ranks": n, "backend": backend, "rounds": SHARD_ROUNDS,
                   "launches_per_rank": ranks[0][i]["launches"], "ranks_equal": True,
                   "vs_unsharded": "bitwise" if same else f"max |diff| {diff:.3e}",
                   "ms_per_round": ranks[0][i]["seconds"] / SHARD_ROUNDS * 1e3,
                   "unsharded_ms_per_round": plain[i]["seconds"] / SHARD_ROUNDS * 1e3,
                   "loss": loss.tolist()}
            say(f"sharded rounds ({where}): {json.dumps(row)}")
        say(f"sharded world of {n} {backend} ranks: {wall:.1f} s wall (start-up included)")


def serve_rank(rank, device, work):
    """A rank of phase 4f (d): ``run_federated`` at the CLI defaults with
    ``cohort_shard`` 2 for ``SERVE_ROUNDS`` rounds, a snapshot every
    ``SERVE_CKPT_EVERY``, once without and once with ``serve`` (rank 0 the
    fleet)."""
    import torch

    from repro_torch.configs.base import FedConfig
    from repro_torch.launch.fed_train import run_federated

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = FedConfig(participation="bernoulli", rounds=SERVE_ROUNDS, cohort_shard=2)
    out = {}
    for serve in (False, True):
        t0 = time.perf_counter()
        acc, _ = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                               device=device, ckpt_every=SERVE_CKPT_EVERY,
                               ckpt_dir=str(Path(work) / f"serve{serve:d}"), serve=serve)
        out[serve] = {"acc": acc, "s": time.perf_counter() - t0}
    return out


def sharded_serve(torch, smi_line: str):
    """Phase 4f (d): the fleet loop of a sharded run — ``serve_rank`` on 2
    gloo ranks sharing cuda:0: the ``serve`` run's last snapshot equal
    plane for plane and byte for byte to the plain sharded run's; versions
    1-6 published (the params entering the run, then each snapshot's), the
    serving thread ending on version 6, the in-run health probe 200,
    ``fleet.check`` clean."""
    import shutil

    from repro_torch.fleet.check import check
    from repro_torch.fleet.telemetry import events, replay
    from repro_torch.launch.mesh import spawn_cohort

    work = ROOT / "build" / "smoke_shard_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks = spawn_cohort(serve_rank, 2, args=(str(work),), device="cuda", backend="gloo",
                         timeout_s=SHARD_TIMEOUT_S, deadline_s=SHARD_DEADLINE_S)
    wall = time.perf_counter() - t0
    planes = snapshots_equal(torch, work / "serve0" / f"step_{SERVE_ROUNDS}.msgpack",
                             work / "serve1" / f"step_{SERVE_ROUNDS}.msgpack")
    path = str(work / "serve1" / "telemetry.jsonl")
    _, rows, _ = replay(path)
    versions = [e["version"] for e in events(rows, "publish")]
    summary = events(rows, "serve_summary")[-1]
    probe = events(rows, "health_probe")[-1]
    fails = check(path, min_rounds=SERVE_ROUNDS, require_health=True)
    if (versions != list(range(1, SERVE_ROUNDS // SERVE_CKPT_EVERY + 2))
            or summary["served_version"] != versions[-1]
            or probe["status"] != 200 or fails or (work / "serve0" / "telemetry.jsonl").exists()):
        fail(f"sharded fleet loop: versions {versions}, serve summary {summary}, health probe "
             f"{probe}, check {fails}")
    shutil.rmtree(work)
    say(f"sharded fleet loop (2 gloo ranks sharing cuda:0, rank 0 the fleet): {len(planes)} "
        f"planes of the --serve run's round-{SERVE_ROUNDS} snapshot bitwise equal to the plain "
        f"sharded run's; versions {versions}, served version {summary['served_version']} "
        f"({summary['swaps']} hot-swaps over {summary['steps']} steps); health "
        f"{probe['status']}; fleet.check clean; s a run on rank 0 plain "
        f"{ranks[0][False]['s']:.3f} / serve {ranks[0][True]['s']:.3f}; final test_acc "
        f"{ranks[0][True]['acc']:.4f}; {wall:.1f} s wall; {smi_line}")


def cohort_sharding(torch, np, su_kernel, smi_line: str, nccl_only: bool = False):
    """Phase 4f: (a) the fold on column shards, (b) whole sharded rounds on
    2 and 4 gloo ranks sharing cuda:0, (c) the same over NCCL on 2 and
    ``min(4, device_count)`` cards when there are two or more.
    ``nccl_only`` (``--nccl``) runs (c) and the unsharded runs it is
    compared with, nothing else."""
    t0 = time.perf_counter()
    register_user_specs()  # SHARD_RUNS holds one
    if not nccl_only:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(19)
        shard_fold_cases(torch, su_kernel, gen)
    plain = [shard_run(torch, spec, torch.device("cuda"), None)
             for spec in SHARD_RUNS[:1] + SHARD_RUNS][1:]  # the first is a warm-up
    if not nccl_only:
        sharded_worlds(torch, np, SHARD_WORLDS, "gloo", plain)
        sharded_serve(torch, smi_line)
    cards = torch.cuda.device_count()
    if cards >= 2:
        sharded_worlds(torch, np, sorted({2, min(4, cards)}), "nccl", plain)
    elif nccl_only:
        fail(f"--nccl needs two or more cards; {cards} visible")
    else:
        say(f"nccl: not run ({cards} card visible)")
    unregister_user_specs()
    say(f"cohort sharding: phase 4f in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------- phase 4g
# the specs registered at runtime (``user_specs``) with their (fed_direction,
# server_update) launches a round: K local steps through the kernel for an
# affine direction row, none for a direction_fn; one fold row, or one
# mean-only fold launch a plane for a server_fn
USER_SPEC_LAUNCHES = {"_test_damped": (K, 1), "_test_escape": (0, 1), "_test_mixed": (K, 1)}
# the FedCM blend oracle's cases (the reference's tests/test_kernels.py):
# sizes, the hyper-parameter edges at n = 333, and the bf16-x case (bitwise)
BLEND_SIZES = (5, 1023, 64 * 1024 + 3)
BLEND_EDGES = ((0.0, 0.1), (1.0, 0.1), (0.1, 0.0), (0.37, 1.3))
BLEND_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 2e-2), "edges": (1e-6, 1e-6)}
# (script, arguments) of examples/torch, run on the card as subprocesses at
# the reference's defaults (serve_model: its docstring's two calls)
EXAMPLES = (("quickstart", []), ("fed_comparison", []),
            ("serve_model", ["--arch", "mamba2-1.3b"]),
            ("serve_model", ["--arch", "gemma3-12b", "--gen", "48"]),
            ("lm_pretrain", ["--tiny"]))


def user_specs():
    """Three specs as a user registers them: the reference's affine
    ``_test_damped`` (tests/test_registry.py: damped SGD with a proximal
    pull), ``_test_escape`` with both escape hatches (each client's
    normalized gradient, not elementwise, and an averaging ``server_fn``),
    and ``_test_mixed``: an affine direction with that ``server_fn``
    (tests/test_cohort_shard.py)."""
    import torch

    from repro_torch.core.registry import AlgorithmSpec, DirectionRow, FoldPass

    def normalized(cfg, m, cst, x, x0, g):
        return g / (torch.sqrt(torch.sum(g * g)) + 1e-12)

    def averaging(cfg, params, server, mean_delta, mean_sd, mean_extra, n_active, eta_l):
        return params + cfg.eta_g * mean_delta, server._replace(round=server.round + 1)

    return (
        AlgorithmSpec(name="_test_damped", direction_row=DirectionRow(c_g=0.7, c_x=0.05),
                      fold=(FoldPass("delta", c_mm=0.0,
                                     c_md=lambda cfg, e, n: -1.0 / (e * cfg.local_steps),
                                     c_xd=lambda cfg, e, n: cfg.eta_g),)),
        AlgorithmSpec(name="_test_escape", direction_row=None, direction_fn=normalized,
                      fold=(), server_fn=averaging),
        AlgorithmSpec(name="_test_mixed", direction_row=DirectionRow(), server_fn=averaging),
    )


def register_user_specs() -> None:
    from repro_torch.core.registry import register_algorithm

    for spec in user_specs():
        register_algorithm(spec, override=True)


def unregister_user_specs() -> None:
    from repro_torch.core.registry import unregister_algorithm

    for spec in user_specs():
        unregister_algorithm(spec.name)


def ring_d1_is_sync(torch, np, cfg) -> None:
    """``PAIR_ROUNDS`` rounds of the ring at D = 1, S = 0 against the sync
    loop on the card: params, momentum and every metric bit for bit."""
    from repro_torch.core.engine import metrics_to_host

    outs = []
    for ring in (None, (1, 0)):
        eng, state, data = fresh_engine(torch, cfg)
        state, ms = run_engine(eng, state, data, PAIR_ROUNDS, ring)
        outs.append((state, metrics_to_host(ms)))
    (sa, ma), (sb, mb) = outs
    if not (torch.equal(sa.params, sb.params) and torch.equal(sa.server.momentum,
                                                              sb.server.momentum)
            and all(np.array_equal(ma[f], mb[f]) for f in ma if f in mb)):
        fail(f"{cfg.algo}: the ring at D=1 S=0 is not the sync loop bit for bit on the card")


def user_spec_runs(torch, np, bindings):
    """(a) Each of ``user_specs`` registered, then ``run_federated`` at the
    CLI defaults for ``ROUNDS`` rounds with the launch counts set to 0 just
    before and read just after (``USER_SPEC_LAUNCHES``), a finite loss and
    its accuracy; card vs CPU over 3 injected rounds; the ring at D = 1,
    S = 0 ≡ sync.  Unregistered after.  Returns each run's launches."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.launch.fed_train import run_federated

    register_user_specs()
    paths = {}
    for name, (fd, su) in USER_SPEC_LAUNCHES.items():
        cfg = FedConfig(algo=name, participation="bernoulli", rounds=ROUNDS)
        expected = {"fed_direction": ROUNDS * fd, "server_update": ROUNDS * su,
                    "dequant_update": 0, "flash_attention": 0, "ssd_scan": 0}
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        losses = log.column("loss")
        if not all(np.isfinite(losses)):
            fail(f"{name}: non-finite loss {losses}")
        if launches != expected:
            fail(f"{name}: launch counts {launches}, expected {expected}")
        diffs = card_vs_cpu(torch, np, name)
        ring_d1_is_sync(torch, np, cfg)
        row = {"spec": name, "rounds": ROUNDS, "launches": launches, "losses": losses,
               "final_test_acc": acc, "wall_s": wall, "card_vs_cpu_max_abs": diffs,
               "ring_d1_s0": "bitwise the sync loop"}
        say(f"user spec {json.dumps(row)}")
        paths[f"user_spec{name}"] = launches
    unregister_user_specs()
    return paths


def fedcm_over_cnn(torch, np, bindings, smi_line: str):
    """(b) FedCM over ``cnn_classifier`` (GroupNorm, P = 22,058) on
    ``make_synthetic_images`` at its defaults, Dirichlet 0.6, the CLI's
    federated defaults (N 100, Bernoulli 10 %, K 10, B 50) for ``ROUNDS``
    rounds with the launch counts set to 0 just before and read just after;
    a finite loss whose last round is below its first, the test accuracy
    beside the partition's ``heterogeneity_score``, the steady ms a round of
    ``ROUNDS`` more; card vs CPU over 3 injected rounds.  Returns the
    launches."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import FederatedEngine, FlatSpec, make_eval_fn
    from repro_torch.core.engine import metrics_to_host
    from repro_torch.data import (
        FederatedData, dirichlet_partition, heterogeneity_score, make_synthetic_images,
    )
    from repro_torch.models.small import classification_loss, cnn_classifier

    cfg = FedConfig(participation="bernoulli", rounds=ROUNDS)
    x_tr, y_tr, x_te, y_te = make_synthetic_images(seed=0)
    hetero = heterogeneity_score(y_tr, dirichlet_partition(y_tr, cfg.num_clients, 0.6, seed=0),
                                 10)
    data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0, device="cuda")
    model = cnn_classifier()
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          device="cuda")
    state = eng.init(params, torch.Generator(device="cuda").manual_seed(1))
    for b in bindings.values():
        b.launches = 0
    t0 = time.perf_counter()
    state, ms = eng.run_rounds(state, data, ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: b.launches for k, b in bindings.items()}
    expected = {"fed_direction": ROUNDS * K, "server_update": ROUNDS, "dequant_update": 0,
                "flash_attention": 0, "ssd_scan": 0}
    losses = metrics_to_host(ms)["loss"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"FedCM over the CNN: losses {losses.tolist()} (finite, the last below the first)")
    if launches != expected:
        fail(f"FedCM over the CNN: launch counts {launches}, expected {expected}")
    acc = make_eval_fn(model.apply)(eng.spec.unravel(state.params),
                                    torch.as_tensor(x_te, device="cuda"),
                                    torch.as_tensor(y_te, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = eng.run_rounds(state, data, ROUNDS)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
    diffs = card_vs_cpu(torch, np, "fedcm", cnn=True)
    row = {"model": "cnn_classifier (32, 64), GroupNorm 8", "P": eng.spec.size,
           "rounds": ROUNDS, "launches": launches, "first_loss": float(losses[0]),
           "last_loss": float(losses[-1]), "final_test_acc": acc,
           "heterogeneity_score": hetero, "wall_s": wall, "steady_ms_per_round": steady_ms,
           "card_vs_cpu_max_abs": diffs}
    say(f"FedCM over the CNN: {json.dumps(row)}; {smi_line}")
    return launches


def fedcm_blend_on_card(torch, fd_kernel):
    """(c) ``fed_direction``'s kernel at FedCM's coefficients ``(η_l, α, 0,
    1−α)`` against the blend oracle ``fedcm_step_ref``: the reference
    test's sizes in f32 and bf16 and its hyper-parameter edges within
    ``BLEND_TOL``, bf16 x with f32 g and Δ bit for bit, and the main plane
    (a (25, 22026) cohort, Δ broadcast) within the f32 tolerance."""
    from repro_torch.kernels.fedcm_update import fedcm_step_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def case(label, x, g, d, alpha, eta, tol):
        coefs = torch.tensor([eta, alpha, 0.0, 1.0 - alpha], device="cuda")
        out = fd_kernel.fed_direction_flat(x, g, [d], coefs)
        ref = fedcm_step_ref(x, g, d, alpha, eta)
        err = float((out.float() - ref.float()).abs().max())
        ok = out.dtype == x.dtype and (torch.equal(out, ref) if tol is None else
                                       torch.allclose(out.float(), ref.float(), rtol=tol[0],
                                                      atol=tol[1]))
        return {"case": label, "shape": list(x.shape), "x": str(x.dtype).split(".")[-1],
                "max_abs_err": err, "bitwise": torch.equal(out, ref), "ok": ok}

    rows = []
    for n in BLEND_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            rows.append(case(f"n={n}", randn(n, dtype=dtype), randn(n, dtype=dtype),
                             randn(n, dtype=dtype), 0.1, 0.05, BLEND_TOL[name]))
    for alpha, eta in BLEND_EDGES:
        rows.append(case(f"alpha={alpha} eta={eta}", randn(333), randn(333), randn(333), alpha,
                         eta, BLEND_TOL["edges"]))
    rows.append(case("bf16 x, f32 g and delta", randn(4097, dtype=torch.bfloat16), randn(4097),
                     randn(4097, scale=1e-3), 0.1, 0.05, None))
    rows.append(case("main plane, delta broadcast", randn(MAIN_C, MAIN_P), randn(MAIN_C, MAIN_P),
                     randn(MAIN_P), 0.1, 0.1, BLEND_TOL["float32"]))
    for r in rows:
        say(f"fedcm blend {json.dumps(r)}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"fed_direction at FedCM's coefficients disagrees with fedcm_step_ref: {bad}")
    say(f"fedcm blend: the fed_direction kernel meets fedcm_step_ref in all {len(rows)} cases "
        f"({sum(r['bitwise'] for r in rows)} bitwise)")


def examples_on_card() -> None:
    """(d) ``EXAMPLES`` as subprocesses on the card, all at once: each must
    exit 0; its last lines are printed."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = [[sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"), *args]
            for name, args in EXAMPLES]
    t0 = time.perf_counter()
    outs = run_all(cmds, env, 600)
    wall = time.perf_counter() - t0
    for (name, args), (rc, out, err) in zip(EXAMPLES, outs):
        if rc != 0:
            fail(f"example {name} {' '.join(args)} exited {rc}: {out[-1500:]} {err[-3000:]}")
        tail = [l for l in out.strip().splitlines() if l.strip()][-4:]
        say(f"example {name} {' '.join(args)}: exit 0; last lines: " + " | ".join(tail))
    say(f"examples: {len(EXAMPLES)} subprocesses on the card at once, {wall:.1f} s wall")


def public_api(torch, np, bindings, fd_kernel, smi_line: str):
    """Phase 4g: (a) the specs registered at runtime, (b) FedCM over the
    CNN, (c) the FedCM blend oracle, (d) the examples.  Returns each
    path's launches for the kernels line's ``launches_by_path``."""
    t0 = time.perf_counter()
    paths = user_spec_runs(torch, np, bindings)
    paths["cnn"] = fedcm_over_cnn(torch, np, bindings, smi_line)
    fedcm_blend_on_card(torch, fd_kernel)
    examples_on_card()
    say(f"public API: phase 4g in {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------- phase 4h
def tree_direction(cfg, m, cst, x, x0, g):
    """The runtime spec's direction: the gradient over its whole norm.  On
    the tree path it sees one client's leaf trees, on the flat path its
    ``(P,)`` plane (a one-leaf tree): the same function of the same
    numbers."""
    from repro_torch.utils.trees import tree_leaves, tree_map

    n = sum((a * a).sum() for a in tree_leaves(g)).sqrt() + 1e-12
    return tree_map(lambda a: a / n, g)


def tree_spec():
    from repro_torch.core.registry import AlgorithmSpec, FoldPass

    return AlgorithmSpec(
        name=TREE_SPEC, direction_row=None, direction_fn=tree_direction,
        fold=(FoldPass("delta", c_mm=0.0, c_md=lambda cfg, e, n: -1.0 / (e * cfg.local_steps),
                       c_xd=lambda cfg, e, n: cfg.eta_g),))


def tree_round_inputs(torch, np, cfg, data, dev):
    """``TREE_ROUNDS`` rounds of injected draws (ids, masks, minibatch
    indices, full batches) on ``dev``, the same numbers on every device."""
    from repro_torch.core.engine import RoundInputs, cohort_capacity
    from repro_torch.data import gather_full_client_batch, gather_round_batches

    cap = cohort_capacity(cfg)
    rng = np.random.default_rng(8)
    out = []
    for _ in range(TREE_ROUNDS):
        ids = torch.as_tensor(rng.permutation(cfg.num_clients)[:cap], device=dev)
        mask = torch.as_tensor(np.arange(cap) < rng.binomial(cfg.num_clients, 0.1), device=dev)
        idx = rng.integers(0, data.n_per_client, size=(cap, cfg.local_steps, 50))
        batches = gather_round_batches(data.client_x, data.client_y, None, ids,
                                       cfg.local_steps, 50, idx=torch.as_tensor(idx))
        full = gather_full_client_batch(data.client_x, data.client_y, ids)
        out.append(RoundInputs(batches, ids, mask, full_batches=full))
    return out


def tree_planes(torch, np, bindings, algo, dev, flat):
    """``TREE_ROUNDS`` rounds of ``algo`` on ``dev`` from one converted state
    (the CLI's MLP and task, a nonzero momentum), on the tree path or the
    flat one, on the injected draws of ``tree_round_inputs``.  Returns the
    final planes, the tree path's raveled, and the launches of the rounds
    (the card's tree path must launch none)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import (
        params_from_numpy, params_to_numpy, state_from_numpy, tree_state_from_numpy,
    )
    from repro_torch.core.engine import FederatedEngine
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier

    cfg = FedConfig(algo=algo, participation="bernoulli", use_flat_plane=flat,
                    **ALGO_SETTINGS.get(algo, {}))
    model = mlp_classifier((32, 128, 128, 10))
    if dev not in TREE_TASK:  # the task, the start state and the data, made once a device
        x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
        params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
        momentum = [{k: (0.01 * v).astype(np.float32) for k, v in layer.items()}
                    for layer in params_to_numpy(model.init(torch.Generator().manual_seed(4)))]
        TREE_TASK[dev] = (params, momentum, FlatSpec.from_tree(params_from_numpy(params)),
                          FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6,
                                        seed=3, device=dev))
    params, momentum, tree, data = TREE_TASK[dev]  # tree: to ravel the tree path's state
    if flat:
        state, spec = state_from_numpy(params, cfg, momentum=momentum, device=dev)
    else:
        state, spec = tree_state_from_numpy(params, cfg, momentum=momentum, device=dev), None
    eng = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
    counted = dev == "cuda"  # the CPU's runs go on beside the card's and count nothing
    if counted:
        for b in bindings.values():
            b.launches = 0
    for inp in tree_round_inputs(torch, np, cfg, data, dev):
        state, _ = eng.round_step(state, inp.batches, inp.ids, inp.mask,
                                  full_batches=inp.full_batches)
    launches = {k: b.launches for k, b in bindings.items()} if counted else {}

    def ravel(t, **kw):
        return None if t is None else t if flat else tree.ravel(t, **kw)

    return {"params": ravel(state.params), "momentum": ravel(state.server.momentum),
            "second_moment": ravel(state.server.second_moment),
            "client_states": ravel(state.client_states, batch_dims=1)}, launches


def tree_vs_flat(torch, np, bindings, algo, cpu_planes):
    """One spec on the card: the tree path (launch counts 0) against the
    card's flat kernel path and against the CPU's tree path
    (``cpu_planes``, computed beside it).  Returns the relative L2 of every
    plane the spec has."""
    card_tree, launches = tree_planes(torch, np, bindings, algo, "cuda", False)
    if any(launches.values()):
        fail(f"tree path {algo}: launched kernels {launches}")
    card_flat, _ = tree_planes(torch, np, bindings, algo, "cuda", True)
    out = {"vs_flat": {}, "vs_cpu": {}}
    for key, t in card_tree.items():
        if t is None:
            continue
        for other, limit, name in ((card_flat, TREE_VS_FLAT, "vs_flat"),
                                   (cpu_planes, TREE_VS_CPU, "vs_cpu")):
            rel = rel_l2(torch, t, other[key])
            out[name][key] = rel
            if not rel <= limit:
                fail(f"tree path {algo} on the card: {key} {name} relative L2 {rel:.3e} > "
                     f"{limit}")
    return out


def tree_mixed_dtypes(torch, np, bindings):
    """A tree of a bf16 and an f32 leaf on the tree path, card vs CPU:
    ``TREE_ROUNDS`` FedCM rounds of the tests' quadratic, no launch, the
    bf16 leaf back in f32 after the server step (as in the reference)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.engine import FederatedEngine

    def loss(params, batch):
        d = params["w"].to(torch.float32)[:, None, :] - batch["c"]
        return 0.5 * (d ** 2).sum(-1).mean(-1) + 0.5 * (params["b"].to(torch.float32) ** 2).mean(-1)

    rng = np.random.default_rng(9)
    w, b = rng.normal(size=(4096,)), rng.normal(size=(1024,))
    c = rng.normal(size=(4, 2, 8, 4096)).astype(np.float32)  # (C, K, B, 4096)
    cfg = FedConfig(algo="fedcm", num_clients=8, cohort_size=4, local_steps=2,
                    participation="fixed", use_flat_plane=False)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = FederatedEngine(cfg, loss, None, device=dev)
        st = eng.init({"w": torch.tensor(w, dtype=torch.bfloat16),
                       "b": torch.tensor(b, dtype=torch.float32)})
        for bd in bindings.values():
            bd.launches = 0
        for _ in range(TREE_ROUNDS):
            st, _ = eng.round_step(st, {"c": torch.tensor(c, device=dev)},
                                   torch.arange(4, device=dev),
                                   torch.ones(4, dtype=torch.bool, device=dev))
        if dev == "cuda" and any(bd.launches for bd in bindings.values()):
            fail("tree path, mixed dtypes: launched a kernel")
        if st.params["w"].dtype != torch.float32:
            fail(f"tree path, mixed dtypes: the bf16 leaf came back {st.params['w'].dtype}")
        out[dev] = st
    rel = {k: rel_l2(torch, out["cuda"].params[k], out["cpu"].params[k]) for k in ("w", "b")}
    if not max(rel.values()) <= TREE_BF16_VS_CPU:
        fail(f"tree path, mixed dtypes: card vs CPU relative L2 {rel} > {TREE_BF16_VS_CPU}")
    return rel


def tree_ms_per_round(torch, bindings):
    """FedCM at the main path's widths: ms a round of the tree path and of
    the flat kernel path in one call (``TREE_TIMED`` rounds after 2 warm-up,
    synchronized), and the tree path's launches in those rounds."""
    from repro_torch.configs.base import FedConfig

    out = {}
    for name, flat in (("flat", True), ("tree", False)):
        cfg = FedConfig(algo="fedcm", participation="bernoulli", use_flat_plane=flat)
        eng, state, data = fresh_engine(torch, cfg)
        state, _ = eng.run_rounds(state, data, 2)
        torch.cuda.synchronize()
        for b in bindings.values():
            b.launches = 0
        t0 = time.perf_counter()
        state, _ = eng.run_rounds(state, data, TREE_TIMED)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / TREE_TIMED
        out[f"{name}_launches"] = {k: b.launches for k, b in bindings.items()}
    if any(out["tree_launches"].values()):
        fail(f"tree path: launched {out['tree_launches']} in its timed rounds")
    return out


def tree_path_and_contracts(torch, np, bindings, smi_line: str):
    """Phase 4h: the per-leaf tree path on the card — the eleven registered
    specs and a runtime spec whose ``direction_fn`` sees trees, each
    ``TREE_ROUNDS`` rounds against the card's flat kernel path
    (``TREE_VS_FLAT``) and the tree path on the CPU (``TREE_VS_CPU``) with
    no kernel launched; a mixed bf16/f32 tree; the tree path's ms a round
    beside the flat path's — and, beside them in a subprocess, the
    analysis contracts' full matrix on the card
    (``python -m repro_torch.analysis.trace --device cuda``)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import repro_torch.core.algorithms  # noqa: F401  (the builtin specs register on import)
    from repro_torch.core.registry import list_algorithms, register_algorithm, unregister_algorithm

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    trace = subprocess.Popen([sys.executable, "-m", "repro_torch.analysis.trace",
                              "--device", "cuda"], cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        register_algorithm(tree_spec(), override=True)
        try:
            algos = list_algorithms()
            if len(algos) != 12:
                fail(f"phase 4h: {len(algos)} specs registered, expected the 11 builtin + 1")
            # the CPU's tree runs in a thread beside the card's (torch's CPU ops
            # release the interpreter lock)
            def on_cpu(a):
                out = tree_planes(torch, np, bindings, a, "cpu", False)[0]
                laps["cpu"] = time.perf_counter() - t0
                return out

            laps = {}
            with ThreadPoolExecutor(1) as pool:
                cpu = {a: pool.submit(on_cpu, a) for a in algos}
                rows = {}
                for a in algos:
                    rows[a] = tree_vs_flat(torch, np, bindings, a, cpu[a].result())
                    laps["card"] = time.perf_counter() - t0
        finally:
            unregister_algorithm(TREE_SPEC)
        for algo, row in rows.items():
            say(f"tree path on the card, {algo}, {TREE_ROUNDS} injected rounds, launches 0: "
                f"relative L2 {json.dumps(row)} (limits: vs the flat kernel path {TREE_VS_FLAT},"
                f" vs the CPU {TREE_VS_CPU})")
        say(f"tree path on the card, mixed bf16/f32 tree, launches 0: card vs CPU relative L2 "
            f"{json.dumps(tree_mixed_dtypes(torch, np, bindings))} (limit {TREE_BF16_VS_CPU})")
        ms = tree_ms_per_round(torch, bindings)
        say(f"tree path ms/round (fedcm, the main path's widths, {TREE_TIMED} rounds after 2 "
            f"warm-up): tree {ms['tree']:.3f} beside flat {ms['flat']:.3f}; launches "
            f"{json.dumps(ms['tree_launches'])} vs {json.dumps(ms['flat_launches'])}; "
            f"{smi_line}")
        text, _ = trace.communicate(timeout=300)
        laps["contracts"] = time.perf_counter() - t0
    finally:
        if trace.poll() is None:
            trace.kill()
            trace.wait()
    for line in text.strip().splitlines():
        say(f"contracts: {line}")
    if trace.returncode != 0:
        fail(f"python -m repro_torch.analysis.trace --device cuda exited {trace.returncode}")
    say(f"tree path and contracts: phase 4h in {time.perf_counter() - t0:.1f} s (ended: the "
        f"card's spec runs at {laps['card']:.1f} s, the CPU's at {laps['cpu']:.1f}, the "
        f"contracts' subprocess at {laps['contracts']:.1f})")


# ---------------------------------------------------------------------- phase 5
def card_vs_cpu(torch, np, algo="fedcm", cnn=False):
    """Three rounds of ``algo`` from one converted state on the card and on
    the CPU, with the same ids, masks, minibatch indices and full batches;
    every state plane the spec has within the parity tolerance.  The MLP on
    the CLI's task, or with ``cnn`` the GroupNorm CNN on synthetic images
    (phase 4g)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, cohort_capacity
    from repro_torch.data import (
        FederatedData, gather_full_client_batch, gather_round_batches,
        make_synthetic_classification, make_synthetic_images,
    )
    from repro_torch.models.small import classification_loss, cnn_classifier, mlp_classifier

    cfg = FedConfig(algo=algo, participation="bernoulli", **ALGO_SETTINGS.get(algo, {}))
    cap = cohort_capacity(cfg)
    if cnn:
        x_tr, y_tr, _, _ = make_synthetic_images(n_train=20_000, n_test=10, seed=3)
        model = cnn_classifier()
    else:
        x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
        model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(3)
    draws = []
    for _ in range(3):
        ids = rng.permutation(cfg.num_clients)[:cap]
        mask = np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)
        draws.append((ids, mask))
    out = {}
    for dev in ("cuda", "cpu"):
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3, device=dev)
        idx_rng = np.random.default_rng(4)
        state, spec = state_from_numpy(params, cfg, device=dev)
        eng = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
        for ids, mask in draws:
            idx = idx_rng.integers(0, data.n_per_client, size=(cap, cfg.local_steps, 50))
            ids_t = torch.as_tensor(ids, device=dev)
            batches = gather_round_batches(data.client_x, data.client_y, None, ids_t,
                                           cfg.local_steps, 50, idx=torch.as_tensor(idx))
            full = None
            if eng.algo.needs_full_grad:
                full = gather_full_client_batch(data.client_x, data.client_y, ids_t)
            state, _ = eng.round_step(state, batches, ids_t, torch.as_tensor(mask, device=dev),
                                      full_batches=full)
        out[dev] = state_to_numpy(state)
    res = {}
    for key in ("params", "momentum", "second_moment", "client_states"):
        a, b = out["cuda"][key], out["cpu"][key]
        if (a is None) != (b is None):
            fail(f"card vs CPU {algo}: {key} exists on one device only")
        if a is None:
            continue
        res[key] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"card vs CPU {algo}: {key} differ beyond rtol {PARITY_RTOL} atol "
                 f"{PARITY_ATOL} (max abs diff {res[key]:.3e})")
    return res


def card_vs_cpu_lossy(torch, np):
    """Three rounds under int8 + drops + NaN corruption + quarantine, with
    the port's own hash draws.  Each round starts on both devices from the
    card's state, with the same ids, masks and minibatch indices, so a
    floor flip of the stochastic rounding cannot compound.  The int8 planes
    of both devices are recorded: every element may differ by at most one
    level (a flip), and params / momentum may differ beyond the parity
    tolerance only by the flips' quanta."""
    import repro_torch.core.engine as engine_mod
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.core.compress import COMPRESS_STREAM, PLANE_STREAMS
    from repro_torch.core.convert import params_to_numpy, state_from_numpy
    from repro_torch.core.engine import FederatedEngine, cohort_capacity, local_learning_rate
    from repro_torch.data import FederatedData, gather_round_batches, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier
    from repro_torch.utils import draws

    cfg = FedConfig(participation="bernoulli",
                    compression=CompressionConfig(kind="int8", seed=0),
                    fault=FaultConfig(drop_rate=0.1, corrupt_rate=0.1, corrupt_mode="nan", seed=0))
    cap = cohort_capacity(cfg)
    ids = torch.arange(cap) * 4
    for stream, n in ((1, None), (3, None), (COMPRESS_STREAM + PLANE_STREAMS["delta"], MAIN_P)):
        on_card = draws.uniform(0, torch.tensor(7, device="cuda"), stream, ids.cuda(), n)
        if not torch.equal(on_card.cpu(), draws.uniform(0, torch.tensor(7), stream, ids, n)):
            fail(f"hash draws of stream {stream} differ between the card and the CPU")

    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
    model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    state, spec = state_from_numpy(params, cfg, device="cuda")
    data, engs = {}, {}
    for dev in ("cuda", "cpu"):
        data[dev] = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3,
                                  device=dev)
        engs[dev] = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
    recorded = {}
    original = engine_mod.compress_plane

    def recording(comp, plane, u=None):
        rep = original(comp, plane, u)
        recorded[plane.device.type] = rep
        return rep

    rng = np.random.default_rng(5)
    rows = []
    engine_mod.compress_plane = recording
    try:
        for t in range(3):
            ids_np = rng.permutation(cfg.num_clients)[:cap]
            mask_np = np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)
            idx = torch.as_tensor(rng.integers(0, data["cuda"].n_per_client,
                                               size=(cap, cfg.local_steps, 50)))
            outs = {}
            for dev in ("cuda", "cpu"):
                st = state if dev == "cuda" else state._replace(
                    params=state.params.cpu(),
                    server=state.server._replace(momentum=state.server.momentum.cpu(),
                                                 round=state.server.round.cpu()))
                ids_t = torch.as_tensor(ids_np, device=dev)
                batches = gather_round_batches(data[dev].client_x, data[dev].client_y, None,
                                               ids_t, cfg.local_steps, 50, idx=idx)
                outs[dev] = engs[dev].round_step(st, batches, ids_t,
                                                 torch.as_tensor(mask_np, device=dev))
            (card, m_card), (cpu, m_cpu) = outs["cuda"], outs["cpu"]
            for f in ("n_active", "n_dropped", "n_quarantined"):
                if float(getattr(m_card, f)) != float(getattr(m_cpu, f)):
                    fail(f"card vs CPU (int8 + faults) round {t}: {f} differs")
            q_card, q_cpu = recorded["cuda"], recorded["cpu"]
            dq = (q_card.q.cpu().to(torch.int32) - q_cpu.q.to(torch.int32)).abs()
            flips = int((dq != 0).sum())
            if int(dq.max()) > 1 or flips > 1e-3 * dq.numel():
                fail(f"card vs CPU (int8 + faults) round {t}: {flips} int8 elements differ, "
                     f"max by {int(dq.max())} levels")
            n_active = max(float(m_cpu.n_active), 1.0)
            quanta = (dq.float() * q_cpu.scale).sum(dim=0) / n_active  # (P,) f32
            eta_l = float(local_learning_rate(cfg, torch.tensor(t)))
            worst = 0.0
            for key, a, b, coef in (
                    ("params", card.params.cpu(), cpu.params, cfg.eta_g),
                    ("momentum", card.server.momentum.cpu(), cpu.server.momentum,
                     1.0 / (eta_l * cfg.local_steps))):
                diff = (a - b).abs()
                allowed = PARITY_ATOL + PARITY_RTOL * b.abs() + 1.001 * coef * quanta
                if bool((diff > allowed).any()):
                    fail(f"card vs CPU (int8 + faults) round {t}: {key} differ beyond the "
                         f"tolerance plus the flips' quanta (max abs diff "
                         f"{float(diff.max()):.3e})")
                worst = max(worst, float(diff.max()))
            rows.append({"round": t, "n_active": float(m_cpu.n_active),
                         "n_dropped": float(m_cpu.n_dropped),
                         "n_quarantined": float(m_cpu.n_quarantined),
                         "flips": flips, "elements": dq.numel(), "max_abs_diff": worst})
            state = card
    finally:
        engine_mod.compress_plane = original
    return rows


def card_vs_cpu_ring(torch, np, algo):
    """Six launches of the async ring at D = 2, S = 1, γ = 0.9 from one
    converted state (a nonzero momentum, so the stale broadcast matters)
    on the card and on the CPU, with the same injected ids, masks,
    minibatch indices and full batches; every state plane the spec has
    within the parity tolerance after the drain."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.convert import params_to_numpy, state_from_numpy, state_to_numpy
    from repro_torch.core.engine import FederatedEngine, RoundInputs, cohort_capacity
    from repro_torch.data import (
        FederatedData, gather_full_client_batch, gather_round_batches,
        make_synthetic_classification,
    )
    from repro_torch.models.small import classification_loss, mlp_classifier

    cfg = FedConfig(algo=algo, participation="bernoulli", staleness_discount=RING_GAMMA,
                    **ALGO_SETTINGS.get(algo, {}))
    cap = cohort_capacity(cfg)
    x_tr, y_tr, _, _ = make_synthetic_classification(n_train=20_000, n_test=10, seed=3)
    model = mlp_classifier((32, 128, 128, 10))
    params = params_to_numpy(model.init(torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(6)
    momentum = (0.01 * rng.normal(size=MAIN_P)).astype(np.float32)
    draws = [(rng.permutation(cfg.num_clients)[:cap],
              np.arange(cap) < rng.binomial(cfg.num_clients, 0.1)) for _ in range(6)]
    out = {}
    for dev in ("cuda", "cpu"):
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=3, device=dev)
        idx_rng = np.random.default_rng(7)
        state, spec = state_from_numpy(params, cfg, momentum=momentum, device=dev)
        eng = FederatedEngine(cfg, classification_loss(model.apply), spec, device=dev)
        inputs = []
        for ids, mask in draws:
            idx = idx_rng.integers(0, data.n_per_client, size=(cap, cfg.local_steps, 50))
            ids_t = torch.as_tensor(ids, device=dev)
            full = None
            if eng.algo.needs_full_grad:
                full = gather_full_client_batch(data.client_x, data.client_y, ids_t)
            inputs.append(RoundInputs(
                gather_round_batches(data.client_x, data.client_y, None, ids_t,
                                     cfg.local_steps, 50, idx=torch.as_tensor(idx)),
                ids_t, torch.as_tensor(mask, device=dev), full_batches=full))
        it = iter(inputs)
        state, _, _ = eng.run_rounds_async_on(state, lambda _: next(it), len(draws),
                                              pipeline_depth=2, staleness=1)
        out[dev] = state_to_numpy(state)
    res = {}
    for key in ("params", "momentum", "second_moment", "client_states"):
        a, b = out["cuda"][key], out["cpu"][key]
        if (a is None) != (b is None):
            fail(f"card vs CPU ring {algo}: {key} exists on one device only")
        if a is None:
            continue
        res[key] = float(np.max(np.abs(a - b)))
        if not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            fail(f"card vs CPU ring {algo}: {key} differ beyond rtol {PARITY_RTOL} atol "
                 f"{PARITY_ATOL} (max abs diff {res[key]:.3e})")
    return res


# ---------------------------------------------------------------------- phase D
def dryrun_entries(nccl: bool) -> list:
    """Phase D's entries, ``(name, what, kwargs)``: ``what`` is ``"dryrun"``
    (``launch.dryrun.run_one``), ``"fed"`` (``launch.fed_dryrun.run``) or
    ``"classifier"`` (``fed_dryrun.run_classifier``, the main path).  No
    flop counter (``exec_only``): phase 9 compares launches, census and
    peaks.  Each ``"dryrun"`` holds its weights in the dtype the card's
    phase runs them in (``card_weights``; the dry-run's default is the
    reference's bf16), ``fed_dryrun`` in f32 by default, as the card."""
    serve = dict(data=1, model=1, shape_name="prefill_32k", batch=4, seq=1024, gen=32,
                 sessions=2, exec_only=True)
    cuts = {arch: cut for arch, cut, _ in SERVE_ARCHS}
    if nccl:
        from repro_torch.configs.base import get_config
        from repro_torch.launch import federated_llm

        run = GROUP_FED_RUN
        fed = dict(data=1, model=MP_FULL_RANKS, rounds=run["rounds"], cohort=run["cohort"],
                   local_steps=run["local_steps"], batch=run["batch"], seq=run["seq"],
                   n_clients=run["n_clients"], n_seqs=federated_llm.N_SEQS, eta_l=0.05,
                   cfg_overrides={"n_layers": get_config(FED_LM_FULL).n_layers}, exec_only=True)
        return ([(f"6b {DRY_MP} rank {r}", "dryrun",
                  dict(serve, arch=DRY_MP, model=MP_FULL_RANKS, rank=r,
                       cfg_overrides=dict(MP_FULL)[DRY_MP],
                       overrides=card_weights(DRY_MP, dict(MP_FULL)[DRY_MP])))
                 for r in range(MP_FULL_RANKS)]
                + [(f"8 (h) rank {r}", "fed", dict(fed, rank=r)) for r in range(MP_FULL_RANKS)])
    train_cut = {"dtype": "float32", "vocab_size": TRAIN_VOCAB, **dict(TRAIN_VS_CPU)[DRY_TRAIN]}
    return ([(f"serve {arch}", "dryrun", dict(serve, arch=arch, cfg_overrides=cuts[arch],
                                              sessions=1, decode_steps=1,
                                              overrides=card_weights(arch, cuts[arch])))
             for arch in DRY_SERVE]
            + [(f"train {DRY_TRAIN}", "dryrun",
                dict(arch=DRY_TRAIN, shape_name="train_4k", data=1, model=1, batch=TRAIN_B,
                     seq=TRAIN_S, steps=2, exec_only=True,
                     overrides={"remat": "none", "microbatches": 1, "learning_rate": TRAIN_LR,
                                **card_weights(DRY_TRAIN, train_cut)},
                     cfg_overrides=train_cut)),
               ("main path", "classifier", {})])


def card_weights(arch: str, cut: dict) -> dict:
    """The dry-run's knobs override that holds its weights in the dtype the
    card's phase holds them in: the init's, ``arch``'s config cut by ``cut``
    (its ``param_dtype``)."""
    from repro_torch.configs.base import get_config

    return {"param_dtype": replace(get_config(arch), **cut).param_dtype}


def dryrun_entry(entry) -> tuple:
    """One entry of phase D, in a worker of the subprocess (no card)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    name, what, kw = entry
    if what == "dryrun":
        from repro_torch.launch.dryrun import run_one
        res = run_one(**kw, out=None, quiet=True)
    elif what == "fed":
        from repro_torch.launch import fed_dryrun
        res = fed_dryrun.run(**kw, out=None, quiet=True)
    else:
        from repro_torch.configs.base import FedConfig
        from repro_torch.launch import fed_dryrun
        res = fed_dryrun.run_classifier(FedConfig(participation="bernoulli", rounds=ROUNDS),
                                        eval_every=EVAL_EVERY, exec_only=True)
    keep = ("launches", "parallel_counts", "peak_bytes", "memory", "blas_workspace_bytes",
            "host_reads", "seconds",
            "flops_per_device", "op_bytes_per_device", "collective_bytes_per_device")
    return name, {k: res.get(k) for k in keep}


def dryrun_subprocess(path: str, nccl: bool) -> int:
    """``--dryrun-entries PATH``: every entry of ``dryrun_entries`` in a pool
    of spawned workers (one process an entry), their results to ``PATH``."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    entries = dryrun_entries(nccl)
    with ProcessPoolExecutor(max_workers=DRY_JOBS_NCCL if nccl else DRY_JOBS,
                             mp_context=mp.get_context("spawn"), max_tasks_per_child=1) as ex:
        out = dict(ex.map(dryrun_entry, entries))
    Path(path).write_text(json.dumps({"entries": out, "seconds": time.perf_counter() - t0}))
    return 0


def start_dryrun(nccl: bool) -> dict:
    """Phase D: start the dry-run subprocess on the CPU (``CUDA_VISIBLE_DEVICES``
    empty: it sees no card), in a session of its own, killed with its
    workers when this script exits."""
    import atexit
    import os
    import signal
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    log = open(work / "dryrun.log", "w")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, str(Path(__file__).resolve()), "--dryrun-entries",
           str(work / "dryrun.json")] + (["--nccl"] if nccl else [])
    proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()
        for f in work.iterdir():
            f.unlink()
        work.rmdir()

    atexit.register(stop)
    say(f"phase D: dry-run subprocess started on the CPU ({len(dryrun_entries(nccl))} entries, "
        f"pid {proc.pid})")
    return {"proc": proc, "work": work, "started": time.perf_counter()}


def witness_base(torch) -> int:
    """The card's allocated bytes before a phase whose peak phase 9 holds to
    the dry-run's, the peak stats reset: torch's cuBLAS workspaces are
    freed first, so that the phase takes its own, as the dry-run counts
    them (``hlo_stats.blas_workspace_bytes``), and the cache emptied."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return base


def peak_in_band(card: int, dry: int) -> bool:
    return DRY_PEAK_LO * dry <= card <= DRY_PEAK_HI * dry + DRY_PEAK_SLACK


def dryrun_witness(dry: dict, smi_line: str) -> None:
    """Phase 9's comparison: wait for phase D, then hold each entry's kernel
    launches and each rank's collective census to what the card's run
    counted (``DRY_CARD``), exactly, and the card's peak to the dry-run's
    within the band; print the ratio of every entry.  Fails on any miss."""
    from repro_torch.launch.hlo_stats import comparable_counts

    proc = dry["proc"]
    try:
        proc.wait(timeout=DRY_WAIT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase D: the dry-run subprocess did not end within {DRY_WAIT_S:.0f} s")
    tail = (dry["work"] / "dryrun.log").read_text()[-4000:]
    if proc.returncode != 0:
        fail(f"phase D: the dry-run subprocess exited {proc.returncode}:\n{tail}")
    got = json.loads((dry["work"] / "dryrun.json").read_text())
    entries = got["entries"]
    say(f"phase D: {len(entries)} dry-runs in {got['seconds']:.1f} s of the subprocess "
        f"(ended {time.perf_counter() - dry['started']:.1f} s after it started)")
    misses = []
    for name, card in DRY_CARD.items():
        d = entries.get(name)
        if d is None:
            misses.append(f"{name}: no dry-run entry")
            continue
        per = card.get("per", 1)  # the card ran the dry-run's entry this many times
        want = {k: v for k, v in card["launches"].items() if v}
        pred = {k: v * per for k, v in d["launches"].items() if v}
        row = {"entry": name, "launches": pred, "launches_ok": pred == want,
               "peak_card": card["peak"], "peak_dry": d["peak_bytes"],
               "peak_dry_blas_workspaces": d["blas_workspace_bytes"],
               "peak_ratio": card["peak"] / d["peak_bytes"] if d["peak_bytes"] else None,
               "peak_in_band": peak_in_band(card["peak"], d["peak_bytes"]),
               "host_reads": d["host_reads"], "dry_s": d["seconds"]}
        if not row["launches_ok"]:
            misses.append(f"{name}: launches {pred} predicted, the card counted {want}")
        if "counts" in card:
            row["counts"] = d["parallel_counts"]
            row["counts_ok"] = d["parallel_counts"] == comparable_counts(card["counts"])
            if not row["counts_ok"]:
                misses.append(f"{name}: census {d['parallel_counts']} predicted, the card's "
                              f"ParallelContext.counts {comparable_counts(card['counts'])}")
        if not row["peak_in_band"]:
            misses.append(f"{name}: card peak {card['peak']} B outside [{DRY_PEAK_LO}, "
                          f"{DRY_PEAK_HI}] x the dry-run's {d['peak_bytes']} B + "
                          f"{DRY_PEAK_SLACK} B")
        say(f"dry-run witness: {json.dumps(row)}; {smi_line}")
    if misses:
        fail("phase 9, dry-run witness: " + "; ".join(misses))
    say(f"dry-run witness: {len(DRY_CARD)} entries, launches and census equal to the card's "
        f"counts, every peak in the band")


# ---------------------------------------------------------------------- main
def main() -> int:
    if "--dryrun-entries" in sys.argv[1:]:  # phase D's subprocess (no card)
        return dryrun_subprocess(sys.argv[sys.argv.index("--dryrun-entries") + 1],
                                 "--nccl" in sys.argv[1:])
    import torch

    t_start = time.perf_counter()

    def lap(phase: str) -> None:  # where the script's time goes, phase by phase
        say(f"clock: phase {phase} ended at {time.perf_counter() - t_start:.1f} s")

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    # ---- 1. device check
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say(smi_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
        f"TF32 off for matmul and cudnn; total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B")
    nccl = "--nccl" in sys.argv[1:]
    dry = None
    if nccl or not {"--tree-only", "--grid-only"} & set(sys.argv[1:]):
        dry = start_dryrun(nccl)  # phase D, beside every card phase

    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.fed_direction import kernel as fd_kernel
    from repro_torch.kernels.fed_direction import ref as fd_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.server_update import kernel as su_kernel
    from repro_torch.kernels.server_update import ref as su_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    bindings = {"fed_direction": fd_kernel.KERNEL, "server_update": su_kernel.KERNEL,
                "dequant_update": su_kernel.DEQUANT_KERNEL,
                "flash_attention": fa_kernel.KERNEL, "ssd_scan": ssd_kernel.KERNEL}

    # ---- 2. build (one nvcc per source, started together)
    t0 = time.perf_counter()
    built = build_all(sorted({b.source for b in bindings.values()}))
    say(f"build: {time.perf_counter() - t0:.1f} s wall")
    for name, info in built.items():
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", info["log"])]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", info["log"]))
        say(f"  {name}: {info['seconds']:.1f} s -> {info['path'].name}; "
            f"{len(regs)} instantiations, registers/thread {min(regs, default=0)}"
            f"-{max(regs, default=0)}, spill bytes {spills}")
    for name, b in bindings.items():
        b.load()
        say(f"  bound {name}: {b.symbol} in {b.source}.cu")
    for name, info in built.items():
        funcs = sass_counts(info["path"], {"HMMA": r"\bHMMA\b", "UBLKCP": r"\bUBLKCP",
                                           "LDL": r"\bLDL\b", "STL": r"\bSTL\b"})
        counts = {k: c["HMMA"] for k, c in funcs}
        say(f"  HMMA per kernel in {name}: {json.dumps(counts)}")
        if name in ("flash_attention", "ssd_scan"):  # spills show as local loads / stores
            say(f"  local memory (LDL / STL) per kernel in {name}: "
                f"{json.dumps({k: [c['LDL'], c['STL']] for k, c in funcs})}")
        mma = {k: v for k, v in counts.items() if "_mma_kernel" in k}
        if name in ("flash_attention", "ssd_scan") and (not mma or min(mma.values()) == 0):
            fail(f"{name}: a bf16 tensor-core kernel has no HMMA instruction: {counts}")
        if name == "server_update":  # every fold instantiation stages its plane by bulk copies
            bulk = [c["UBLKCP"] for k, c in funcs if k == "fold_kernel"]
            say(f"  UBLKCP (bulk copy global -> shared) per fold_kernel instantiation in {name}: "
                f"{len(bulk)} instantiations, {min(bulk, default=0)}-{max(bulk, default=0)} each")
            if not bulk or min(bulk) == 0:
                fail(f"{name}: a fold kernel has no bulk-copy (UBLKCP) instruction: {bulk}")
    lap("2")

    if "--nccl" in sys.argv[1:]:
        # phase 4f (c) alone, then the model group's full runs, on a machine with four cards;
        # --groups-only: phases 8 (g) and (h) alone
        if torch.cuda.device_count() < MP_FULL_RANKS:
            fail(f"--nccl runs the model group on {MP_FULL_RANKS} cards; "
                 f"{torch.cuda.device_count()} visible")
        four_card_paths = {}
        if "--witness-only" in sys.argv[1:]:
            # phase D's four-card entries alone: 6b's DRY_MP, 8 (h), then phase 9's comparison
            model_group_four_cards(torch, np, smi_line, cases=((DRY_MP, dict(MP_FULL)[DRY_MP]),))
            lap("6b (nccl)")
            group_fed_four_cards(torch, np, smi_line)
            lap("8 (h)")
            dryrun_witness(dry, smi_line)
            lap("9 (dry-run witness)")
            say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                   "kind": torch.cuda.get_device_name(0),
                                                   "count": torch.cuda.device_count()}}))
            return 0
        if "--groups-only" not in sys.argv[1:]:
            cohort_sharding(torch, np, su_kernel, smi_line, nccl_only=True)
            lap("4f (c)")
            moe_reference = model_group_four_cards(torch, np, smi_line)
            lap("6b (nccl)")
            # (m): zamba2-7b at long_500k's cache on 1 x 4, 4 x 1 and 2 x 2
            paths, _ = serve_grid_layouts(torch, np, smi_line, LONG_ARGS, LONG_LAYOUTS, {},
                                          name="long context", limit=LONG_REL_L2)
            four_card_paths.update(paths)
            lap("(m)")
            # (n): dbrx-132b (16 of 40) on 2 x 2 in the serve layout against MP_FULL's 1 x 4
            paths, _ = serve_grid_layouts(
                torch, np, smi_line, ["--arch", "dbrx-132b", *SERVE_ARGS], (MOE_GRID,),
                dict(MP_FULL)["dbrx-132b"], name="moe grid", reference=moe_reference,
                limit=None)
            four_card_paths.update(paths)
            cut = dict(MP_FULL)["dbrx-132b"]
            say(f"dbrx-132b (16 of 40) a rank's share: the serve layout on 2 x 2 "
                f"{serve_share_gb('dbrx-132b', cut, 2, 2):.2f} GB, the model group of 4 "
                f"{serve_share_gb('dbrx-132b', cut, 1, 4):.2f} GB")
            lap("(n)")
            say("four-card serving launches by path: " + json.dumps(four_card_paths))
        torch.cuda.empty_cache()
        g_run = group_train_four_cards(torch, np, smi_line)
        lap("8 (g)")
        h_run = group_fed_four_cards(torch, np, smi_line)
        lap("8 (h)")
        grid_train_four_cards(torch, np, smi_line, g_run)
        grid_snapshot_four_cards(torch, smi_line)
        lap("8 (k)")
        grid_fed_four_cards(torch, np, smi_line, h_run)
        lap("8 (l)")
        dryrun_witness(dry, smi_line)  # the entries the card ran (--groups-only: 8 (h)'s)
        lap("9 (dry-run witness)")
        if DEFERRED:
            fail("; ".join(DEFERRED))
        for line in smi.stdout.strip().splitlines():
            say(line)
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0

    if "--tree-only" in sys.argv[1:]:  # phase 4h alone, on one card
        tree_path_and_contracts(torch, np, bindings, smi_line)
        lap("4h")
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0

    if "--grid-only" in sys.argv[1:]:  # phases 8 (i), (j), 6c and 6d alone, on one card
        grid_one_card(torch, np, smi_line)
        lap("8 (i)-(j), 6c, 6d")
        # the witness of (m)'s gate, and a rehearsal of (n), on 4 gloo ranks sharing cuda:0
        long_context_witness(torch, np, smi_line)
        serve_grid_layouts(torch, np, smi_line, ["--arch", "dbrx-132b", *SERVE_ARGS[:-4],
                                                 "--gen", "4", "--sessions", "1"],
                           ((1, 4, "fsdp"), MOE_GRID),
                           {"n_layers": 2, "n_experts": 4, "vocab_size": TRAIN_VOCAB},
                           backend="gloo", name="moe grid rehearsal", limit=None)
        lap("(m)-(n) rehearsal")
        if DEFERRED:
            fail("; ".join(DEFERRED))
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernels vs plain
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fd_cases, su_cases, dq_cases = [], [], []
    for C, P in ((MAIN_C, MAIN_P), (BIG_C, BIG_P)):
        for dtype in (torch.float32, torch.bfloat16):
            for n_aux in range(4):
                r = check_fed_direction(torch, fd_kernel, fd_ref, C, P, n_aux, dtype, gen)
                fd_cases.append(r)
                say(f"fed_direction {json.dumps(r)}")
        for layout in FD_LAYOUTS:
            r = check_fed_direction(torch, fd_kernel, fd_ref, C, P, None, torch.float32, gen,
                                    layout=layout)
            fd_cases.append(r)
            say(f"fed_direction {json.dumps(r)}")
        for m_dtype in (torch.float32, torch.bfloat16):
            for wx in (True, False):
                for wm in (True, False):
                    r = check_server_update(torch, su_kernel, su_ref, C, P, wx, wm, m_dtype, gen)
                    su_cases.append(r)
                    say(f"server_update {json.dumps(r)}")
        torch.cuda.empty_cache()
        for q_kind in ("int8", "bf16"):
            for m_dtype in (torch.float32, torch.bfloat16):
                for wx in (True, False):
                    for wm in (True, False):
                        r = check_dequant_update(torch, su_kernel, su_ref, C, P, q_kind, wx, wm,
                                                 m_dtype, gen)
                        dq_cases.append(r)
                        say(f"dequant_update {json.dumps(r)}")
        torch.cuda.empty_cache()
    su_edge, dq_edge = fold_edge_cases(torch, su_kernel, su_ref, gen)
    su_cases += su_edge
    dq_cases += dq_edge
    gamma_cases = fold_gamma_cases(torch, su_kernel, su_ref, gen)
    full = full_plane_cases(torch, fd_kernel, fd_ref, su_kernel, su_ref, gen, smi_line)
    fd_cases.append(full["fed_direction"])
    su_cases.append(full["server_update"])
    bad = [r for r in fd_cases + su_cases + dq_cases + gamma_cases if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    if not all(r["deterministic"] for r in su_cases + dq_cases + gamma_cases):
        fail("a fold kernel is not run-to-run deterministic")
    floor_ms = launch_floor_ms(torch)
    say(f"kernels vs plain: fed_direction within tolerance; server_update and dequant_update "
        f"bitwise equal to their plain versions and bitwise deterministic in all "
        f"{len(su_cases) + len(dq_cases)} cases ({len(su_edge) + len(dq_edge)} edge cases)")
    main_xm = [r for r in su_cases + dq_cases if (r["C"], r["P"], r["offset"]) == (MAIN_C, MAIN_P, 0)
               and r["write_x"] and r["write_m"] and r["m"] == "float32"]
    say(f"launch floor {floor_ms:.6f} ms (graph replay of a one-element fill_) beside the "
        f"main-plane folds, x and m written, m f32: " + ", ".join(
            f"{'server_update ' + r['d'] if 'd' in r else 'dequant_update ' + r['q']} "
            f"{r['ms']:.6f} ms" for r in main_xm))
    say(f"fold cases at gamma 0.9 and 0.81 (x and m written) bitwise equal to their plain "
        f"versions and deterministic in all {len(gamma_cases)} cases; ms beside gamma 1: "
        + "; ".join(gamma_line(r, su_cases + dq_cases) for r in gamma_cases))

    fa_cases, ssd_cases = [], []
    # (B, Sq, Skv, H, Hkv, hd, dtype, causal, window, q_offset, library): the
    # serving shape, a ragged one whose window and q_offset leave rows 29-76
    # no key, f32 with hd=128 without the causal mask, bf16 with hd=128
    # ragged and causal, bf16 without the causal mask (GQA, Sq ≠ Skv); then
    # the other archs' shapes, each beside SDPA: gemma3's serving shape
    # (hd 256), its local layer past the window, the f32 route at hd 256,
    # zamba2's shared block (hd 112, padded to 128), qwen3 (40 / 8 heads) and
    # seamless' encoder (16 / 16 heads, hd 64, bidirectional)
    for B, Sq, Skv, H, Hkv, hd, dtype, causal, window, q_offset, library in (
            (4, 1024, 1024, 32, 8, 64, torch.bfloat16, True, None, 0, True),
            (2, 77, 50, 8, 2, 64, torch.bfloat16, True, 20, 40, False),
            (2, 333, 301, 16, 4, 128, torch.float32, False, None, 0, False),
            (2, 333, 333, 16, 4, 128, torch.bfloat16, True, None, 0, False),
            (2, 200, 300, 8, 2, 64, torch.bfloat16, False, None, 0, False),
            (4, 1024, 1024, 16, 8, 256, torch.bfloat16, True, None, 0, True),
            (2, 2048, 2048, 16, 8, 256, torch.bfloat16, True, 1024, 0, True),
            (2, 333, 301, 16, 8, 256, torch.float32, False, None, 0, True),
            (4, 1024, 1024, 32, 32, 112, torch.bfloat16, True, None, 0, True),
            (4, 1024, 1024, 40, 8, 128, torch.bfloat16, True, None, 0, True),
            (4, 1024, 1024, 16, 16, 64, torch.bfloat16, False, None, 0, True)):
        r = check_flash_attention(torch, fa_kernel, fa_ref, B, Sq, Skv, H, Hkv, hd, dtype,
                                  causal, window, q_offset, gen, library=library)
        fa_cases.append(r)
        say(f"flash_attention {json.dumps(r)}")
    # mamba2's serving shape, a ragged S, S < L in f32 and bf16, zamba2's
    # serving shape (112 heads, N = 64)
    for B, S, H, P, N, L, dtype in ((4, 1024, 64, 64, 128, 64, torch.bfloat16),
                                    (2, 1000, 64, 64, 128, 64, torch.bfloat16),
                                    (2, 40, 16, 64, 128, 64, torch.float32),
                                    (2, 40, 16, 64, 128, 64, torch.bfloat16),
                                    (4, 1024, 112, 64, 64, 64, torch.bfloat16)):
        r = check_ssd_scan(torch, ssd_kernel, ssd_ref, B, S, H, P, N, L, dtype, gen)
        ssd_cases.append(r)
        say(f"ssd_scan {json.dumps(r)}")
    torch.cuda.empty_cache()
    bad = [r for r in fa_cases + ssd_cases if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    if fa_cases[1]["rows_without_keys"] == 0:
        fail("the ragged flash_attention case was meant to have rows without keys")
    say(f"kernels vs plain: flash_attention and ssd_scan within {LM_KERNEL_TOL} "
        f"(rtol, atol relative to the largest plain value)")

    say(f"device memory allocated after phase 3: {torch.cuda.memory_allocated()} B")
    lap("3")

    # ---- 4. main path and the lossy-uplink paths, launch counts from each run only
    from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
    from repro_torch.launch.fed_train import run_federated

    base = FedConfig(participation="bernoulli", rounds=ROUNDS)
    lm = {"flash_attention": 0, "ssd_scan": 0}  # the LM kernels stay off the federated paths
    paths = {
        "uncompressed": (base, {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                                "dequant_update": 0, **lm}),
        "int8": (replace(base, compression=CompressionConfig(kind="int8")),
                 {"fed_direction": ROUNDS * K, "server_update": 0, "dequant_update": ROUNDS,
                  **lm}),
        "topk": (replace(base, compression=CompressionConfig(kind="topk")),
                 {"fed_direction": ROUNDS * K, "server_update": ROUNDS, "dequant_update": 0,
                  **lm}),
        "faults": (replace(base, fault=FaultConfig(drop_rate=0.1, corrupt_rate=0.1,
                                                   corrupt_mode="nan")),
                   {"fed_direction": ROUNDS * K, "server_update": ROUNDS,
                    "dequant_update": 0, **lm}),
    }
    path_launches, path_acc = {}, {}
    for name, (cfg, expected) in paths.items():
        for b in bindings.values():
            b.launches = 0
        base = witness_base(torch)
        t0 = time.perf_counter()
        acc, log = run_federated(cfg, 0.6, eval_every=EVAL_EVERY, seed=0, echo=False,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: b.launches for k, b in bindings.items()}
        if name == "uncompressed":  # phase D's witness
            DRY_CARD["main path"] = {"launches": launches,
                                     "peak": torch.cuda.max_memory_allocated() - base}
        for row in log.rows:
            say(f"{name} path: " + " ".join(f"{k}={v}" for k, v in row.items() if v is not None))
        losses = log.column("loss")
        if not all(np.isfinite(losses)):
            fail(f"{name} path: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{name} path: final loss {losses[-1]} not below the first {losses[0]}")
        if not acc > 0.1:
            fail(f"{name} path: test accuracy {acc} not above chance (0.1)")
        if launches != expected:
            fail(f"{name} path launch counts {launches}, expected {expected}")
        say(f"{name} path: {ROUNDS} rounds in {wall:.3f} s (set-up and eval included), "
            f"launches {launches}, final test_acc {acc:.4f}")
        path_launches[name], path_acc[name] = launches, acc
    if abs(path_acc["int8"] - path_acc["uncompressed"]) > 0.02:
        fail(f"int8 test accuracy {path_acc['int8']} not within 0.02 of the uncompressed "
             f"run's {path_acc['uncompressed']}")
    launches = {"fed_direction": path_launches["uncompressed"]["fed_direction"],
                "server_update": path_launches["uncompressed"]["server_update"],
                "dequant_update": path_launches["int8"]["dequant_update"]}

    steady = {}
    for name, (cfg, _) in paths.items():
        s_round, eng, state, data, host = steady_seconds_per_round(torch, cfg)
        steady[name] = s_round
        if not np.isfinite(host["loss"]).all() or not torch.isfinite(state.params).all():
            fail(f"{name} path: non-finite loss or params in the steady-state rounds")
        wire = eng.payload_bytes()["up_per_client"]
        if not np.array_equal(host["bytes_up"], host["n_active"] * np.float32(wire)):
            fail(f"{name} path: bytes_up is not n_active x {wire}")
        if name == "int8" and wire != MAIN_P + 4:
            fail(f"int8 path: {wire} uplink bytes per client, expected {MAIN_P + 4}")
        if name == "faults" and not (host["n_dropped"].sum() > 0
                                     and host["n_quarantined"].sum() > 0):
            fail("faults path: no client dropped or quarantined in the steady-state rounds")
        say(f"{name} path: steady state {s_round * 1e3:.3f} ms/round (mean of {ROUNDS} "
            f"rounds after 2 warm-up, synchronized); uplink {wire} B/client; dropped "
            f"{host['n_dropped'].sum():.0f}, quarantined {host['n_quarantined'].sum():.0f}")
        if name == "uncompressed":
            main_eng = (eng, state, data)
    say(f"steady ms/round: int8 {steady['int8'] * 1e3:.3f} beside uncompressed "
        f"{steady['uncompressed'] * 1e3:.3f} (topk {steady['topk'] * 1e3:.3f}, faults "
        f"{steady['faults'] * 1e3:.3f})")
    s_per_round = steady["uncompressed"]
    eng, state, data = main_eng

    dev_ms = device_ms_per_round(torch, eng, state, data)
    if dev_ms is None:
        say("main path: device time per round not measured")
    else:
        busy = dev_ms / (s_per_round * 1e3)
        say(f"main path: device time {dev_ms:.3f} ms/round (median of 11, no host "
            f"gaps) -> device busy share {busy:.4f}, idle share {1 - busy:.4f}")
    if "--profile" in sys.argv[1:]:
        profile_rounds(torch, eng, state, data)
    lap("4")

    # ---- 4b. the other nine algorithms, launch counts from each run only
    algo_rows = other_algorithms(torch, np, bindings)
    say("other algorithms, steady ms/round: " + ", ".join(
        f"{r['algo']}{'' if r['uplink'] == 'f32' else ' ' + r['uplink']} "
        f"{r['steady_ms_per_round']:.3f}" for r in algo_rows))
    lap("4b")

    # ---- 4c. the async ring, launch counts from each run only
    ring_rows = async_ring(torch, np, bindings)
    say("async ring, steady ms/round beside its sync twin measured before and after it: "
        + ", ".join(f"{r['algo']}{'' if r['uplink'] == 'f32' else ' ' + r['uplink']} "
                    f"D={r['D']} S={r['S']} {r['steady_ms_per_round']:.3f} (sync "
                    f"{r['sync_twin_ms_per_round'][0]:.3f} / {r['sync_twin_ms_per_round'][1]:.3f})"
                    for r in ring_rows))
    lap("4c")

    # ---- 4d. the host store at fleet scale, and store pairs on the card
    host_store_fleet(torch, np, bindings)
    say(f"bitwise pairs on the card: {bitwise_pairs_on_card(torch, np)} (4 store vs resident, "
        f"2 store vs resident under int8 / topk, 1 ring D=1 vs sync for scaffold int8)")
    lap("4d")

    # ---- 4e. checkpoint and fleet, launch counts from each run only
    checkpoint_and_fleet(torch, np, bindings)
    lap("4e")

    # ---- 4f. cohort sharding, launch counts from each rank's runs only
    cohort_sharding(torch, np, su_kernel, smi_line)
    lap("4f")

    # ---- 4g. the public API on the card, launch counts from each run only
    api_paths = public_api(torch, np, bindings, fd_kernel, smi_line)
    lap("4g")

    # ---- 4h. the per-leaf tree path (no kernel) and the analysis contracts
    tree_path_and_contracts(torch, np, bindings, smi_line)
    lap("4h")

    # ---- 5. card vs CPU
    diffs = card_vs_cpu(torch, np)
    say(f"card vs CPU over 3 injected rounds: max |diff| params {diffs['params']:.3e}, "
        f"momentum {diffs['momentum']:.3e} (rtol {PARITY_RTOL}, atol {PARITY_ATOL})")
    for row in card_vs_cpu_lossy(torch, np):
        say(f"card vs CPU, int8 + faults, hash draws: {json.dumps(row)}")
    say("card vs CPU, int8 + faults: draws bitwise equal on both devices; params and "
        "momentum within the tolerance plus one quantum per floor flip")
    lap("5")

    # ---- 5b. card vs CPU, the other nine algorithms
    for algo in OTHER_ALGOS:
        say(f"card vs CPU, {algo}, 3 injected rounds: max |diff| "
            f"{json.dumps(card_vs_cpu(torch, np, algo))} (rtol {PARITY_RTOL}, "
            f"atol {PARITY_ATOL})")
    lap("5b")

    # ---- 5c. card vs CPU under the async ring
    for algo in ("fedcm", "scaffold", "fedadam", "mimelite"):
        say(f"card vs CPU, ring D=2 S=1 gamma {RING_GAMMA}, {algo}, 6 injected launches: max "
            f"|diff| {json.dumps(card_vs_cpu_ring(torch, np, algo))} (rtol {PARITY_RTOL}, "
            f"atol {PARITY_ATOL})")
    lap("5c")

    # ---- 6. serving at full width, launch counts from each run only
    serving = serve_full_width(torch, np, bindings)
    for arch in ("llama3.2-1b", "mamba2-1.3b"):
        say(f"decode step: {json.dumps(decode_step_breakdown(torch, arch))}")
    for name in ("flash_attention", "ssd_scan"):  # summed over the serving runs
        launches[name] = sum(r["launches"][name] for r in serving.values())
    lap("6")

    # ---- 6b. the model group on one card, launch counts from each rank's runs only
    mp_launches = model_group_one_card(torch, np)
    mp_fa, mp_ssd = model_group_kernels(torch, fa_kernel, fa_ref, ssd_kernel, ssd_ref, gen)
    fa_cases += mp_fa
    ssd_cases += mp_ssd
    lap("6b")

    # ---- 7. card vs CPU, serving
    for arch, cut in CARD_VS_CPU:
        say(f"card vs CPU serving: {json.dumps(serve_card_vs_cpu(torch, np, arch, cut))}")
    say(f"card vs CPU serving: {json.dumps(encdec_card_vs_cpu(torch, np, *ENCDEC_VS_CPU))}")
    lap("7")

    # ---- 8. training: card vs CPU, then at full width, launch counts from each run only
    t0 = time.perf_counter()
    for arch, cut in TRAIN_VS_CPU:
        row = train_card_vs_cpu(torch, np, bindings, arch, cut)
        say(f"card vs CPU training: {json.dumps(row)}")
    say(f"card vs CPU training: phase 8 (a) in {time.perf_counter() - t0:.1f} s")
    lap("8 (a)")
    train_full_width(torch, np, bindings)
    lap("8 (b)")
    # (c) and (d): FedCM over an LM, card vs CPU, then at full width
    by_path = {"main": launches, **api_paths}
    by_path["fed_lm_vs_cpu"] = fed_lm_card_vs_cpu(torch, np, bindings, smi_line)
    lap("8 (c)")
    by_path["fed_lm_full"] = fed_lm_full_width(torch, np, bindings, smi_line)
    if "--profile" in sys.argv[1:]:
        fed_lm_step_profile(torch, smi_line)
    lap("8 (d)")
    # (e) and (f): training and FedCM rounds on a model group, ranks sharing the card
    # (i), (j), 6c and 6d: training, FedCM rounds, serving published params and serving on a
    # grid; its world of 4 ranks and (e)-(f)'s of 2 at once
    group_paths, grid_serve = both_group_worlds_one_card(torch, np, smi_line)
    by_path.update(group_paths)
    lap("8 (e)-(f), (i)-(j), 6c, 6d")

    # ---- 9. summary: first phase D's dry-run against the card's counts
    dryrun_witness(dry, smi_line)
    lap("9 (dry-run witness)")

    def main_case(cases, **sel):
        return next(r for r in cases if r["C"] == MAIN_C and r["P"] == MAIN_P
                    and all(r[k] == v for k, v in sel.items()))

    fd_main = main_case(fd_cases, n_aux=1, x="float32", layout="pool")
    su_main = main_case(su_cases, write_x=True, write_m=True, m="float32", offset=0, d="float32")
    dq_main = main_case(dq_cases, q="int8", write_x=True, write_m=True, m="float32", offset=0)
    kernels = []
    for name, src, replaces, main, cases in (
        ("fed_direction", "src/repro_torch/csrc/fed_direction.cu",
         "src/repro/kernels/fed_direction/kernel.py:53", fd_main, fd_cases),
        ("server_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:91", su_main, su_cases),
        ("dequant_update", "src/repro_torch/csrc/server_update.cu",
         "src/repro/kernels/server_update/kernel.py:211", dq_main, dq_cases),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:109", fa_cases[0], fa_cases),
        ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
         "src/repro/kernels/ssd_scan/kernel.py:92", ssd_cases[0], ssd_cases),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
        })
        if name in ("flash_attention", "ssd_scan"):  # serving unsharded, each group's, grid's ranks
            kernels[-1]["launches_by_path"] = {
                "serve": launches[name],
                **{f"model_group_{n}_ranks": per[name] for n, per in mp_launches.items()},
                **grid_serve.get(name, {})}
        if name in full:  # the federated LM's paths and its cohort plane beside the main one
            kernels[-1]["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
            kernels[-1]["full_plane"] = {k: full[name][k] for k in (
                "C", "P", "ms", "plain_ms", "bound_ms", "bound_by")}
    say(f"steady ms/round {s_per_round * 1e3:.3f}; eager ms/call fed_direction "
        f"{fd_main['eager_ms']:.4f}, server_update {su_main['eager_ms']:.4f}, "
        f"dequant_update {dq_main['eager_ms']:.4f}")
    say(smi_line)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def fresh_engine(torch, cfg, data=None):
    """An engine on ``cfg`` at the main path's widths on the card, its
    initialized state and its data (``FederatedData`` of the CLI's default
    task unless ``data`` is given)."""
    from repro_torch.core.engine import FederatedEngine
    from repro_torch.core.flat import FlatSpec
    from repro_torch.data import FederatedData, make_synthetic_classification
    from repro_torch.models.small import classification_loss, mlp_classifier

    if data is None:
        x_tr, y_tr, _, _ = make_synthetic_classification(n_train=50_000, n_test=10, seed=0)
        data = FederatedData(x_tr, y_tr, cfg.num_clients, dirichlet_alpha=0.6, seed=0,
                             device="cuda")
    model = mlp_classifier((32, 128, 128, 10))
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    return eng, eng.init(params, gen), data


def run_engine(eng, state, data, n, ring=None):
    """``n`` rounds of the sync loop, or of the async ring at ``ring = (D,
    S)`` (drained)."""
    if ring is None:
        return eng.run_rounds(state, data, n)
    return eng.run_rounds_async(state, data, n, pipeline_depth=ring[0], staleness=ring[1])


def steady_seconds_per_round(torch, cfg, ring=None, data=None):
    """Mean wall seconds per round of an engine on ``cfg`` at the main
    path's widths after warm-up, synchronized at both ends (host launch
    cost included); the async ring at ``ring = (D, S)`` counts its drain.
    Returns ``(s_per_round, engine, state, data, metrics)`` with the timed
    rounds' metrics on the host."""
    from repro_torch.core.engine import metrics_to_host

    eng, state, data = fresh_engine(torch, cfg, data)
    state, _ = run_engine(eng, state, data, 2, ring)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, ms = run_engine(eng, state, data, ROUNDS, ring)
    torch.cuda.synchronize()
    s_round = (time.perf_counter() - t0) / ROUNDS
    return s_round, eng, state, data, metrics_to_host(ms)


def device_ms_per_round(torch, eng, state, data, samples: int = 11) -> float:
    """Median device time of one main-path round with no host gaps: the
    card is held in ``torch.cuda._sleep`` while the host enqueues the round
    (nothing in a round waits on the device), so the events around the
    round time the kernels back to back.  Returns None (not measured) if
    the host could not finish enqueueing within the sleep: the reading
    would then include host time."""
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        torch.cuda._sleep(int(2e8))  # ~0.1 s at the H100's clock
        mid.record()
        state, _ = eng.run_round(state, data)
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        if host_s * 1e3 >= start.elapsed_time(mid):
            say(f"device-time probe: host took {host_s * 1e3:.1f} ms to enqueue a "
                f"round, longer than the {start.elapsed_time(mid):.1f} ms sleep")
            return None
        times.append(mid.elapsed_time(end))
    return statistics.median(times)


def device_profile(torch, enqueue):
    """``(device operations, their summed device ms)`` of the work
    ``enqueue()`` runs, from torch.profiler's device-side rows (kernels,
    copies, fills; the gaps between them are not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        enqueue()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows) / 1e3


def profile_rounds(torch, eng, state, data, n: int = 5) -> None:
    """``--profile``: device time by CUDA kernel over ``n`` main-path rounds
    (torch.profiler).  Only device-side kernel events are summed: the aten
    op rows carry their kernels' device time too and would count it twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        state, _ = eng.run_rounds(state, data, n)
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    say(f"profile: {n} rounds, kernel device time {total / n:.1f} us/round, "
        f"{sum(r[1] for r in rows) // n} kernel launches/round")
    for dev_us, count, key in rows[:12]:
        say(f"profile: {dev_us / n:9.1f} us/round {count // n:5d}/round  {key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
