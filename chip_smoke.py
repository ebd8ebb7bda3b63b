#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each of which raises (exit code 1) when it fails:

1. build the thirteen sources (fourteen kernels, one with a tail mode, and
   ``peer_window.cu``'s host calls, the RDMA rung's CUDA IPC) of
   ``mpi_and_open_mp_tpu_torch/csrc`` with nvcc, in parallel, each one's
   build seconds logged; for each kernel of ``flash_fwd`` and
   ``flash_hop_bwd`` its registers and spills (``-Xptxas -v``), and its
   ``HGMMA`` (``wgmma``) instructions in ``cuobjdump -sass`` of the
   library, which must not be 0 for the bf16 (tensor-core) kernels; for
   each of the ten ``stencil_padded_kernel<RULE, R>`` (each rule at its
   registered radius, 1 or lenia's 8, and its generic kernel, R = 0) its
   registers and spills, which must be 0, and for every registered stencil spec and
   lenia at r in {3, 55, the largest that fits} the CUDA runtime's
   registers, local bytes and shared memory of the kernel it launches
   (``stencil_padded_attributes``: ``cudaFuncGetAttributes``), the local
   bytes 0 and the dynamic size equal to ``native_stencil.smem_bytes``;
   for each of the nine ``bitlife_window_kernel<RT>`` its registers and
   spills, which must be 0, and for each shard window of phase 13 the
   geometry ``window_launch_geometry`` chooses at k = k_max with what the
   CUDA runtime reports for it (``bitlife_window_attributes``: registers,
   local bytes, shared memory, and the clusters the card holds at once,
   ``cudaOccupancyMaxActiveClusters``), the local bytes 0 and the dynamic
   size equal to the geometry's ``smem_bytes``; the same for each
   ``bitlife_vmem_cluster_kernel<RT, FULL>`` and the one-block
   ``bitlife_vmem_kernel``, and for p46gun_big's and a tall board's
   geometry (``vmem_launch_geometry``, ``bitlife_vmem_attributes``), which
   the card must place at least once; the same for the same cluster
   kernels and the one-block ``bitlife_vmem_batch_kernel`` of
   ``bitlife_vmem_batch``, and for the geometry
   ``vmem_batch_launch_geometry`` chooses for 4 and 64 boards of 500^2
   (``bitlife_vmem_batch_attributes``); the same for each
   ``bitlife_bitsliced_kernel<RT, CT, FULL, TAIL>`` (TAIL the pool's
   tail mode, each form the pool's geometries reach named), and for the
   geometry ``plan_bitsliced`` chooses for 64 and 512 boards of 500^2
   (``bitlife_bitsliced_attributes``); the same for each
   ``bitlife_fused_kernel<RT>``, and for the geometry
   ``fused_launch_geometry`` chooses at k_max for each frame of phase 3
   (``bitlife_fused_attributes``), with its waves and the words it steps
   over the useful ones;
2. ``bitlife_vmem`` against its plain PyTorch version on the card, packed
   words bit-exact, ghost and junk bits included, under the geometry
   ``vmem_launch_geometry`` chooses (each case logs it), at n in {0, 1, 7,
   g, g + 1, 129, 1000}: random soups at four shapes, and random words at
   ``VMEM_SHAPES`` (ny % 32 in {30, 31}, one word a column, the glider's
   board, one column, a board that takes the one-block geometry);
3. ``bitlife_fused`` against its plain version (the whole extended frame
   stepped as one window) on the card, packed words bit-exact, under every
   geometry family (``fused_families``: the chosen one, one tile, 2-D
   tiles, ghost zones, several segments, a strip of one, copied lanes):
   the runner at aligned 4096^2 and 16384^2 and the padded frames of
   10000^2 and 1000^2 at n in {1, g, g + 1, 128, 300}, and one launch over
   random words of a cart 2x2 shard of 10000^2 at k in {1, g, g + 1, 128};
4. ``bitlife_vmem_batch`` (B in {1, 3, 4, 7, 8, 16, 64}) and
   ``bitlife_bitsliced`` (B in {8, 33, 64, 256}) against their plain
   versions on the card, packed words bit-exact, at (500, 500), (37, 45)
   and (95, 130) and n in {0, 1, 13, 1000} and at each geometry's g and
   g + 1 steps (each case logs the geometry ``vmem_batch_launch_geometry``
   or ``plan_bitsliced`` chooses); the cell-packed kernel also under each
   geometry family forced at B = 4 (a cluster of 16, a cluster of 2, one
   block), on random words at a board that takes the one-block form
   (``VMEM_SHAPES``' 16400 x 24) and on a stack past the grid's y extent
   (70 000 boards of 1 x 8); the bitsliced kernel also at the degenerate
   extents 1x8, 8x1, 2x2, at B = 512 at 500^2, and at its halo and
   halo + 1 steps;
5. the main paths through ``LifeSim``, the CLI and the batcher, with every
   launch count set to 0 just before each and read just after:
   p46gun_big (``configs/gun_big_500x500.cfg``, all 10 000 steps, one
   launch of the resident kernel) against the NumPy oracle (population
   7288), then a
   10000^2 soup for 300 steps (the fused kernel on the padded frame)
   against the plain version's board from phase 3 and against 300 unpacked
   ``life_step_roll`` steps on the card, which share no code with the
   packed layout; then the CLI once as a subprocess. Then the batched
   paths: a 64-board stack (board 0 p46gun_big, 63 soups), all 10 000
   steps through ``"bitsliced"``, board 0 against the oracle and every
   board against the single-board ``bitlife_vmem`` kernel (a layout that
   shares no code with the board-sliced one); its first 4 boards through
   ``"vmem-grid"`` (its geometry logged), against the oracle and the
   bitsliced stack's first 4 boards; the CLI with ``--batch 64``
   (population 466 432); and
   the batcher on 40 p46gun_big-size soups at two step counts, each result
   against ``bitlife_vmem``;
6. times from CUDA events after a warm-up: each kernel at the main path's
   shapes beside its plain version and its bound (the resident kernel also
   by profiler device time, with its geometry and the bound for the SMs
   its blocks occupy, and so the board-sliced kernel, with the words it
   steps over the useful words, and the cell-packed stack kernel at the
   main path's 4 x 500^2 and at 64 x 500^2, with its geometry; the fused
   kernel by device time alone at the 10000^2 frame, 16384^2, 4096^2 and
   a cart 2x2 shard of 10000^2, with its geometry and the runner's us a
   step, the cart shard's the sharded LifeSim's), per-step
   rates from the difference of two step counts, the batched path's split
   into pack, kernel, unpack and the copy to the host, and both batched
   kernels side by side at B in ``BATCH_SWEEP`` x 500^2 and x 95x130 (where
   each wins), their boards compared;
7. ``stencil_padded`` against its plain version (``stencils.engine.
   step_padded``) on the card, every case bit for bit (max abs error 0.0,
   equal bits): every registered stencil spec, a ``make_lenia(3)`` and
   gray_scott as one 2-channel block, at (500, 500), (37, 45), (17, 23)
   and an extent smaller than the radius, over n in {1, 8} steps for the
   lenia specs and {1, 8, 100} for the rest; at interior widths 1, a
   strip - 1 and + 1 and a tile - 1 and + 1 (one step); a stack whose base
   is one board past a ``torus_pad`` result (an odd byte for uint8); life
   and wireworld on 64 x 500^2 stacks at n in {1, 8}, more boards than one
   wave of blocks holds, so each block steps several boards through the
   two staging buffers; and every kernel of the build: the rules
   registered at r = 1 at r = 2 and 8 (their generic kernels),
   ``make_lenia(1)``, and lenia at the largest radius that fits;
8. the stencil main paths, counts set to 0 just before each:
   ``run_padded_native_batch`` on 64 x 500^2 stacks - wireworld and heat for
   10 000 steps (every board against ``run_roll_batch`` on the card, board
   0 against the NumPy oracle at ``STENCIL_ORACLE_STEPS``), lenia for 1 000
   steps (in [0, 1], and 8 steps against the oracle and the roll engine);
   then ``LifeSim(workload="heat")`` at 500^2 for ``STENCIL_ORACLE_STEPS``
   steps and the batcher on mixed life, heat, wireworld and gray_scott
   requests, each against the NumPy oracle, and ``ActiveTileEngine`` on a
   mostly-dead 2048^2 Life board against the compiled one
   (``life_oracle``);
9. stencil times at 64 x 500^2 (gray_scott: one 500^2 board): the
   kernel per launch (CUDA events, and device time from a profiler
   trace; the earlier kernel's CUDA-event time from PERF.md in the log
   line only),
   the runner's us/step differenced over two
   step counts with its halo gather, the plain version per step, the
   bound, the float rules' FP32 issue bound (each multiply and add one
   instruction: no FMA may fuse them), and for heat and lenia
   ``torch.nn.functional.conv2d`` computing the aggregate alone (float32,
   TF32 off) as the library's yardstick; then a ``torch.profiler`` trace of
   10 runner steps for heat, lenia and gray_scott: device kernels and
   device busy time per step, and the device's idle share;
10. ``flash_fwd`` (``o`` and ``L``) and ``hop_block_grads`` (the
   ``flash_hop_dq`` and ``flash_hop_dkv`` kernels) against their plain
   versions on the card, at (2, 640, 64), (8, 1000, 128) (a ragged last
   tile) and (4, 2048, 128), causal and not, float32 (the FMA kernels)
   and bfloat16 (the tensor-core kernels), equal heads and GQA (h / 4 K/V
   heads: 8q/2kv at h = 8); a bf16 view that does not start on 16 bytes,
   which ``flash_fwd`` must refuse with a ValueError before any launch;
   then, each kernel having launched, its registers, spills and static
   and dynamic shared memory as the CUDA runtime reports them
   (``cudaFuncGetAttributes``), the dynamic size equal to the wrappers'
   ``smem_bytes``;
11. the attention main paths, counts set to 0 just before each: the
   attention CLI as a subprocess (``--variant flash --seq 8192 --heads 8
   --head-dim 128 --causal --dtype bfloat16 --grad``, its dense-oracle
   parity check on, its launch counts read from its stderr);
   ``flash_attention`` at 8 x 32768 x 128, causal, bfloat16, a forward and
   a full (q, k, v) gradient step, equal heads and GQA 8q/2kv, ``o``,
   ``L`` and the gradients against the plain chunked engine on the card;
   ``gated_parity_check(for_seq=32768)``, which must pass on the kernel
   engine with no notes;
12. attention times at 32k: chain-differenced forward (r = 1, 9) and grad
   step (r = 1, 3) seconds under the bench's names
   (``attention_32k_causal_sec`` ...), equal heads and GQA; each kernel
   per launch by CUDA events beside its plain version and its bound, each
   kernel's TFLOP/s on its own products (2 for the forward, 3 for dq, 4
   for dk/dv) and share of the bound; a ``torch.profiler`` trace of one
   32k grad step, device ms by kernel, which must show the tensor-core
   forward and hop kernels and no other; and
   ``torch.nn.functional.scaled_dot_product_attention`` forward, backward
   and both, K/V un-expanded under GQA (``enable_gqa``), as the library's
   yardstick (never on the port's path);
13. ``bitlife_window`` against its plain version on the card, packed words
   bit-exact, on stacked random windows at the shard shapes of phase 14
   (p46gun_big on row 8, col 8 and cart 4x2; the 1024^2 row-2 overlap
   split's interior and edges) and at ``WINDOW_EDGE_CASES`` for k in {1,
   7, k_max}, each under the geometry ``window_launch_geometry`` chooses,
   which must spread each main-path window over more than one block at
   k_max; a geometry with no compiled kernel must raise; the Life rule of
   ``stencil_padded`` (``life_step_padded_native``) against
   ``life_ops.life_step_padded`` on 1-padded shard stacks, uint8 and int32;
14. the sharded main paths through ``LifeSim`` on meshes of virtual shards
   of the card, counts set to 0 just before each run and read just after:
   p46gun_big, all 10 000 steps, ``bitfused`` on row 8, col 8 and cart 4x2
   (population 7288, boards equal to phase 5's serial ``bitlife_vmem``
   board, ``bitlife_window`` launched and ``bitlife_vmem`` not); the same
   board with ``impl="native"`` on row 4 and cart 4x2 (500 rows do not
   divide over 8 row shards, which ``native`` needs); ``halo`` and
   ``roll`` on cart 4x2 for 1 000 steps against the NumPy oracle; a 1024^2
   soup on row 2, stamped ``window+overlap:packed``, against the serial
   kernel; the 10000^2 soup of phase 3 on cart 2x2 (``tiled``: the fused
   kernel per shard) for 300 steps against phase 5's serial frame board;
   and the CLI once (``--layout cart --mesh 4,2 --virtual-devices 8``);
15. sharded times: ``bitlife_window`` per launch at each phase-13 shape
   (k = k_max) beside its plain version and its bound (the interior's
   words, for the card and for the SMs its blocks occupy), with its
   geometry, the Life rule
   of ``stencil_padded`` at the native path's shard stack beside its plain
   version and ``conv2d`` of the aggregate, all by device time from a
   profiler trace (CUDA events beside them); each sharded runner's us/step
   from the difference of two step counts, split by a profiler trace into
   the kernel and the ghost exchange, beside the serial resident kernel's
   us/step (phase 6); and each geometry that takes the overlap split
   against the same run under ``MOMP_HALO_OVERLAP=0``;
16. ``halo_edge_pair`` (the RDMA rung's ghost-pair kernel) against its
   plain version, two ring ``ppermute`` copies, on the card, bit-exact:
   uint8, int32, float32 and 2-channel float32 blocks, y and x edges, axis
   sizes 1, 2, 4 and 8 with the other axis 1 or 2, depths 1, 3 and 32;
   ``halo_frame`` (the rung's frame kernel) against its plain version,
   ``padded_round_block``, as raw bytes: the same dtypes on row, col and
   cart over 8x1, 1x8, 4x2 and 2x4 meshes at depths 1, 3 and a shard's
   extent (one past it refused), and strided blocks of 1-, 2-, 4- and
   8-byte elements (merged channel axes, padded rows, offsets 0-3, a
   column-strided block); then both at the shapes and strides that one
   round of each run of phase 17 hands them (recorded);
17. the RDMA rung on the main paths under ``MOMP_HALO_RDMA=1``, counts set
   to 0 just before each run and read just after: p46gun_big with
   ``native`` on row 4 and cart 4x2 (10 000 steps) and ``halo`` on cart 4x2
   (1 000 steps), each stamped ``overlap:rdma``, equal to the oracle, to
   phase 5's serial board and to phase 14's ``overlap:deferred`` board, its
   ``halo_frame`` and ``halo_edge_pair`` launches equal to the rounds times
   what a round of its plan makes (one frame a coupled round, one edge
   pair a partitioned sub-round); heat (100 steps) and lenia (r = 8, 8
   steps) through ``run_sharded`` on a 500^2 board on cart 4x2, coupled
   and ``:pb1``, bit-equal to the deferred schedule and within
   ``parity_tol_for("offset")`` of the oracle; the totals
   (``RUNG_LAUNCHES``); and the 1024^2 ``bitfused`` row-2 run under the
   flag, still stamped ``window+overlap:packed`` with no launch of either;
18. the rung's times: ``halo_frame`` per launch at the main paths' blocks
   and at a float32 (4, 2, 4096, 8192) stack, depth 32, against its bound
   (the block read once, the frame written once); ``halo_edge_pair`` at the
   partitioned runs' edges and at the float32 stack's y and x edges,
   against its bound (each edge byte read and written once); each beside
   its plain version, by profiler device time with CUDA events beside
   them; each rung geometry of phase 17 against ``overlap:deferred`` and
   ``seq:halo`` in the order rdma, deferred, seq, seq, deferred, rdma
   (us/step differenced, boards equal), and a profiler trace of each: the
   frame and edge-pair kernels, the Life rule and the other copies per
   step, device kernels per step, idle share;
19. checkpoints, resume and preemption on the main paths, counts set to
   0 just before each run and read just after (the files go under
   ``build/chip_smoke_checkpoints``, removed after): the recovery log
   empty after phases 1-18; p46gun_big serial ``native`` with
   ``checkpoint_every=2500`` (four ``bitlife_vmem`` launches, the files
   of steps 0, 2500, 5000 and 7500, the final board phase 5's, the step
   5000 file a straight 5000-step run's board), that file resumed with
   ``from_checkpoint`` on cart 4x2 ``bitfused`` (``bitlife_window``) and
   on row 4 ``native`` under ``MOMP_HALO_RDMA=1`` (``halo_frame`` and the
   Life rule), both ending on phase 5's board; the 10000^2 soup on the
   ``frame`` path (``bitlife_fused``), ``checkpoint_every=256``, 1280
   steps, a real SIGTERM sent by a wrapped ``step`` after its third
   segment (``Preempted.signum`` SIGTERM, the step 768 file flushed), the
   resume equal to a straight run; the CLI in a subprocess under
   ``MOMP_CHAOS="preempt=5000;noguard"`` (exit 75) and its ``--resume``
   (exit 0, population 7288); ``MOMP_GUARD=1`` on native cart 4x2 on the
   rung for 1000 steps (no recovery, the oracle's board); under
   ``halo=corrupt`` the guard's recovery (``life_step:native:recovered``,
   the oracle's board) and under ``halo=drop;noguard`` a board that
   differs from the oracle; the save and restore times of a 500^2 and a
   10000^2 board;
20. the reference's programs C1-C4: the ``quadrature`` kernel's interior
   loop from ``cuobjdump -sass`` (the instructions it issues on its fast
   path, its square root's slow-path call skipped, by opcode: the
   function's arithmetic and the kernel's overhead, and MUFU a point); the
   kernel against its plain version at n in {1000, 131072, 131073,
   999983, 10^8, 3 567 587 328} on 1 and 8 shards (the value within 2e-6
   relative and equal to the bit to the plain Kahan pass on the kernel's
   own chunk sums, every chunk sum within 1e-6); at 10^12, 26 chunk sums
   (0, 1, the last two, each side of every 8-shard boundary, 8 drawn from
   a seeded generator) within 1e-6 of the plain ``_block_sum``, the chunk
   sums of 1 and 8 shards equal to the bit and the 8-shard value equal to
   the bit to the Kahan pass replayed on its own chunk sums; runs of the 8
   shards (``QUAD_SPLITS`` at ``QUAD_SPLIT_N``, the form a process of a
   mesh across processes launches), each run's chunk sums the one call's
   and its partials the plain Kahan pass on them to the bit (at 10^12 the
   replayed pass), within 2e-6 relative of the plain ``shard_partials``
   below 10^12, the runs' partials summed the one call's value to the
   bit; ``Integral``
   at the reference's N = 10^12 and
   its 32-bit truncation 3 567 587 328 on 1 and 8 virtual shards, each on
   ``engine == "kernel:quadrature"`` within 2e-5 of pi, counts set to 0
   just before a ``compute()`` and read just after (2 launches, nothing
   else), with its wall seconds and points a second, and at 10^12 each
   pass's device time, CUDA events and the bound (the larger of the
   interior loop's MUFU at 16 a clock an SM and the arithmetic
   instructions a point needs at 128 lanes a clock an SM); the plain
   version's time at 10^8 on 8 shards; the
   CLIs in this process: ``apps.integral 1000000000000 --devices 8
   --print-value`` (its launches are the kernels line's), ``apps.hello
   --devices 8`` (``ring ok``), ``apps.pingpong --devices 1 --fit`` and
   ``--devices 8 --fit`` (CSV rows and fit logged; on-card copies);
21. ring and Ulysses attention on 8 virtual shards of the card: the
   contiguous ring, the zigzag ring and Ulysses at 8 x 32768 x 128 causal
   bf16 and the contiguous ring at GQA 8q/2kv, each a forward and a grad
   step (a seeded cotangent) with the counts set to 0 just before and read
   just after (the contiguous ring 8 ``flash_fwd`` launches a forward and
   8 of each hop kernel more a grad step; zigzag 24 and its plain fold
   backward; Ulysses 1 of each), their engine stamps; each output against
   single-device ``flash_attention`` on the same operands and each
   gradient against the single-device hop kernels' backward given that
   run's own output (the same ``D``), under the bf16 rule below, the
   ring's output with one more bf16 spacing of ``M = sum_j w_j |o_j|``
   (its partials' merged magnitude, from the dense softmax over the ring's
   key blocks by ``ring_partial_magnitude``, apart from the ring under
   test: the kernel rounds each partial to bf16 before the merge), and
   o's share of the plain rule logged; ms a
   call by CUDA events, single-device flash and the sharded run in turns;
   the contiguous ring's device ms by kernel (profiler); at 8 x 4096 x
   128 float32 the hop schedules and the plain fold (``engine="plain"``)
   against the dense oracle within 2e-4 forward and 5e-4 gradients;
   ``MOMP_CHAOS=nan_hop=3`` recovered on the clean re-run of the hop
   kernels (``ring_attention:cuda:flash_fwd:b64:recovered``, the clean
   output; the card never falls back to the plain fold) and with ``noguard`` a non-finite output; the CLI
   ``--variant ring --devices 8 --seq 32768 --heads 8 --head-dim 128
   --causal --grad --ring-layout zigzag --no-check`` in a subprocess (48
   ``flash_fwd`` launches, the stamps): the dense oracle's check would
   hold three 32 GiB score matrices at 32k;
22. the sparse sharded engine (``stencils/sparse_sharded.py``) at the
   JAX bench's configuration: the 2048^2 mostly-dead seed board (ten
   blinkers and a glider, ``bench.py:877-900``), 256 Life steps on 8
   virtual row shards at tile 64 and tile 32, on col 8 and cart 4x2 at
   tile 64; wireworld (conductor loops with electrons) and heat (hot spots)
   for 64 steps on cart 4x2 at tile 64; a random soup that resolves to
   ``dense:crossover`` and ``MOMP_SPARSE_SHARDED=0`` (``dense:sharded``),
   32 steps each; the counts set to 0 just before each run and read just
   after (``stencil_padded`` one launch a step of every round with an
   active tile); every board against the dense sharded runner on the card,
   the oracle (for Life the compiled one, ``life_oracle``; else the NumPy
   one) and the same engine on the CPU (integer rules bit for
   bit, heat within ``parity_tol_for("offset")``), the counters and stamp
   equal to the CPU engine's, ``exchange_skips`` > 0 on the seed board;
   ``stencil_padded`` against ``step_padded_plain`` on each run's gathered
   tile stack over a full round, bit for bit; and at tiles 64 and 32 on
   row 8 us a step sparse against dense sharded, chain-differenced (K =
   256 and 2K, fresh engines, min of 2), the mean active fraction, and
   ``stencil_padded``'s launches and device ms a round;
23. the obs layer: the Life CLI on p46gun_big serial and on native cart
   4x2 under ``MOMP_HALO_RDMA=1``, untraced then with ``--trace`` (spans
   ``life.run`` and ``life.advance``, population 7288, both elapsed lines
   logged); ``--profile DIR`` once (a Chrome trace naming the
   ``bitlife_vmem`` kernel); the contiguous ring forward at 8 x 32768 x
   128 causal bf16 on 8 virtual shards under ``MOMP_TRACE`` (the output
   bit for bit the untraced one's, 8 ``flash_fwd`` launches either way,
   7 ``ring.hop.transfer`` and 7 ``ring.hop.fold`` spans,
   ``ring.hops.fwd`` 7) and its seconds untraced and traced in turns; a
   checkpointed p46gun_big, its resume, and native cart 4x2 on the rung
   under ``halo=corrupt``, traced (the checkpoint counters, the recovery
   event); each trace read back with ``obs.report`` and rendered;
24. the tuner (``tune``) on the batched and sharded paths, the counts set
   to 0 just before each pass and read just after (the board-sliced,
   cell-packed stack, fused and padded stencil kernels must each launch):
   ``tune("life", ...)`` at 64, 8 and 1 x 500^2 and 512 x 95x130, ``tune``
   of heat and wireworld at 64 x 500^2, and ``tune_sharded`` of life at
   500^2 on 4x2 virtual shards, each stack made from the spec's generator
   with seed 46 (``TUNE_*``: each shape's brackets), into one plan store;
   each pass with no rejected candidate, every candidate held against the
   NumPy oracle before it was timed, the tuned path the least time and
   ``vs_heuristic`` >= 1, its measurements logged; two launch records of
   the 64-board bucket saved under ``MOMP_CHAOS="aot_corrupt=bitflip:1"``
   and ``"aot_corrupt=skew:1"``; a second process
   (``TUNE_SECOND_PROCESS``) that installs the store (every plan, none
   corrupt, stale or parity-rejected), dispatches (64, 500, 500) on the
   tuned path, finds the damaged records ``corrupt`` and ``stale``,
   quarantines and rebuilds them and holds their first results to the
   oracle, then under ``MOMP_TUNE=0`` installs nothing and dispatches on
   the ladder; the Life CLI ``--batch 64`` traced on the ladder and with
   ``--plans`` (population 466 432 both, only the path's kernel launched,
   the installed plan in the trace), its elapsed seconds untraced in turns,
   and a ``--resume --plans`` status line with ``plan_source`` ``store``;
25. the serving daemon (``serve/daemon.py``) on the card, the counts set
   to 0 just before each run and read just after: the Life CLI
   ``--serve 64 --batch 64`` on p46gun_big on the ladder (only
   ``bitlife_bitsliced`` launched) and with ``--plans`` of phase 24's
   64-board plan (only ``bitlife_vmem_batch``), 64/64 resolved, shed and
   degraded 0, every board phase 5's oracle board (population 7288), both
   elapsed lines logged; the daemon CLI's 256-ticket burst
   (``SERVE_BURST``) under ``--wal-fsync every-record`` and
   ``every-chunk``, every board equal to the plain packed loop run on the
   card, requests a second, p50/p99, batches, engines and the journal's
   records, syncs and bytes logged; the cost of padding 40 boards to a
   64-board ``vmem-grid`` stack; ``MOMP_CHAOS=serve_fail=1`` recovered on
   a kernel rung (``batch:vmem-grid:recovered``, degraded 1) on the ladder
   and with the plan; ``preempt=1`` with ``--checkpoint`` (exit 75), then
   ``--resume --verify`` from the checkpoint; a child daemon under
   ``crash=post-dispatch:1`` (exit 137) and ``resume_any`` from its
   journal (the in-flight batch replayed), drained to the plain loop's
   boards; heat and wireworld 64 x 500^2 buckets at 100 steps with phase
   24's ``stencil:native`` plans (``stencil_padded`` launched, heat within
   ``parity_tol_for("offset")`` and wireworld exact against the roll
   engine on the card); ``--aot-cache`` on 64 x 500^2 at 64 steps twice
   (a miss, then a hit, both stamped ``aot:bitsliced``); no ticket on the
   card ever stamped ``batch:plain`` or ``oracle``;
26. the resident-session pool (``serve/pool.py``) on the card, the counts
   set to 0 just before each run and read just after: ``pool_step``
   (``bitlife_bitsliced``'s rounds, the last in its tail mode) against its
   plain version on slabs of 1 and 2 planes at 1x7, 7x1, 3x3, 48^2, 95x130
   and 500^2 under a random, an all-set, an empty and a lane-31 mask at
   1, 2, 8, 9, 17 and 33 steps and at 1000 steps at 500^2, every word and
   change word equal and the input unwritten, the entry's refusals of 0
   steps and of an output on its input; a profiler trace of one dispatch
   at 500^2 (4 and 100 steps) holding ``launches(s)``
   ``bitlife_bitsliced_kernel`` records and no other kernel;
   ``pool_lane_write`` and ``pool_lane_read`` on page-locked host boards
   at 500^2, 48^2, 9x14 and 17x33, lanes 0, 31, 32 and 63 (48^2 also one
   byte off 16), all exact, a pageable and a device board refused;
   p46gun_big and
   39 soups of 500^2 (``spec.init(default_rng(46))``) in two slabs, a lone
   step, a 32-lane group and both slabs, 10 000 steps in all, p46gun_big's
   snapshot the oracle's (population 7288) and every soup row 4's board;
   64 distinct 500^2 boards created, then snapshotted, back to back, every
   board exact, the pool's page-locked bytes one lane ring and torch's
   page-locked host allocator holding and handing out no byte more after
   them than after the first create;
   the default 64 MiB budget filled (67 one-plane slabs of 500^2, 2144
   sessions from 64 boards), rounds of 100 steps over every session
   (session-steps a second, Gcups, launches, peak memory), one create more
   spilling exactly one LRU session, its snapshot from the host copy, its
   next step a ``pool.miss``, every session row 4's board; 31 of 32
   evicted and a compaction, the survivor bit-equal; a slab of still lifes
   skipping its second dispatch with no launch, a blinker and a mixed slab
   never; ``submit_session`` tickets through the daemon's ``pump``
   (``pool:bitsliced``); the JAX bench's resident A/B (``bench.py:775-870``)
   at 1024 x 48^2 and 256 x 500^2, each side's boards row 4's before any
   number (``session_vs_ship``, p50, p99); a crash-driver child killed at
   ``post-step`` in ``pool`` and in ``settled`` mode, each journal resumed
   to the acked ledger; the link's rate (a 64 MiB page-locked copy each
   way) and ``nvidia-smi``'s PCIe generation and width; each lane op whole
   as the pool runs it at a 500^2 and a 48^2 plane, a traced call one
   kernel record and no copy, its device and host-clock time beside the
   kernel's record, the plain op and the bound restated for the link (the
   board over PCIe against the plane's HBM bytes); and a dispatch's
   device time (the union of its records) at a 500^2 and a 48^2 plane at 4
   and 1000 steps against ``bitsliced_steps(slab, s)``'s, in turns;
27. the serving fleet (``serve/router.py``, ``serve/fleet.py``,
   ``serve/loadgen.py``, ``obs/telemetry.py``) on the card, the counts set
   to 0 just before each in-process drill and read just after
   (``FLEET_*``: the JAX bench's fleet and loadgen policies and mix at
   500^2 and 95x130, steps 100 and 1000): a 3-worker ``Fleet`` with
   journals takes a 192-ticket burst over 24 session keys (p46gun_big every
   16th ticket), its deepest worker wedged mid-burst, declared, its journal
   replayed to nothing pending and its tickets re-homed, every ticket
   resolved (the plain packed loop's boards on the card, p46gun_big the
   oracle's), the books balanced, requests a second, p50/p99, steals and
   the wedge-to-last-re-homed seconds logged; 96 sessions of 500^2 on the
   same fleet stepped 100 and 1000 steps, the wedged worker rejoined
   (exactly the whole slab groups whose lead hashes to it claimed), then
   another worker drained (a whole 16-ticket bucket to one survivor, its
   sessions after their journaled steps, its journal replaying to
   nothing), every snapshot row 4's board, the claim's and the drain's
   seconds logged; ``run_open_loop`` on 3 fresh fleets at 1/2, 1 and 2x
   the burst's rate for 2 s each, ``saturation_knee`` and the knee's
   goodput and p50/p99/p999, then the bench's membership cycle at the knee
   (wedge 0.25, rejoin 0.45, drain 0.65) with telemetry and the elastic
   controller on, every board and snapshot row 4's, the burn-rate peak and
   the decisions logged; the worker-process CLI (``FLEET_CLI``) twice,
   under ``MOMP_CHAOS=kill_worker=1:2`` from the phase's start and clean
   from the burst's end, beside the in-process drills, both exit 0
   with the books balanced and every board verified, worker 1's rc 137,
   every recovery rc 0, the telemetry sidecars merged with their loss
   counted;
28. native IO (``utils/native.py``, ``native/liblifeio.so``, built by
   ``make -C native`` in phase 1 beside the kernels, so every config the
   script reads goes through the C parser): the C and Python parsers equal
   on every ``configs/*.cfg``; ``native.life_steps(bits=True)`` of
   p46gun_big for 10 000 steps equal to phase 5's board; the C and Python
   VTK writers byte-identical on p46gun_big's board at step 10 000 and on
   a 10000^2 soup, in a child process started after phase 6 (the phases
   it ran beside logged), each writer timed alone there, one after the
   other; then, with nothing else running, each writer's host
   milliseconds a snapshot of the 500^2 board (the median of
   ``VTK_REPS``, the two in turn);
29. the graft entry (``mpi_and_open_mp_tpu_torch/graft_entry.py``), the
   counts set to 0 just before each call and read just after:
   ``entry()``'s step (one ``bitlife_vmem`` launch) bit for bit the plain
   ``life_step_roll``'s, and ``dryrun_multichip(8)`` on 8 virtual shards
   of the card (the hop engines' stamps the kernels'; the window, flash
   and quadrature kernels launched);
30. the port across two processes on the one card, every rank with a time
   limit and rc 0 required (staged gloo, ``parallel/procs.py``): the
   worker ``tests/_torch_dist_worker.py --device cuda`` under
   ``MOMP_HALO_RDMA=1`` (its results equal to the one-process run of the
   same meshes on the card; its rung drill's ``halo_frame`` of each rank's
   run of a cart 2x2 stack, uint8 and float32 at depth 1 and 2, read
   through the neighbour's window, gathered and equal bit for bit to
   ``halo_frame`` and ``halo_frame_plain`` on the global stack here, heat
   through ``run_sharded`` at ``fuse_steps=2, boundary_steps=1``
   (``overlap:rdma:pb1``, ``halo_edge_pair`` launched) equal to the
   one-process run, no ``procs.exchange`` call in either), the Life CLI on
   p46gun_big (a snapshot every 1 000 steps) in row 2 and cart 2x2
   ``native`` through the staged exchange (``--fuse-steps 20``) and on the
   RDMA rung (``MOMP_HALO_RDMA=1``, ``--fuse-steps 1``: 10 000 rounds,
   ``overlap:rdma``, ``halo_frame`` launched, no ``procs.exchange`` call,
   a handshake a round) (population 7288, the step-9 000 snapshot the
   one-process board), the
   integral CLI at 3 567 587 328 on 8 shards (the one-process value to the
   bit, each rank's 2 launches a compute) and the attention CLI's ring
   grad step, each rank of a CLI under ``--cli-child`` (its launch counts
   and its calls between processes on stderr); the worker, the four Life
   runs and ``hello`` side by side (the Life CLI's elapsed logged as taken
   beside the other pairs); then, once they are done, alone, one after the
   other: the rung's times (``rung-times``: a handshake and a frame round
   on the host clock, the frame kernel through the window by profiler,
   beside the one-process frame at the same block measured here), the
   integral and attention CLIs and ``pingpong --fit``, the staged
   transport's alpha and 1/beta;
31. ``obs/profile.py`` and ``obs/ledger.py`` on the flagship, from phase
   6's measurements, no timing of its own: ``peaks_for`` of the card's name
   an H100 row (its label printed), ``cost(life_step_roll)`` at 500^2
   uint8 its hand count (10 operations and 2 bytes a cell) and its
   ``roofline`` at phase 6's differenced seconds a step on the headline
   peaks and on the INT32 rate, beside row 1's bound;
   ``record_memory_gauges()`` with the packed board live (live bytes at
   least its bytes, the card's bytes in use above 0); a ledger entry of
   p46gun_big's cups stamped ``gpu`` with the card's name, appended to
   ``build/ledger/chip_smoke.jsonl``, loaded back equal and keyed. Every
   bound the script prints comes from ``obs/profile.py``'s functions and
   rates; phase 1 rolls a ``meta`` tensor on a thread beside ``nvcc``
   (``MetaWarmup``), so phase 31's first trace finds torch's meta functions
   loaded. Before the last lines: every phase's seconds and the total.

Tolerances of phases 10-11 and 21 (``attention_err``). A float32 result (every
result of float32 operands; ``L`` and the hop kernels' gradients of
bfloat16 operands, which both sides compute in float32 from the same
bfloat16 values): ``|got - want| <= tol + tol * |want|``, tol 2e-4 for
``o`` and ``L`` and 5e-4 for gradients (the gate's figures). A bfloat16
result (``o`` of bfloat16 operands, the main path's gradients):
``|got - want| <= 2 s |want| + 1e-3 r + 1e-6 m``, with ``s = 2^-7`` the
largest bfloat16 spacing relative to the value, ``r`` the largest
``|want|`` in the element's row (last axis) and ``m`` the tensor's: each
engine rounds its float32 result to bfloat16 on its own, which can part
them by one spacing, and on the main path that parting feeds the
gradient through ``do = 2 o``; the row term scales the limit to each
row, so late rows of a 32k causal output, whose values are ~1e-2, are
held as tightly as early ones; the last term covers values that cancel
to ~0, such as the first row's ``dq``.

Prints the card's name and power limit, then one JSON line with a record
for each kernel, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.obs.profile import (
    FP32_ISSUE_PER_S, INT32_OPS_PER_S, N_SMS,
    OPS_PER_SLICED_WORD_STEP, OPS_PER_WORD_STEP, POOL_TAIL_OPS_PER_WORD,
    attention_bound_ms, bound_ms, lane_bound_ms, quadrature_bound_ms,
    stencil_bound_ms, stencil_ops)

ROOT = os.path.dirname(os.path.abspath(__file__))
GUN_BIG = os.path.join(ROOT, "configs", "gun_big_500x500.cfg")

# bfloat16 keeps 8 significant bits: two roundings of nearly equal values
# differ by at most one spacing, 2^-7 of the magnitude.
BF16_SPACING = 2.0 ** -7
STENCIL_RULE_NAMES = ("life", "heat", "gray_scott", "wireworld", "lenia")
# Phase 8's NumPy oracle depth: board 0 of the wireworld and heat stacks
# and LifeSim(workload="heat") (cut from 1000 for time; every board is
# still held to run_roll_batch on the card at 10 000 steps).
STENCIL_ORACLE_STEPS = 300
# Phase 6's stack sizes for both batched kernels side by side, at 500^2 and
# 95x130 (2, 4, 7, 16, 32, 128 and 256 cut for time).
BATCH_SWEEP = (1, 8, 64, 512)
# The stencil kernel's times per launch before its redesign, as PERF.md's
# kernel table records them (row 7: CUDA-event times at 64 x 500^2; row 6:
# the device time of the Life rule on shards), printed in the log beside
# this run's and never in the kernels line.
STENCIL_BEFORE_MS = {"heat": 0.0892, "wireworld": 0.1086, "life": 0.0880,
                  "lenia": 1.344, "gray_scott": 0.0375}
LIFE_SHARDS_BEFORE_MS = 0.0029
# Launches of the RDMA rung's two kernels over phase 17's runs: a frame a
# coupled round (native row 4 and cart 4x2 10 000 rounds each, halo cart
# 4x2 1 000, heat 50, lenia 4), an edge pair a partitioned sub-round (heat
# 100, lenia 8).
RUNG_LAUNCHES = {"halo_frame": 21054, "edge_pair": 108}
# Phase 20: the reference's programs C1-C4. The quadrature kernel's
# realistic N: the reference launcher's 10^12 (launchers/run_integral.sh:12)
# and what its 32-bit atoi made of it (SURVEY §3.3).
QUAD_REAL_N = (10**12, 10**12 % (1 << 32))
# Kernel against plain: n (one chunk, a chunk exactly, one point past it,
# a prime, 10^8, the reference's truncated N: its last chunk past 2^32
# points) at 1 and 8 shards.
QUAD_CHECK_N = (1000, 131_072, 131_073, 999_983, 10**8, QUAD_REAL_N[1])
QUAD_SHARDS = (1, 8)
# At 10^12, where the plain version would take minutes: chunk sums held
# against the plain _block_sum at chunks 0 and 1, the last two, both sides
# of every 8-shard boundary and this many more drawn from a seeded
# generator.
QUAD_SPREAD_RANDOM, QUAD_SPREAD_SEED = 8, 18
# Runs of shards held to the plain version: on 8 shards, split into runs
# that start at these shards, at these n (one chunk, which leaves runs
# past it empty; 8 chunks; the reference's truncated N; 10^12).
QUAD_SPLITS = ((0, 4), (0, 2, 5), (0, 7))
QUAD_SPLIT_N = (1000, 10**6, QUAD_REAL_N[1], QUAD_REAL_N[0])
# Tolerances: the kernel's value within 2e-6 relative of the plain
# version's (the JAX package's own bound between 1 and 8 shards,
# tests/test_integral.py:27); a chunk sum within 1e-6 relative (the CPU
# tests hold the kernel's replayed order to JAX's chunk sums so); a
# realistic N within 2e-5 of pi (JAX's bound at 10^8,
# tests/test_integral.py:42).
QUAD_REL, QUAD_CHUNK_REL, QUAD_PI_ABS = 2e-6, 1e-6, 2e-5
# Points a trip of the chunk kernel's interior loop evaluates
# (csrc/quadrature.cu: kSums x kGroup).
QUAD_POINTS_PER_TRIP = 64
# The SASS opcodes of the arithmetic a trapezoid point needs at the JAX
# package's roundings: the abscissa's product and sum, the lane stepped,
# 4 - x^2's product and difference, the clamp, the correctly rounded root
# (MUFU.RSQ and its float refinement) and the sum's add. Everything else
# on the interior loop's fast path (the root's range check, its branch and
# convergence barrier, moves, loop control) is the kernel's overhead, which
# a bound must not count.
QUAD_NEEDED_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "MUFU")


# When each phase's closing line ("phase N ...") was logged.
PHASE_ENDS: list[tuple[int, float]] = []


def log(msg: str) -> None:
    m = re.match(r"phase (\d+) ", msg)
    if m:
        PHASE_ENDS.append((int(m[1]), time.perf_counter()))
    print(msg, flush=True)


def phase_seconds(t_start: float) -> dict[str, float]:
    """Each phase's seconds: from the previous phase's closing line (the
    script's start for phase 1) to its own."""
    out, last = {}, t_start
    for n, t in PHASE_ENDS:
        out[str(n)] = round(t - last, 2)
        last = t
    return out


CHILDREN: list[subprocess.Popen] = []


def spawn(argv: list[str], **kw) -> subprocess.Popen:
    """``subprocess.Popen(argv, **kw)`` leading a session of its own,
    recorded so that :func:`stop_children` ends it, and whatever it
    started, however the script ends."""
    proc = subprocess.Popen(argv, start_new_session=True, **kw)
    CHILDREN.append(proc)
    return proc


def stop_children() -> None:
    """Kill the process group of every child :func:`spawn` started (a
    failed phase can leave one running: phase 28's child, a rank of
    phase 30) and reap the children."""
    for proc in CHILDREN:
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def soup(shape, seed, density=0.4) -> torch.Tensor:
    """A random 0/1 uint8 board made on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand(shape, generator=g, device="cuda") < density).to(
        torch.uint8)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff_count(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum())


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def attention_share(got, want, tol, extra=0.0) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the largest share of
    its limit used (module docstring): ``tol`` absolute and relative for a
    float32 result, two bfloat16 spacings of ``|want|`` plus 1e-3 of its
    row's largest and 1e-6 of the tensor's largest for a bfloat16 result;
    ``extra`` (a tensor or number) adds to the limit. A non-finite result
    uses an infinite share."""
    g, w = got.detach().float(), want.detach().float()
    diff = (g - w).abs()
    a = w.abs()
    if got.dtype == torch.bfloat16:
        limit = (2 * BF16_SPACING * a + 1e-3 * a.amax(-1, keepdim=True)
                 + 1e-6 * a.max())
    else:
        limit = tol + tol * a
    share = float((diff / (limit + extra)).max())
    if not bool(torch.isfinite(g).all()):
        share = float("inf")
    return float(diff.max()), share


def attention_err(got, want, tol, what, extra=0.0) -> tuple[float, float]:
    """:func:`attention_share`, raising past the limit."""
    err, share = attention_share(got, want, tol, extra)
    if share > 1:
        raise AssertionError(f"{what}: max abs error {err}, {share:.3g} of "
                             "the limit")
    return err, share


def device_ms(fn, reps: int, kernel_name: str | None = None,
              tries: int = 6) -> float:
    """Device milliseconds per call of ``fn()`` from ``torch.profiler``
    traces of ``reps`` calls, without the host's launch gaps that CUDA
    events around fast kernels take in. The tracer on the card's machine
    can lose kernel records (from a few to nearly all of a trace's, and
    all of three short traces in a row once), so each trace first runs a
    discarded warm-up step (``reps`` calls, then 10 ms, as in
    :func:`device_span_ms`), and for ``kernel_name`` (a kernel that each
    call launches once) this is the mean duration of the records kept,
    pooled over traces until at least half of one trace's ``reps`` are
    kept or ``tries`` traces are taken (each shortfall logged). With no
    name it is the total device time of one trace over ``reps``, which
    reads low by whatever the tracer lost. When every trace kept none,
    the time is :func:`cuda_ms` of ``reps`` calls, logged as such: it
    includes the launch gaps."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and (kernel_name is None or kernel_name in ev.name)]
        if kernel_name is None:
            if us:
                return sum(us) / reps / 1e3
        else:
            kept += us
            if len(us) < reps:
                log(f"  device_ms: trace {attempt} kept {len(us)} of {reps} "
                    f"{kernel_name} kernel records")
            if 2 * len(kept) >= reps:
                return sum(kept) / len(kept) / 1e3
    if kept:
        return sum(kept) / len(kept) / 1e3
    log(f"  device_ms: the profiler kept no device kernel "
        f"{kernel_name or ''} in {tries} traces of {reps} calls; CUDA "
        "events instead (launch gaps included)")
    fn()
    return cuda_ms(fn, reps)


def device_span_ms(fn, reps: int, kernel_name: str, launches: int,
                   tries: int = 6) -> tuple[float, int]:
    """Device milliseconds per call of ``fn()`` that launches
    ``kernel_name`` (every device record for ``""``) ``launches`` times,
    whose launches may overlap (programmatic dependent launch): the union
    of the records' intervals in one ``torch.profiler`` trace of ``reps``
    calls, over ``reps``, scaled by the records the calls made over those
    the tracer kept (a lost record leaves a gap). Each trace first runs a
    discarded warm-up step (``reps`` calls, then 10 ms: the card's tracer
    loses a trace's first records, a whole short trace three times in a
    row once); a trace that kept none is taken again, up to ``tries``
    traces, and when all kept none the time is :func:`cuda_ms` of
    ``reps`` calls (launch gaps included), logged. Returns the time and
    the records kept."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and kernel_name in ev.name)
        if spans:
            break
        log(f"  device_span_ms: trace {attempt} kept no {kernel_name} "
            "record")
    else:
        log(f"  device_span_ms: the profiler kept no device kernel "
            f"{kernel_name} in {tries} traces of {reps} calls; CUDA events "
            "instead (launch gaps included)")
        return cuda_ms(fn, reps), 0
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    total += hi - lo
    return total / reps / 1e3 * (reps * launches / len(spans)), len(spans)


def grad_step_kernels(fn) -> dict[str, float]:
    """Device milliseconds of each kernel that ``fn()`` runs, by short
    name (no namespace, return type or arguments), from one
    ``torch.profiler`` trace of a second call, largest first. The first
    call is traced and discarded (the profiler's warm-up step): the card's
    tracer has lost the records of a trace's first milliseconds, the whole
    forward kernel of a grad step, in every trace of a run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    ms: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                          ev.name)[:60].strip()
            ms[name] = ms.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def run_counted(wrappers, fn):
    """``fn()`` with every kernel wrapper's launch count set to 0 just
    before and read just after; returns its result and the counts."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


FLASH_KERNEL = re.compile(r"\d+(flash_\w+?)ILi(\d+)E")
# stencil_padded_kernel<RULE, R>: the rule id and the fixed radius (0 for
# the generic kernel).
STENCIL_KERNEL = re.compile(r"stencil_padded_kernelILi(\d)ELi(\d+)E")


# bitlife_window_kernel<RT>: the rows a thread holds.
WINDOW_KERNEL = re.compile(r"bitlife_window_kernelILi(\d+)E")
# bitlife_vmem_cluster_kernel<RT, FULL> (the rows a thread holds, and
# whether every segment holds RT) and the one-block bitlife_vmem_kernel;
# in bitlife_vmem_batch the same cluster kernels and the one-block
# bitlife_vmem_batch_kernel.
VMEM_KERNEL = re.compile(
    r"bitlife_vmem_(?:cluster_kernelILi(\d+)ELb([01])E|kernel)")
VMEM_BATCH_KERNEL = re.compile(
    r"bitlife_vmem_(?:cluster_kernelILi(\d+)ELb([01])E|batch_kernel)")
# bitlife_bitsliced_kernel<RT, CT, FULL, TAIL>: the rows and columns a
# thread holds, whether every segment holds RT, and the pool's tail mode.
SLICED_KERNEL = re.compile(
    r"bitlife_bitsliced_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E")
# bitlife_fused_kernel<RT>: the rows a thread holds.
FUSED_KERNEL = re.compile(r"bitlife_fused_kernelILi(\d+)E")


def window_shapes(tb) -> list[tuple[str, int, int, int, int, int]]:
    """(what, shards, nw, W, h, hx) of the shard windows that the bitfused
    main paths hand ``bitlife_window``: p46gun_big on row 8, col 8 and cart
    4x2 (8 windows each), and the interior and edge windows of the 1024^2
    row-2 overlap split (2 each), from ``tb.plan_sharded_bits``."""
    out = []
    for what, args in (("row 8", (8, 1, True, False)),
                       ("col 8", (1, 8, False, True)),
                       ("cart 4x2", (4, 2, True, True))):
        p = tb.plan_sharded_bits((500, 500), *args)
        out.append((f"p46gun_big {what}", p.py * p.px, p.nw_s, p.W, p.h,
                    p.hx))
    p = tb.plan_sharded_bits((1024, 1024), 2, 1, True, False)
    out.append(("1024^2 row 2 interior", 2, p.nw_s - 2 * p.h, p.W, p.h, 0))
    out.append(("1024^2 row 2 edge", 2, p.h, p.W, p.h, 0))
    return out


def fused_shapes(tb) -> list[tuple[str, object]]:
    """(what, plan) of the frames the main paths hand ``bitlife_fused``:
    the 10000^2 padded frame (``frame``, phase 5), 16384^2 and 4096^2
    aligned (``fused``), and one shard of 10000^2 on cart 2x2 (``tiled``,
    phase 14), from ``tb.plan_sharded_bits``."""
    return [("10000^2 frame", tb.plan_sharded_bits((10000, 10000))),
            ("16384^2", tb.plan_sharded_bits((16384, 16384))),
            ("4096^2", tb.plan_sharded_bits((4096, 4096))),
            ("10000^2 cart 2x2 shard",
             tb.plan_sharded_bits((10000, 10000), 2, 2, True, True))]


def fused_check_frames(tb) -> list[tuple[str, object]]:
    """The frames phase 3 holds ``bitlife_fused`` to: those of
    :func:`fused_shapes` and the 1000^2 padded frame."""
    return fused_shapes(tb) + [("1000^2 frame",
                                tb.plan_sharded_bits((1000, 1000)))]


def fused_families(tb, plan) -> dict[str, object]:
    """The geometry of each family ``bitlife_fused`` can launch over the
    plan's frame at k = k_max: the one ``fused_launch_geometry`` chooses,
    then of ``fused_candidates`` the best by the chooser's model that is
    one tile (the frame's width on one ring), 2-D tiles on rings, ghost
    zones (no cluster), several segments a column, a strip of one (a ring
    with itself), and several warps a row with 2 or more copied lanes; a
    family the frame admits no geometry of, or whose best is one already
    listed, is left out."""
    nw, W, h, hx, k = plan.nw_s, plan.W, plan.h, plan.hx, plan.k_max
    ranked = sorted(tb.fused_candidates(nw, W, h, hx, k),
                    key=lambda g: tb._fused_time_model_us(k, g))
    families = {
        "one tile": lambda g: g.tiles == 1 and g.exchange,
        "2-D tiles": lambda g: g.tiles > 1 and g.exchange,
        "ghost zones": lambda g: not g.exchange,
        "segments": lambda g: g.segments > 1,
        "strip of one": lambda g: g.strips == 1 and g.exchange,
        "copied lanes": lambda g: g.warps > 1 and g.warp_ghost > 1,
    }
    out = {"chosen": tb.fused_launch_geometry(nw, W, h, hx, k)}
    for name, member in families.items():
        geo = next((g for g in ranked if member(g)), None)
        if geo is not None and all(geo.args() != g.args()
                                   for g in out.values()):
            out[name] = geo
    return out


# Further boards phase 2 holds the resident kernel to (ny, nx), as random
# words: ny % 32 == 30 (position ny + 1 is bit 31 of the last word, which
# the first segment reads as its word above) and 31 (positions ny and
# ny + 1 in two words), one word a column, the glider's board (one strip),
# one column, and a board too tall for a cluster (the one-block geometry)
# (tests/test_torch_vmem_cluster.py replays the same).
VMEM_SHAPES = [(254, 300), (255, 300), (30, 8), (10, 10), (40, 1),
               (16400, 24)]


# Further windows phase 13 holds the window kernel to, (what, shards, nw,
# W, h, hx): a width not a multiple of the strip, narrower than a
# cluster, a single shard, hx > 0 and hx == 0, rows split over many
# threads, and a window so tall that only 32 rows a thread and a cluster
# refreshing every step fit a block (tests/test_torch_window_cluster.py
# replays the same).
WINDOW_EDGE_CASES = [
    ("C = 47, not a multiple of the strip", 1, 3, 37, 2, 5),
    ("C = 10, below 16 strips", 3, 2, 10, 1, 0),
    ("one shard, C = 8", 1, 1, 8, 1, 0),
    ("hx = 17 > 0", 2, 5, 61, 3, 17),
    ("hx = 0, k = 32 h", 2, 4, 200, 2, 0),
    ("R = 48, rows over 12 threads", 1, 40, 30, 4, 6),
    ("R = 72, rows over 9 threads", 2, 70, 9, 1, 4),
    ("R = 300, 32 rows a thread", 1, 292, 82, 4, 41),
]


def flash_kernel_key(m) -> tuple[str, int, torch.dtype]:
    """(name, head width, dtype) of a flash_fwd or flash_hop_bwd kernel
    from a match of its mangled name against FLASH_KERNEL: the ``_tc``
    kernels take bf16, the FMA ones float32."""
    return (m[1], int(m[2]),
            torch.bfloat16 if m[1].endswith("_tc") else torch.float32)


def ptxas_kernels(text: str, pattern=None,
                  kernel_key=None) -> dict[tuple, dict[str, int]]:
    """Registers and spilled bytes of each kernel whose mangled name matches
    ``pattern`` (by default the flash kernels, :data:`FLASH_KERNEL`) from a
    source's ``-Xptxas -v`` log, keyed by ``kernel_key`` of the match (by
    default :func:`flash_kernel_key`)."""
    pattern = pattern or FLASH_KERNEL
    kernel_key = kernel_key or flash_kernel_key
    out, key = {}, None
    for line in text.splitlines():
        m = pattern.search(line)
        if "Compiling entry function" in line and m:
            key = kernel_key(m)
            out[key] = {}
        elif key and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[key].update(stack=nums[0], spill_stores=nums[1],
                            spill_loads=nums[2])
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line)[1])
    return out


def sass_counts(cuobjdump: str, lib, opcode: str) -> dict[tuple, int]:
    """How many ``opcode`` instructions each flash kernel of the built
    library holds (``cuobjdump -sass``), keyed by
    :func:`flash_kernel_key`."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = FLASH_KERNEL.search(part.split()[0])
        if m:
            counts[flash_kernel_key(m)] = part.count(opcode)
    return counts


# cuobjdump -sass: "/*0120*/  FADD R4, R4, 256 ;", a branch "BRA 0x120".
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
SASS_TARGET = re.compile(r"\bBRA\s+(0x[0-9a-f]+)")


def sass_loops(cuobjdump: str, lib, function: str) -> list[dict]:
    """Every loop of ``function`` (a substring of its mangled name) in
    ``cuobjdump -sass`` of the library: for each backward branch, the
    instructions from its target to it, how many of them are MUFU
    (special-function unit) instructions, ``fast_path``: those a trip
    issues when no out-of-line call runs (a forward branch over a block
    that holds a ``CALL``, such as the square root's slow path, taken;
    every other conditional forward branch falling through), and
    ``fast_path_ops``: that path's instructions by opcode (``MUFU.RSQ``
    counts as ``MUFU``)."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for part in sass.split("Function : ")[1:]:
        if function in part.split()[0]:
            break
    else:
        raise AssertionError(f"no function {function} in the SASS of {lib}")
    insns = [(int(m[1], 16), m[2]) for m in SASS_LINE.finditer(part)]
    loops = []
    for addr, text in insns:
        m = SASS_TARGET.search(text)
        if not m or int(m[1], 16) >= addr:
            continue
        body = [(a, t) for a, t in insns if int(m[1], 16) <= a <= addr]
        path = sass_fast_path(body)
        ops = {}
        for text in path:
            words = text.split()
            op = (words[1] if words[0].startswith("@") else words[0])
            op = op.split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        loops.append({"instructions": len(body),
                      "fast_path": len(path), "fast_path_ops": ops,
                      "mufu": sum("MUFU" in t for _, t in body),
                      "mufu_rsq": sum("MUFU.RSQ" in t for _, t in body),
                      "from": m[1], "to": hex(addr)})
    return loops


def sass_fast_path(body: list[tuple[int, str]]) -> list[str]:
    """The instructions one trip of a loop ``body`` (address, text) issues
    on its fast path (:func:`sass_loops`), its closing branch included."""
    index = {a: i for i, (a, _) in enumerate(body)}
    path, i = [], 0
    while i < len(body):
        addr, text = body[i]
        path.append(text)
        m = SASS_TARGET.search(text)
        if m and i < len(body) - 1:
            target = int(m[1], 16)
            if target > addr and target in index:
                skipped = body[i + 1:index[target]]
                if not text.startswith("@") or any(
                        "CALL" in t for _, t in skipped):
                    i = index[target]
                    continue
        i += 1
    return path


def quadrature_pass_ms(fn, tries: int = 2) -> dict[str, float]:
    """Device milliseconds of the quadrature's passes in one call of
    ``fn()``, from :func:`grad_step_kernels` (a traced warm-up call
    discarded, then one call: a call of half a second is one record a
    pass), each from the first of ``tries`` traces that kept it. The
    card's tracer has lost every record of the chunk pass in three
    traces in a row, so a pass it never keeps is missing from the result
    (logged), and the call's time comes from CUDA events."""
    names = ("quadrature_chunk_kernel", "quadrature_kahan_kernel")
    got = {}
    for attempt in range(1, tries + 1):
        # A kernel's records by its name without template arguments.
        ms = {}
        for k, v in grad_step_kernels(fn).items():
            ms[k.split("<")[0]] = ms.get(k.split("<")[0], 0.0) + v
        got.update({k: ms[k] for k in names if k in ms and k not in got})
        if len(got) == len(names):
            break
        log(f"  quadrature_pass_ms: trace {attempt} kept {sorted(ms)}")
    return got


def kahan_partials_np(sums: np.ndarray, shards: int) -> np.ndarray:
    """``qd.kahan_shards`` in numpy: the same float32 operations in the
    same order (a step of the loop costs a few µs here against ~15 in
    torch, so 7.6 M chunk sums on 8 shards replay in seconds)."""
    per = -(-len(sums) // shards)
    vals = np.zeros(shards * per, np.float32)
    vals[:len(sums)] = sums
    cols = np.ascontiguousarray(vals.reshape(shards, per).T)
    acc, comp = np.zeros(shards, np.float32), np.zeros(shards, np.float32)
    y, t = np.empty(shards, np.float32), np.empty(shards, np.float32)
    for c in range(per):
        np.subtract(cols[c], comp, out=y)
        np.add(acc, y, out=t)
        np.subtract(t, acc, out=comp)
        np.subtract(comp, y, out=comp)
        acc, t = t, acc
    return acc


def sum_partials_np(acc: np.ndarray, h: float) -> float:
    """``qd.sum_partials`` in numpy: the partials summed in float32 in
    shard order, times f32(h)."""
    total = acc[0]
    for k in range(1, len(acc)):
        total = np.float32(total + acc[k])
    return float(np.float32(total * np.float32(h)))


def kahan_total_np(sums: np.ndarray, shards: int, h: float) -> float:
    """``qd.shard_total`` in numpy."""
    return sum_partials_np(kahan_partials_np(sums, shards), h)


def quadrature_split_checks(nq, qd, dev, one_at_real) -> list[dict]:
    """Phase 20's runs of shards. On 8 shards, each split into runs
    (``QUAD_SPLITS``, the first shard of each run) at each n of
    ``QUAD_SPLIT_N``: a run's chunk sums the one call's to the bit; its
    Kahan partials the plain Kahan pass (``qd.kahan_shards``) on its own
    chunk sums to the bit (at 10^12 the numpy replay of that pass,
    :func:`kahan_partials_np`, on the one call's) and, below 10^12, within
    ``QUAD_REL`` of the plain version's (``qd.shard_partials``, its own
    chunk sums); the runs' partials, concatenated, the one call's, and
    summed in shard order (``qd.sum_partials``) its value to the bit.
    ``one_at_real``: the one call's ``nq.launch`` result at 10^12 on 8
    shards and the replayed pass's partials, already taken. Raises on a
    difference."""
    splits = []
    for n in QUAD_SPLIT_N:
        h = 2.0 / n
        per = -(-qd._chunk_grid(n)[0] // 8)
        real = n == QUAD_REAL_N[0]
        if real:
            one_v, one_sums, one_parts, replay = one_at_real
            replay = torch.from_numpy(replay).to(dev)
        else:
            one_v, one_sums, one_parts = nq.launch(0.0, 2.0, n, 8, dev)
        for starts in QUAD_SPLITS:
            parts, bad, rel_max = [], [], 0.0
            for f, end in zip(starts, (*starts[1:], 8)):
                c = end - f
                _, sums, got = nq.launch(0.0, 2.0, n, 8, dev, first=f,
                                         count=c)
                lo, hi = f * per, min(end * per, one_sums.numel())
                own = sums[:max(hi - lo, 0)]
                if not torch.equal(own, one_sums[lo:hi]):
                    bad.append(f"run [{f}, {end}) chunk sums")
                want = replay[f:end] if real else qd.kahan_shards(own, c, per)
                if not torch.equal(got, want):
                    bad.append(f"run [{f}, {end}) partials {got.tolist()} "
                               f"against the Kahan pass on its chunk sums "
                               f"{want.tolist()}")
                if not real:
                    plain = qd.shard_partials(qd.f_circle, 0.0, 2.0, n, 8, f,
                                              c, dev)
                    rel = float(((got - plain).abs()
                                 / plain.abs().clamp_min(1e-30)).max())
                    rel_max = max(rel_max, rel)
                    if rel > QUAD_REL:
                        bad.append(f"run [{f}, {end}) partials rel {rel:.3g} "
                                   f"against shard_partials")
                parts.append(got)
            parts = torch.cat(parts)
            total = float(qd.sum_partials(parts, h))
            if (bad or not torch.equal(parts, one_parts)
                    or total != float(one_v)):
                raise AssertionError(
                    f"quadrature n={n} in runs from {starts}: {bad}, "
                    f"partials {parts.tolist()} against the one call's "
                    f"{one_parts.tolist()}, value {total!r} against "
                    f"{float(one_v)!r}")
            splits.append({"n": n, "starts": list(starts), "value": total,
                           "plain_rel_max": rel_max})
    return splits


def captured(fn):
    """``fn()`` in this process: (its result, stdout, stderr)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    return res, out.getvalue(), err.getvalue()


def run_cli(main_fn, argv) -> tuple[int, str, str]:
    """``main_fn(argv)`` in this process: (exit code, stdout, stderr)."""
    return captured(lambda: main_fn(argv))


def phase_c1c4(card: str, wrappers: dict, cuobjdump: str) -> dict:
    """Phase 20 (module docstring); returns the ``quadrature`` row of the
    kernels line."""
    import math

    from mpi_and_open_mp_tpu_torch.apps import hello as hello_app
    from mpi_and_open_mp_tpu_torch.apps import integral as integral_app
    from mpi_and_open_mp_tpu_torch.apps import pingpong as pingpong_app
    from mpi_and_open_mp_tpu_torch.models.integral import Integral
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import native_quadrature as nq
    from mpi_and_open_mp_tpu_torch.ops import quadrature as qd
    from mpi_and_open_mp_tpu_torch.parallel import fabric, mesh as pm
    from mpi_and_open_mp_tpu_torch.robust import chaos

    t0 = time.perf_counter()
    dev = torch.device("cuda")

    # The interior loop's instructions a point, from the SASS.
    loops = sass_loops(cuobjdump, _build.lib_path("quadrature"),
                       "quadrature_chunk_kernelILb0E")
    inner = [lp for lp in loops if lp["mufu_rsq"] >= QUAD_POINTS_PER_TRIP]
    if not inner:
        raise AssertionError(f"no loop of {QUAD_POINTS_PER_TRIP} MUFU.RSQ in "
                             f"quadrature_chunk_kernel's SASS: {loops}")
    interior = min(inner, key=lambda lp: lp["fast_path"])
    insns_per_point = interior["fast_path"] / QUAD_POINTS_PER_TRIP
    needed_per_point = sum(c for op, c in interior["fast_path_ops"].items()
                           if op in QUAD_NEEDED_OPS) / QUAD_POINTS_PER_TRIP
    mufu_per_point = interior["mufu"] / QUAD_POINTS_PER_TRIP
    ops_per_point = {op: c / QUAD_POINTS_PER_TRIP
                     for op, c in sorted(interior["fast_path_ops"].items())}
    log(f"  quadrature_chunk_kernel loops (SASS): {loops}; interior fast "
        f"path a point: {insns_per_point:.3f} instructions "
        f"({ops_per_point}), of which {needed_per_point:.3f} the function's "
        f"arithmetic ({'/'.join(QUAD_NEEDED_OPS)}) and "
        f"{insns_per_point - needed_per_point:.3f} the kernel's overhead; "
        f"{mufu_per_point:.3f} MUFU")

    # Kernel against plain. The plain version (trapezoid_shard_sum) is
    # chunk_sums and then shard_total, whose Kahan loop runs on a host copy
    # of the chunk sums: the same float32 operations without a launch a
    # step. The kernel's value also equals shard_total of its own chunk sums
    # to the bit (its Kahan pass and fold are those operations in that
    # order), so a chunk it dropped, doubled or misplaced shows.
    cases, err_max = [], 0.0
    for n in QUAD_CHECK_N:
        h = 2.0 / n
        want_sums = qd.chunk_sums(qd.f_circle, 0.0, 2.0, n, dev)
        want_host = want_sums.cpu()
        for p in QUAD_SHARDS:
            got, sums, _ = nq.launch(0.0, 2.0, n, p, dev)
            got_v = float(got)
            want_v = float(qd.shard_total(want_host, p, h))
            sums_host = sums.cpu()
            own_v = float(qd.shard_total(sums_host, p, h))
            if n == QUAD_REAL_N[1] and p == 8:
                # Ties the numpy replay used at 10^12 to the plain version.
                replay_v = kahan_total_np(sums_host.numpy(), p, h)
                if replay_v != own_v:
                    raise AssertionError(
                        f"kahan_total_np {replay_v!r} against "
                        f"qd.shard_total {own_v!r} at n={n} p={p}")
            err = abs(got_v - want_v)
            chunk_err = float(((sums - want_sums).abs()
                               / want_sums.abs().clamp_min(1e-30)).max())
            if (not math.isfinite(got_v) or err > QUAD_REL * abs(want_v)
                    or chunk_err > QUAD_CHUNK_REL or got_v != own_v):
                raise AssertionError(
                    f"quadrature n={n} p={p}: kernel {got_v!r} against plain "
                    f"{want_v!r} (rel {err / abs(want_v):.3g}), chunk sums "
                    f"rel {chunk_err:.3g}, the Kahan pass on its own chunk "
                    f"sums {own_v!r}")
            err_max = max(err_max, err)
            cases.append({"n": n, "shards": p, "kernel": got_v,
                          "plain": want_v, "rel": err / abs(want_v),
                          "chunk_rel_max": chunk_err})
    log(f"  quadrature vs plain: {len(cases)} cases, max rel "
        f"{max(c['rel'] for c in cases):.3g}, chunk sums max rel "
        f"{max(c['chunk_rel_max'] for c in cases):.3g}; every value equal "
        "to the bit to the Kahan pass on the kernel's own chunk sums")

    # At 10^12: a spread of chunk sums against the plain _block_sum, the
    # chunk pass of 1 and 8 shards equal to the bit, and the 8-shard Kahan
    # pass replayed on the kernel's own 7.6 M chunk sums to the bit.
    t_spread = time.perf_counter()
    n = QUAD_REAL_N[0]
    h = 2.0 / n
    n_chunks, last_chunk, _ = qd._chunk_grid(n)
    got8, sums8, parts8 = nq.launch(0.0, 2.0, n, 8, dev)
    _, sums1, _ = nq.launch(0.0, 2.0, n, 1, dev)
    per8 = -(-n_chunks // 8)
    rng = np.random.default_rng(QUAD_SPREAD_SEED)
    picks = ({0, 1, last_chunk - 1, last_chunk}
             | {k * per8 + d for k in range(1, 8) for d in (-1, 0)}
             | {int(g) for g in rng.integers(0, n_chunks,
                                             QUAD_SPREAD_RANDOM)})
    g = torch.tensor(sorted(picks), dtype=torch.int64, device=dev)
    want = qd._block_sum(qd.f_circle, 0.0, h, g, n)
    spread_rel = float(((sums8[g] - want).abs()
                        / want.abs().clamp_min(1e-30)).max())
    replay8 = kahan_partials_np(sums8.cpu().numpy(), 8)
    replay_v = sum_partials_np(replay8, h)
    if (spread_rel > QUAD_CHUNK_REL or not torch.equal(sums1, sums8)
            or replay_v != float(got8)):
        raise AssertionError(
            f"quadrature n={n}: chunk sums at {sorted(picks)} rel "
            f"{spread_rel:.3g} against _block_sum, 1 and 8 shards' chunk "
            f"sums equal: {torch.equal(sums1, sums8)}, 8 shards "
            f"{float(got8)!r} against the replay {replay_v!r}")
    spread = {"chunks": sorted(picks), "chunk_rel_max": spread_rel,
              "kahan_replay": replay_v, "seconds":
              time.perf_counter() - t_spread}
    log(f"  quadrature n={n}: {len(picks)} chunk sums (0, 1, the last two, "
        f"each side of 7 shard boundaries, {QUAD_SPREAD_RANDOM} drawn) "
        f"within {spread_rel:.3g} of _block_sum; 1 and 8 shards' chunk sums "
        f"equal; the 8-shard value {float(got8)!r} equal to the Kahan "
        f"replay ({spread['seconds']:.2f} s)")

    # Runs of shards, the form a process of a mesh across processes
    # launches (quadrature_chunk_kernel<true> when its run starts past
    # chunk 0).
    t_split = time.perf_counter()
    splits = quadrature_split_checks(nq, qd, dev,
                                     (got8, sums8, parts8, replay8))
    del sums8, sums1, parts8, replay8
    log(f"  quadrature in runs of shards: {len(splits)} splits (runs from "
        f"{', '.join(map(str, QUAD_SPLITS))} of 8 shards at n = "
        f"{', '.join(map(str, QUAD_SPLIT_N))}): each run's chunk sums the "
        f"one call's and its partials the plain Kahan pass on them, to the "
        f"bit, within {max(r['plain_rel_max'] for r in splits):.3g} of "
        f"shard_partials; the runs' partials summed the one call's value to "
        f"the bit ({time.perf_counter() - t_split:.2f} s)")

    # Realistic N through Integral, counts set to 0 just before each
    # compute() and read just after.
    runs = {}
    for n in QUAD_REAL_N:
        for p in QUAD_SHARDS:
            integ = Integral(n, mesh=pm.make_mesh_1d(p, device="cuda",
                                                     virtual=True))
            if integ.engine != "kernel:quadrature":
                raise AssertionError(f"Integral({n}) on {p} shards took "
                                     f"engine {integ.engine}")
            integ.compute()  # warm-up
            t1 = time.perf_counter()
            value, counts = run_counted(wrappers, integ.compute)
            wall = time.perf_counter() - t1
            others = {k: c for k, c in counts.items()
                      if c and k != "quadrature"}
            if (abs(value - math.pi) >= QUAD_PI_ABS
                    or counts["quadrature"] != 2 or others):
                raise AssertionError(
                    f"Integral({n}) on {p} shards: {value!r} "
                    f"(|value - pi| {abs(value - math.pi):.3g}), launches "
                    f"{counts}")
            label = f"n={n} p={p}"
            rec = {"n": n, "shards": p, "value": value,
                   "abs_err_pi": abs(value - math.pi),
                   "launches_per_compute": counts["quadrature"],
                   "compute_s": wall, "points_per_s": (n + 1) / wall}
            if n == QUAD_REAL_N[0]:
                fn = (lambda n=n, p=p:
                      nq.trapezoid_circle(0.0, 2.0, n, p, dev))
                # CUDA events around one call (two launches of half a
                # second: the host's gaps are ~1e-5 of it); each pass's
                # device time where the tracer keeps it.
                rec["events_ms"] = cuda_ms(fn)
                passes = quadrature_pass_ms(fn)
                rec["chunk_device_ms"] = passes.get("quadrature_chunk_kernel")
                rec["kahan_device_ms"] = passes.get("quadrature_kahan_kernel")
                n_chunks = qd._chunk_grid(n)[0]
                bound, by, terms = quadrature_bound_ms(
                    n + 1, needed_per_point, mufu_per_point,
                    8 * n_chunks + 4)
                rec.update(bound_ms=bound, bound_by=by, **terms,
                           bound_share=bound / rec["events_ms"],
                           device_points_per_s=(n + 1)
                           / (rec["events_ms"] / 1e3))
                if rec["chunk_device_ms"] is not None:
                    rec["chunk_bound_share"] = (bound
                                                / rec["chunk_device_ms"])
            runs[label] = rec
            log(f"  Integral {label}: {value!r} (|value - pi| "
                f"{rec['abs_err_pi']:.3g}), {counts['quadrature']} launches "
                f"a compute(), {wall:.6f} s, {rec['points_per_s']:.4g} "
                "points/s"
                + (f"; events {rec['events_ms']:.3f} ms a call (device: "
                   f"chunk pass {rec['chunk_device_ms']}, Kahan pass "
                   f"{rec['kahan_device_ms']} ms; None: the tracer kept no "
                   f"record), bound {rec['bound_ms']:.3f} ms "
                   f"({rec['bound_by']}: MUFU {rec['mufu_ms']:.3f}, issue "
                   f"{rec['issue_ms']:.3f}), {rec['bound_share']:.3f} of it"
                   if "events_ms" in rec else "")
                + f" [{card}]")

    # The plain version's time beside the kernel's, at 10^8 on 8 shards.
    n_plain, p_plain = 10**8, 8
    plain_ms = cuda_ms(lambda: qd.trapezoid_shard_sum(
        qd.f_circle, 0.0, 2.0, n_plain, p_plain, dev))
    kernel_small_ms = cuda_ms(
        lambda: nq.trapezoid_circle(0.0, 2.0, n_plain, p_plain, dev), 20)
    log(f"  n=1e8 p=8: plain {plain_ms:.3f} ms, the kernel (both passes) "
        f"{kernel_small_ms:.4f} ms, CUDA events [{card}]")

    # The three CLIs end to end, in this process (counts around the
    # integral CLI: its warm-up and timed compute()).
    argv = [str(QUAD_REAL_N[0]), "--devices", "8", "--print-value"]
    (rc, out, err), cli_counts = run_counted(
        wrappers, lambda: run_cli(integral_app.main, argv))
    value = float(err.strip())
    if (rc != 0 or len(out.split()) != 1 or abs(value - math.pi)
            >= QUAD_PI_ABS or cli_counts["quadrature"] != 4):
        raise AssertionError(f"apps.integral {' '.join(argv)}: rc {rc}, "
                             f"stdout {out!r}, stderr {err!r}, launches "
                             f"{cli_counts}")
    cli_seconds = float(out)
    log(f"  apps.integral {' '.join(argv)}: {cli_seconds:.6f} s, value "
        f"{value!r}, launches {cli_counts['quadrature']} (warm-up and "
        f"timed) [{card}]")
    rc, out, err = run_cli(hello_app.main, ["--devices", "8"])
    lines = out.strip().splitlines()
    if rc != 0 or lines[-1] != "ring ok" or len(lines) != 10:
        raise AssertionError(f"apps.hello --devices 8: rc {rc}, {out!r}")
    log(f"  apps.hello --devices 8: {lines[0]}; {lines[-1]}")
    if chaos.active_plan() is not None:
        raise AssertionError("a chaos plan is active before the probe")
    fits = {}
    for p in (1, 8):
        argv = ["--devices", str(p), "--fit"]
        rc, out, err = run_cli(pingpong_app.main, argv)
        lines = out.strip().splitlines()
        fit = json.loads(lines[-1])
        if (rc != 0 or lines[0] != "size,time" or len(lines) != 9
                or fit.get("metric") != "pingpong_fit"):
            raise AssertionError(f"apps.pingpong {' '.join(argv)}: rc {rc}, "
                                 f"{out!r}, {err!r}")
        for line in lines[:-1]:
            log(f"  pingpong --devices {p}: {line}")
        log(f"  pingpong --devices {p}: {err.strip()} (on-card copies) "
            f"[{card}]")
        fits[f"devices={p}"] = fit
    log(f"phase 20 C1-C4: ok ({time.perf_counter() - t0:.2f} s)")

    main = runs[f"n={QUAD_REAL_N[0]} p=8"]
    return {
        "name": "quadrature", "route": "cuda",
        "source": "mpi_and_open_mp_tpu_torch/csrc/quadrature.cu",
        "replaces": "mpi_and_open_mp_tpu/ops/quadrature.py:75",
        "launches": cli_counts["quadrature"], "max_abs_err": err_max,
        "ms": main["events_ms"], "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": (f"n = {QUAD_REAL_N[0]} trapezoids on 8 virtual shards, two "
                  "launches (chunk sums, Kahan pass) a compute()"),
        "note": ("no Pallas kernel in the JAX package (its jnp fori_loop, "
                 "ops/quadrature.py:75-121); ms: CUDA events around one "
                 "call (both passes); runs: each pass's device time from a "
                 "torch.profiler trace where it kept the record; plain_ms: CUDA events around the "
                 "plain version at n = 1e8 on 8 shards (plain_shape); "
                 "bound: per point the arithmetic instructions the "
                 "function needs (QUAD_NEEDED_OPS on the interior loop's "
                 "fast path, the root's range check, branch and barrier "
                 "left out) at 128 lanes a clock an SM against its MUFU at "
                 "16; launches: "
                 "the integral CLI at 10^12 on 8 shards (warm-up and timed)"),
        "plain_shape": f"n = {n_plain}, {p_plain} shards",
        "kernel_ms_at_plain_shape": kernel_small_ms,
        "sass_interior_loop": interior,
        "instructions_per_point": insns_per_point,
        "needed_instructions_per_point": needed_per_point,
        "overhead_instructions_per_point": insns_per_point - needed_per_point,
        "spread_at_1e12": spread,
        "runs": runs, "exact_cases": cases, "cli_seconds": cli_seconds,
        "pingpong_fit": fits}


# Phase 21: ring and Ulysses attention over virtual shards of the card. The
# shards, the main path's shape, and the float32 shape the plain ring and
# the dense oracle hold the hop schedules at.
RING_SHARDS = 8
RING_SEQ, RING_SEQ_F32 = 32768, 4096
# Launches a call of (flash_fwd, flash_hop_dq, flash_hop_dkv) for each run
# of p = RING_SHARDS shards, forward and grad step: the contiguous ring one
# flash_fwd a hop and one of each backward kernel a hop; causal zigzag three
# half-chunk flash_fwd launches a hop and the plain fold backward (as in
# the JAX package); Ulysses one launch of each over its shards' heads.
RING_RUNS = {
    "ring contiguous": ("ring", "contiguous", 8,
                        (RING_SHARDS, 0, 0), (RING_SHARDS,) * 3),
    "ring zigzag": ("ring", "zigzag", 8, (3 * RING_SHARDS, 0, 0),
                    (3 * RING_SHARDS, 0, 0)),
    "ulysses": ("ulysses", None, 8, (1, 0, 0), (1, 1, 1)),
    "ring contiguous gqa 8q/2kv": ("ring", "contiguous", 2,
                                   (RING_SHARDS, 0, 0), (RING_SHARDS,) * 3),
}


def phase_sharded_attention(card: str, wrappers: dict) -> dict:
    """Phase 21 (module docstring): returns the launches of the attention
    kernels by run, the kernels line's ``launches_by_run`` of rows 8 and
    10, and the timings."""
    from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd as fhb
    from mpi_and_open_mp_tpu_torch.ops import native_flash as nf
    from mpi_and_open_mp_tpu_torch.parallel import context as cx
    from mpi_and_open_mp_tpu_torch.robust import chaos, guards

    t0 = time.perf_counter()
    if chaos.active_plan() is not None:
        raise AssertionError("a chaos plan is active before phase 21")
    p = RING_SHARDS
    names = ("flash_fwd", "flash_hop_dq", "flash_hop_dkv")
    counted = {name: wrappers[name] for name in names}
    gen = torch.Generator(device="cuda").manual_seed(2100)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def sharded(variant, layout, engine="auto"):
        if variant == "ring":
            return lambda q, k, v: cx.ring_attention(
                q, k, v, devices=p, causal=True, layout=layout,
                engine=engine)
        return lambda q, k, v: cx.ulysses_attention(
            q, k, v, devices=p, causal=True, engine=engine)

    def flash(q, k, v):
        return cx.flash_attention(q, k, v, causal=True)

    def grad_step(fn, q, k, v, do):
        """Output and (q, k, v) gradients for the cotangent ``do``."""
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fn(*qkv)
        return out.detach(), torch.autograd.grad(out, qkv, do)

    def forward(fn, q, k, v):
        with torch.no_grad():
            return fn(q, k, v)

    launches, timings, stamps, shares, breakdown = {}, {}, {}, {}, {}
    for run, (variant, layout, hkv, fwd_want, grad_want) in RING_RUNS.items():
        q = randn((8, RING_SEQ, 128), torch.bfloat16)
        k, v = (randn((hkv, RING_SEQ, 128), torch.bfloat16)
                for _ in range(2))
        do = randn((8, RING_SEQ, 128), torch.bfloat16)
        zig = layout == "zigzag"
        fn = sharded(variant, layout)
        # The zigzag order is a deployment layout: operands permuted once,
        # outputs and gradients permuted back for the comparison.
        qz, kz, vz, doz = ((cx.zigzag_shard(x, p) for x in (q, k, v, do))
                           if zig else (q, k, v, do))

        def natural(x):
            return cx.zigzag_unshard(x, p) if zig else x

        o, fwd_counts = run_counted(counted, lambda: forward(fn, qz, kz, vz))
        torch.cuda.synchronize()
        (o2, grads), grad_counts = run_counted(
            counted, lambda: grad_step(fn, qz, kz, vz, doz))
        torch.cuda.synchronize()
        got = tuple(fwd_counts[n] for n in names), tuple(
            grad_counts[n] for n in names)
        if got != (fwd_want, grad_want):
            raise AssertionError(f"{run}: launches (flash_fwd, dq, dkv) "
                                 f"forward {got[0]}, grad step {got[1]}; "
                                 f"want {fwd_want}, {grad_want}")
        launches[f"{run} forward"] = fwd_counts
        launches[f"{run} grad step"] = grad_counts
        if variant == "ring":
            stamps[run] = {
                "forward": cx.ring_hop_engine_for(qz, kz, vz, p=p,
                                                  causal=True, layout=layout),
                "backward": cx.ring_hop_bwd_engine_for(
                    qz, kz, vz, p=p, causal=True, layout=layout)}
        else:
            stamps[run] = {"local": cx.flash_engine_for(
                q, *cx._ulysses_kv(k, v, p, 8))}
        # The output against single-device flash_attention: the bf16 rule,
        # plus for the ring one spacing of its partials' merged magnitude
        # (each hop's partial comes out of the kernel rounded to bf16),
        # computed from the dense softmax apart from the ring under test.
        want_o = forward(flash, q, k, v)
        extra = (BF16_SPACING * natural(cx.ring_partial_magnitude(
            qz, kz, vz, p, True, layout)) if variant == "ring" else 0.0)
        errs = {"o": attention_err(natural(o), want_o, 0, f"{run} o", extra),
                "o (grad step)": attention_err(natural(o2), want_o, 0,
                                               f"{run} o (grad step)", extra)}
        shares[run] = attention_share(natural(o), want_o, 0)[1]
        # The gradients against the single-device backward given this run's
        # own output (the same D = rowsum(do o)): the bf16 rule.
        _, L = nf.flash_fwd(q, k, v, True)
        D = (do.float() * natural(o2).float()).sum(-1)
        want_grads = fhb.hop_block_grads(q, do, L, D, k, v, causal=True)
        for what, a, b in zip(("dq", "dk", "dv"), grads, want_grads):
            errs[what] = attention_err(natural(a), b.to(a.dtype), 0,
                                       f"{run} {what}")
        del o, o2, grads, want_o, want_grads, extra, L, D
        # CUDA events, single-device flash and the sharded run in turns.
        ms = {}
        for label, f in (("flash", flash), (variant, fn), (f"{variant} 2", fn),
                         ("flash 2", flash)):
            a, b, c, g = (q, k, v, do) if f is flash else (qz, kz, vz, doz)
            forward(f, a, b, c)
            ms[f"{label} forward"] = cuda_ms(lambda: forward(f, a, b, c),
                                             reps=3)
            ms[f"{label} grad step"] = cuda_ms(
                lambda: grad_step(f, a, b, c, g), reps=2)
        timings[run] = ms
        if run == "ring contiguous":
            # Device ms by kernel of one forward and one grad step: the hop
            # kernels against the rotations, merges and casts around them.
            for what, f in (("forward", lambda: forward(fn, qz, kz, vz)),
                            ("grad step",
                             lambda: grad_step(fn, qz, kz, vz, doz))):
                by_kernel = grad_step_kernels(f)
                breakdown[what] = by_kernel
                log(f"  profiler, one {run} {what}, device ms by kernel: "
                    + "; ".join(f"{name} {t:.3f}" for name, t in
                                list(by_kernel.items())[:8])
                    + f"; total {sum(by_kernel.values()):.3f}")
        log(f"  {run}, {p} virtual shards, 8 x {RING_SEQ} x 128 kv {hkv} "
            f"causal bf16: engines {stamps[run]}; launches a forward "
            f"{fwd_counts}, a grad step {grad_counts}; max abs error (share "
            "of the limit) against single-device flash_attention (o; the "
            "ring's limit with one spacing of its partials) and its "
            "backward given this output (gradients): "
            + ", ".join(f"{w} {e:.4g} ({s:.3g})" for w, (e, s) in errs.items())
            + f"; o's share of the one-rounding rule {shares[run]:.3g}")
        log(f"  {run} ms a call (CUDA events; flash, sharded, sharded, "
            f"flash): " + ", ".join(f"{w} {t:.3f}" for w, t in ms.items())
            + f" [{card}]")
        del q, k, v, do, qz, kz, vz, doz
        torch.cuda.empty_cache()

    # Float32 at 8 x 4096 x 128: the hop schedules (the FMA kernels) against
    # the plain ring (engine="plain") and the dense oracle, within the gate's
    # 2e-4 forward and 5e-4 gradients.
    def oracle(q, k, v):
        return cx.attention_reference(
            q, *cx._repeat_heads(k, v, q.shape[0] // k.shape[0]),
            causal=True)

    with cx._full_f32_matmul():
        for hkv in (8, 2):
            q = randn((8, RING_SEQ_F32, 128), torch.float32)
            k, v = (randn((hkv, RING_SEQ_F32, 128), torch.float32)
                    for _ in range(2))
            do = randn((8, RING_SEQ_F32, 128), torch.float32)
            want_o, want_grads = grad_step(oracle, q, k, v, do)
            for variant, layout in (("ring", "contiguous"),
                                    ("ring", "zigzag"), ("ulysses", None)):
                zig = layout == "zigzag"
                qz, kz, vz, doz = ((cx.zigzag_shard(x, p)
                                    for x in (q, k, v, do))
                                   if zig else (q, k, v, do))
                errs = {}
                for engine in (("auto", "plain") if variant == "ring"
                               else ("auto",)):
                    o, grads = grad_step(sharded(variant, layout, engine),
                                         qz, kz, vz, doz)
                    if zig:
                        o, grads = (cx.zigzag_unshard(o, p),
                                    [cx.zigzag_unshard(g, p) for g in grads])
                    errs[f"{engine} o"] = attention_err(
                        o, want_o, 2e-4, f"{variant} {layout} {engine} o")
                    for what, a, b in zip(("dq", "dk", "dv"), grads,
                                          want_grads):
                        errs[f"{engine} {what}"] = attention_err(
                            a, b, 5e-4, f"{variant} {layout} {engine} {what}")
                log(f"  {variant} {layout or ''} 8 x {RING_SEQ_F32} x 128 kv "
                    f"{hkv} causal float32 against the dense oracle (auto: "
                    "the hop kernels; plain: the plain fold), max abs error "
                    "(share of the limit): " + ", ".join(
                        f"{w} {e:.3g} ({s:.3g})"
                        for w, (e, s) in errs.items()))
            del q, k, v, do, qz, kz, vz, doz, want_o, want_grads

        # The guard: a NaN at hop 3 recovers on the clean re-run of the hop
        # kernels (never the plain fold on the card); without the guard it
        # reaches the output.
        q, k, v = (randn((8, RING_SEQ_F32, 128), torch.float32)
                   for _ in range(3))
        clean = sharded("ring", "contiguous")(q, k, v)
        recovered = ["ring_attention:" + cx.ring_hop_engine_for(
            q, k, v, p=p, causal=True) + ":recovered"]
        for spec in ("nan_hop=3", "nan_hop=3;noguard"):
            os.environ[chaos.ENV] = spec
            chaos.reset()
            guards.reset_recovery_log()
            try:
                out = sharded("ring", "contiguous")(q, k, v)
            finally:
                os.environ.pop(chaos.ENV)
                chaos.reset()
            finite = bool(torch.isfinite(out).all())
            log_ = guards.recovery_log()
            if spec == "nan_hop=3":
                ok = (finite and log_ == recovered
                      and attention_err(out, clean, 2e-4, "recovered ring"))
            else:
                ok = not finite and not log_
            log(f"  MOMP_CHAOS={spec}: finite {finite}, recoveries {log_}")
            if not ok:
                raise AssertionError(f"ring under MOMP_CHAOS={spec}")
        guards.reset_recovery_log()
        del q, k, v, clean, out
    torch.cuda.empty_cache()

    # The CLI end to end. The dense oracle's check would hold three 32 GiB
    # score matrices at 32k, so it runs with --no-check: the ring at this
    # shape is held above against single-device flash_attention.
    argv = ["--variant", "ring", "--devices", str(p), "--seq", str(RING_SEQ),
            "--heads", "8", "--head-dim", "128", "--causal", "--grad",
            "--ring-layout", "zigzag", "--no-check"]
    cli = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.attention",
         *argv], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    err_lines = cli.stderr.strip().splitlines()
    if cli.returncode != 0 or len(err_lines) < 2:
        raise AssertionError(f"attention CLI {argv}: {cli.stderr[-2000:]}")
    cli_counts = {kv.split("=")[0]: int(kv.split("=")[1])
                  for kv in err_lines[-1].split()[1:]}
    # Two grad steps (warm-up and timed) of 3p forward launches each.
    if (cli_counts != {"flash_fwd": 6 * p, "flash_hop_dq": 0,
                       "flash_hop_dkv": 0}
            or "devices=8 engine=cuda:flash_fwd:b64:zz bwd_engine=plain "
            not in err_lines[-2]):
        raise AssertionError(f"attention CLI {argv}: {cli.stdout!r} "
                             f"{cli.stderr!r}")
    log(f"  CLI attention {' '.join(argv)}: {float(cli.stdout):.6f} s "
        f"elapsed line; " + "; ".join(err_lines[-2:]) + f" [{card}]")
    launches["CLI ring zigzag --devices 8 --grad"] = cli_counts
    log(f"phase 21 sharded attention: ok ({time.perf_counter() - t0:.2f} s)")
    return {"launches_by_run": launches, "ms": timings, "engines": stamps,
            "o_share_of_one_rounding_rule": shares,
            "ring_contiguous_device_ms_by_kernel": breakdown}


# Phase 22: the sparse sharded engine on the JAX bench's configuration
# (bench.py:1418-1470, launchers/queue_r08/10_sparse_sharded_ab.sh): a
# 2048^2 mostly-dead board, 256 Life steps, 8 virtual row shards, tiles 64
# and 32; col 8 and cart 4x2 at tile 64; wireworld and heat on cart; a soup
# past the crossover; the kill switch. (run, spec, layout, mesh, tile,
# steps, board, stamp wanted; None: the first sparse or dense stamp).
SPARSE_EDGE = 2048
SPARSE_STEPS = 256
SPARSE_RUNS = (
    ("life row 8 t64", "life", "row", (8,), 64, SPARSE_STEPS, "seed",
     "sparse-sharded:row:t64"),
    ("life row 8 t32", "life", "row", (8,), 32, SPARSE_STEPS, "seed",
     "sparse-sharded:row:t32"),
    ("life col 8 t64", "life", "col", (8,), 64, SPARSE_STEPS, "seed",
     "sparse-sharded:col:t64"),
    ("life cart 4x2 t64", "life", "cart", (4, 2), 64, SPARSE_STEPS, "seed",
     "sparse-sharded:cart:t64"),
    ("wireworld cart 4x2 t64", "wireworld", "cart", (4, 2), 64, 64,
     "wires", "sparse-sharded:cart:t64"),
    ("heat cart 4x2 t64", "heat", "cart", (4, 2), 64, 64, "spots", None),
    ("life soup row 8 t64", "life", "row", (8,), 64, 32, "soup",
     "dense:crossover"),
    ("life row 8 t64 MOMP_SPARSE_SHARDED=0", "life", "row", (8,), 64, 32,
     "seed", "dense:sharded"),
)
# The runs timed sparse against dense, as the JAX bench times them.
SPARSE_TIMED = ("life row 8 t64", "life row 8 t32")


def sparse_seed_board(edge: int, tile: int) -> np.ndarray:
    """The JAX bench's mostly-dead Life board (``bench.py:877-900``): ten
    horizontal blinkers in tile interiors on a coarse grid, and a glider
    just off the (0, 0) tile's corner, aimed across tile edges."""
    board = np.zeros((edge, edge), dtype=np.uint8)
    ty = edge // tile
    stride = max(3, ty // 3)
    placed = 0
    for j in range(1, ty, stride):
        for i in range(1, ty, stride):
            if placed >= 10:
                break
            cy, cx = j * tile + tile // 2, i * tile + tile // 2
            board[cy, cx - 1:cx + 2] = 1
            placed += 1
    gy, gx = tile - 2, tile - 2
    board[gy:gy + 3, gx:gx + 3] = np.array(
        [[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=np.uint8)
    return board


def sparse_wire_board(edge: int, tile: int) -> np.ndarray:
    """A mostly empty wireworld board on the seed board's grid: a conductor
    loop (3) with one electron (head 1, tail 2) in each grid tile, and one
    long wire whose electron crosses tile and shard edges."""
    board = np.zeros((edge, edge), dtype=np.uint8)
    ty = edge // tile
    stride = max(3, ty // 3)
    q = tile // 4
    for j in range(1, ty, stride):
        for i in range(1, ty, stride):
            y0, x0 = j * tile + q, i * tile + q
            board[y0, x0:x0 + 2 * q] = 3
            board[y0 + 2 * q, x0:x0 + 2 * q] = 3
            board[y0:y0 + 2 * q + 1, x0] = 3
            board[y0:y0 + 2 * q + 1, x0 + 2 * q - 1] = 3
            board[y0, x0 + 2], board[y0, x0 + 1] = 1, 2
    y = tile - 3
    board[y, 8:edge // 2] = 3
    board[y, 12], board[y, 11] = 1, 2
    return board


def sparse_spot_board(edge: int, tile: int) -> np.ndarray:
    """Heat: the seed board's blinker cells and glider as 1.0 hot spots on
    a cold float32 board."""
    return sparse_seed_board(edge, tile).astype(np.float32)


def sparse_board(kind: str, tile: int) -> np.ndarray:
    if kind == "seed":
        return sparse_seed_board(SPARSE_EDGE, tile)
    if kind == "wires":
        return sparse_wire_board(SPARSE_EDGE, tile)
    if kind == "spots":
        return sparse_spot_board(SPARSE_EDGE, tile)
    return (np.random.default_rng(2200).random((SPARSE_EDGE, SPARSE_EDGE))
            < 0.35).astype(np.uint8)


@contextlib.contextmanager
def env_set(name: str, value: str | None):
    """The environment variable ``name`` set to ``value`` (unset for None)
    for the block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def phase_sparse_sharded(card: str, wrappers: dict) -> dict:
    """Phase 22 (module docstring): returns the stencil_padded launches by
    run and the timings."""
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.stencils import engine as se
    from mpi_and_open_mp_tpu_torch.stencils import sparse_sharded as ss

    t0 = time.perf_counter()
    counted = {"stencil": wrappers["stencil"]}

    def mesh_of(layout, shape, device):
        if layout == "cart":
            return pm.make_mesh_2d(*shape, device=device, virtual=True)
        return pm.make_mesh_1d(shape[0], axis="x" if layout == "col" else "y",
                               device=device, virtual=True)

    def engine(spec, board, layout, shape, tile, device="cuda"):
        return ss.SparseShardedEngine(spec, board, mesh=mesh_of(
            layout, shape, device), layout=layout, tile=tile)

    def same(spec, got, want) -> bool:
        if spec.is_float:
            return se.parity_ok(spec, got, want, **se.parity_tol_for(
                "offset"))
        return np.array_equal(got, want)

    launches, records, kernel_cases, oracles = {}, {}, [], {}
    for (run, name, layout, shape, tile, steps, kind,
         stamp_want) in SPARSE_RUNS:
        spec = stencils.get(name)
        board = sparse_board(kind, tile)
        kill = "MOMP_SPARSE_SHARDED=0" in run
        with env_set(ss.ENV_SPARSE_SHARDED, "0" if kill else None):
            eng = engine(spec, board, layout, shape, tile)
            got, counts = run_counted(counted, lambda: (
                eng.step(steps), torch.cuda.synchronize())[0])
            cpu = engine(spec, board, layout, shape, tile, "cpu")
            cpu.step(steps)
        got = got.cpu().numpy()
        c = eng.counters()
        # One launch a step of every round that had an active tile.
        want_launches = c["sparse_steps"] - c["settled_steps"]
        run_dense, plan = se.make_sharded_runner(
            spec, mesh_of(layout, shape, "cuda"), layout, board.shape)
        dense = run_dense(torch.from_numpy(board).cuda(), steps).cpu().numpy()
        key = (name, kind, tile, steps)
        if key not in oracles:
            oracles[key] = (life_oracle(board, steps) if name == "life"
                            else stencils.oracle_run(spec, board, steps))
        oracle = oracles[key]
        problems = []
        if not same(spec, got, dense):
            problems.append("board differs from the dense sharded runner's")
        if not same(spec, got, oracle):
            problems.append("board differs from the NumPy oracle's")
        if not same(spec, cpu.snapshot(), got):
            problems.append("board differs from the engine's on the CPU")
        if cpu.counters() != c:
            problems.append(f"counters {c} != the CPU engine's "
                            f"{cpu.counters()}")
        if eng.engine_stamp != cpu.engine_stamp or (
                stamp_want and eng.engine_stamp != stamp_want):
            problems.append(f"stamp {eng.engine_stamp} (CPU "
                            f"{cpu.engine_stamp}), want {stamp_want}")
        if counts["stencil"] != want_launches:
            problems.append(f"{counts['stencil']} stencil_padded launches, "
                            f"want {want_launches}")
        if kind == "seed" and not kill and not c["exchange_skips"]:
            problems.append("no exchange skip on the seed board")
        if problems:
            raise AssertionError(f"phase 22 {run}: " + "; ".join(problems))
        launches[run] = counts["stencil"]
        records[run] = {"stamp": eng.engine_stamp, "counters": c,
                        "dense_plan": plan.engine}
        log(f"  {run}, {SPARSE_EDGE}^2 {name} {steps} steps: "
            f"{eng.engine_stamp}; counters {c}; stencil_padded launches "
            f"{counts['stencil']}; equal to the dense sharded runner's "
            f"({plan.engine}), the oracle's and the CPU engine's board and "
            "counters")
        # The kernel against its plain version on this run's gathered tile
        # stacks: a fresh engine past its first (dense) round, one sparse
        # round's stack stepped f times both ways.
        if kill or kind == "soup":
            continue
        probe = engine(spec, board, layout, shape, tile)
        probe.step(probe.fuse)
        idx = np.argwhere(probe.active)
        if not len(idx):
            continue
        stack = probe._gather(tuple(probe._bucket(idx)),
                              spec.radius * probe.fuse, True)
        err = 0.0
        for _ in range(probe.fuse):
            a = ns.stencil_step_padded(spec, stack)
            b = ns.step_padded_plain(spec, stack)
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(
                    f"phase 22 {run}: stencil_padded differs from its plain "
                    f"version on a gathered {tuple(stack.shape)} stack")
            err = max(err, float((a.float() - b.float()).abs().max()))
            stack = a
        kernel_cases.append({"run": run, "tiles": int(len(idx)),
                             "steps": probe.fuse, "max_abs_err": err})
        log(f"  {run}: stencil_padded against step_padded_plain on the "
            f"gathered stack of {len(idx)} tiles, {probe.fuse} steps from "
            f"{tile + 2 * spec.radius * probe.fuse}^2 to {tile}^2: bit for "
            "bit")
        del probe, stack, a, b
    torch.cuda.empty_cache()

    # Sparse against dense sharded, us a step, chain-differenced (K and 2K
    # steps, fresh engines, min of 2), as the JAX bench's A/B.
    timings = {}
    life = stencils.get("life")
    k = SPARSE_STEPS
    for run in SPARSE_TIMED:
        _, _, layout, shape, tile, _, kind, _ = next(
            r for r in SPARSE_RUNS if r[0] == run)
        board = sparse_board(kind, tile)
        mesh = mesh_of(layout, shape, "cuda")
        run_dense, _ = se.make_sharded_runner(life, mesh, layout,
                                              board.shape)
        dev_board = torch.from_numpy(board).cuda()

        def dense_s(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_dense(dev_board, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        def sparse_s(n):
            eng = engine(life, board, layout, shape, tile)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step(n)
            torch.cuda.synchronize()
            return time.perf_counter() - t, eng

        dense_s(k)
        d1 = min(dense_s(k) for _ in range(2))
        d2 = min(dense_s(2 * k) for _ in range(2))
        sparse_s(2 * k)
        s1 = min(sparse_s(k)[0] for _ in range(2))
        (s2a, eng2), (s2b, _) = sparse_s(2 * k), sparse_s(2 * k)
        s2 = min(s2a, s2b)
        dense_us = (d2 - d1) / k * 1e6
        sparse_us = (s2 - s1) / k * 1e6
        _, counts = run_counted(counted, lambda: sparse_s(2 * k))
        c2 = eng2.counters()
        rounds = -(-(c2["sparse_steps"] - c2["settled_steps"]) // eng2.fuse)
        per_launch = device_ms(lambda: engine(life, board, layout, shape,
                                              tile).step(k), 1,
                               kernel_name="stencil_padded")
        per_round = counts["stencil"] / max(rounds, 1)
        timings[run] = {
            "sparse_us_per_step": sparse_us, "dense_us_per_step": dense_us,
            "sparse_vs_dense": dense_us / sparse_us,
            "mean_active_frac": eng2.mean_active_frac,
            "stencil_launches_per_round": per_round,
            "stencil_device_ms_per_launch": per_launch,
            "stencil_device_ms_per_round": per_launch * per_round,
            "brackets_s": {"dense_k": d1, "dense_2k": d2, "sparse_k": s1,
                           "sparse_2k": s2}}
        log(f"  {run}: {sparse_us:.2f} us a step sparse against "
            f"{dense_us:.2f} dense sharded ({dense_us / sparse_us:.2f}x; "
            f"K = {k} and 2K, fresh engines, min of 2); mean active "
            f"fraction {eng2.mean_active_frac:.6f}; stencil_padded "
            f"{per_round:.2f} launches a round, {per_launch:.5f} ms a launch"
            f", {per_launch * per_round:.5f} ms a round of device time "
            f"[{card}]")
    log(f"phase 22 sparse sharded: ok ({time.perf_counter() - t0:.2f} s)")
    return {"launches_by_run": launches, "runs": records,
            "timings": timings, "exact_cases": kernel_cases}


# Traces phase 23's --profile run may take before one keeps the kernel's
# record (the card's tracer loses records, ROADMAP).
PROFILE_TRIES = 3


def phase_obs(card: str, wrappers: dict) -> dict:
    """Phase 23 (module docstring): the obs layer on the ported paths.
    Returns the traced and untraced seconds side by side and what the
    traces held."""
    import shutil

    from mpi_and_open_mp_tpu_torch import LifeSim, load_config
    from mpi_and_open_mp_tpu_torch.apps import life as life_app
    from mpi_and_open_mp_tpu_torch.obs import metrics, report, trace
    from mpi_and_open_mp_tpu_torch.parallel import context as cx
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.robust import chaos, guards

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_obs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    side_by_side, held = {}, {}

    def traced(path):
        trace.reset()
        return env_set(trace._ENV, path)

    def read(path, want_names):
        trace.reset()
        recs = report.load(path)
        names = [r["name"] for r in recs]
        missing = [n for n in want_names if n not in names]
        if missing:
            raise AssertionError(f"phase 23: {path} lacks {missing}: "
                                 f"{sorted(set(names))}")
        rep = report.report_dict(recs)
        for line in report.render(rep).splitlines():
            log(f"    {line}")
        return recs, rep

    # The Life CLI, untraced then traced, on p46gun_big serial and on the
    # RDMA rung's native cart 4x2.
    for run, argv, env in (
            ("CLI p46gun_big serial", ["--layout", "serial"], None),
            ("CLI p46gun_big native cart 4x2, MOMP_HALO_RDMA=1",
             ["--layout", "cart", "--mesh", "4,2", "--virtual-devices", "8",
              "--impl", "native"], "1")):
        argv = [GUN_BIG, *argv, "--print-final-population"]
        path = os.path.join(root, f"life{len(held)}.jsonl")
        with env_set("MOMP_HALO_RDMA", env):
            rc0, out0, err0 = run_cli(life_app.main, argv)
            with traced(path):
                rc1, out1, err1 = run_cli(life_app.main,
                                          argv + ["--trace", path])
        if (rc0, rc1) != (0, 0) or [e.strip().splitlines()[-1]
                                    for e in (err0, err1)] != ["7288"] * 2:
            raise AssertionError(f"phase 23 {run}: rc {rc0}, {rc1}; "
                                 f"{err0[-500:]!r} {err1[-500:]!r}")
        recs, rep = read(path, ["life.run", "life.advance"])
        side_by_side[run] = {"untraced_s": float(out0), "traced_s":
                             float(out1)}
        held[run] = {"spans": [r["name"] for r in recs]}
        log(f"  {run}: elapsed {float(out0):.6f} s untraced, "
            f"{float(out1):.6f} s traced; population 7288 both; spans "
            f"{held[run]['spans']} [{card}]")

    # --profile: a Chrome trace of the serial run, naming the resident
    # kernel. The card's tracer can lose the run's one kernel record, so a
    # trace without it is taken again, up to PROFILE_TRIES times.
    prof_dir = os.path.join(root, "profile")
    for attempt in range(1, PROFILE_TRIES + 1):
        rc, out, err = run_cli(life_app.main, [GUN_BIG, "--layout",
                                               "serial", "--profile",
                                               prof_dir])
        prof_file = os.path.join(prof_dir, life_app.PROFILE_FILE)
        with open(prof_file) as fd:
            chrome = json.load(fd)
        kernels = sorted({ev.get("name", "")[:60] for ev in
                          chrome.get("traceEvents", [])
                          if ev.get("cat") == "kernel"})
        if rc != 0 or any("bitlife_vmem" in k for k in kernels):
            break
        log(f"  --profile: trace {attempt} kept no bitlife_vmem record "
            f"({kernels})")
    if rc != 0 or not any("bitlife_vmem" in k for k in kernels):
        raise AssertionError(f"phase 23 --profile: rc {rc}, kernels "
                             f"{kernels}")
    log(f"  CLI p46gun_big serial --profile: {float(out):.6f} s elapsed; "
        f"{os.path.getsize(prof_file)} bytes of Chrome trace, "
        f"{len(chrome['traceEvents'])} events, kernels {kernels}")
    held["profile kernels"] = kernels

    # The contiguous ring forward at 8 x 32768 x 128 causal bf16 on 8
    # virtual shards, untraced and traced: the same output to the bit, the
    # same launches, p - 1 hops under spans.
    p = RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(2300)
    q, k, v = (torch.randn((8, RING_SEQ, 128), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    counted = {"flash_fwd": wrappers["flash_fwd"]}

    def ring():
        with torch.no_grad():
            out = cx.ring_attention(q, k, v, devices=p, causal=True)
        torch.cuda.synchronize()
        return out

    ring()
    plain_out, plain_counts = run_counted(counted, ring)
    path = os.path.join(root, "ring.jsonl")
    metrics.reset()
    with traced(path):
        traced_out, traced_counts = run_counted(counted, ring)
    stamp = cx.ring_hop_engine_for(q, k, v, p=p, causal=True)
    recs, rep = read(path, ["ring_attention", "ring.fold.resident",
                            "ring.hop.transfer", "ring.hop.fold"])
    names = [r["name"] for r in recs]
    hops = metrics.get("ring.hops.fwd", engine=stamp)
    if (not torch.equal(plain_out, traced_out)
            or plain_counts != {"flash_fwd": p}
            or traced_counts != plain_counts
            or names.count("ring.hop.transfer") != p - 1
            or names.count("ring.hop.fold") != p - 1
            or hops != p - 1 or metrics.get("ring.steps.traced") != 1
            or rep["attention"]["traced_steps"] != 1):
        raise AssertionError(f"phase 23 traced ring: equal "
                             f"{torch.equal(plain_out, traced_out)}, "
                             f"launches {plain_counts} {traced_counts}, "
                             f"spans {names}, ring.hops.fwd {hops}")
    times = {}
    for label in ("untraced", "traced", "traced 2", "untraced 2"):
        with traced(path if label.startswith("traced") else None):
            t = time.perf_counter()
            ring()
            times[label] = time.perf_counter() - t
    side_by_side["ring forward 8 x 32768 x 128 causal bf16, 8 shards"] = {
        "untraced_s": min(times["untraced"], times["untraced 2"]),
        "traced_s": min(times["traced"], times["traced 2"])}
    held["ring"] = {"engine": stamp, "ring.hops.fwd": hops,
                    "launches": traced_counts}
    log(f"  ring forward, {p} virtual shards, 8 x {RING_SEQ} x 128 causal "
        f"bf16: traced output equal to the untraced bit for bit; launches "
        f"{traced_counts} both; {p - 1} ring.hop.transfer and {p - 1} "
        f"ring.hop.fold spans; ring.hops.fwd{{engine={stamp}}} = {hops}; "
        f"seconds a forward (host clock, synced; untraced, traced, traced, "
        f"untraced): " + ", ".join(f"{t:.5f}" for t in times.values())
        + f" [{card}]")
    del q, k, v, plain_out, traced_out
    torch.cuda.empty_cache()

    # A checkpointed run and its resume, then a guarded recovery, traced.
    gun = load_config(GUN_BIG)
    path = os.path.join(root, "robust.jsonl")
    ck = os.path.join(root, "ck")
    metrics.reset()
    guards.reset_recovery_log()
    with traced(path):
        sim = LifeSim(gun, layout="serial", checkpoint_dir=ck,
                      checkpoint_every=2500)
        final = sim.run()
        resumed = LifeSim.from_checkpoint(
            os.path.join(ck, "step_005000.state"), gun, layout="serial")
        resumed.run()
        with env_set("MOMP_HALO_RDMA", "1"), env_set(chaos.ENV,
                                                     "halo=corrupt"):
            chaos.reset()
            try:
                gcfg = dataclasses.replace(gun, steps=1000)
                gsim = LifeSim(gcfg, layout="cart", impl="native",
                               mesh=pm.make_mesh_2d(4, 2))
                gfinal = gsim.run()
            finally:
                chaos.reset()
    recs, rep = read(path, ["life.segment", "checkpoint.save",
                            "checkpoint.restore", "recovery"])
    snap = metrics.snapshot()["counters"]
    stamp = "life_step:native:recovered"
    saves = len([r for r in recs if r["name"] == "checkpoint.save"])
    if (int(final.sum()) != 7288 or int(resumed.collect().sum()) != 7288
            # Checkpoints at steps 0 (the save cadence's first point),
            # 2500, 5000 and 7500; the resumed sim writes none.
            or saves != 4 or snap.get("checkpoint.saves") != saves
            or snap.get("checkpoint.restores") != 1
            or snap.get(f"recovery{{stamp={stamp}}}") != 1
            or rep["recoveries"]["by_stamp"] != {stamp: 1}
            or not np.array_equal(gfinal, life_ops_oracle(gun, 1000))):
        raise AssertionError(f"phase 23 checkpoints and recovery: "
                             f"populations {int(final.sum())}, "
                             f"{int(resumed.collect().sum())}; counters "
                             f"{snap}; recoveries {rep['recoveries']}")
    held["robust"] = {k: v for k, v in snap.items()
                      if k.startswith(("checkpoint.", "recovery"))}
    log(f"  checkpointed p46gun_big (every 2500 steps), its resume at 5000 "
        f"and native cart 4x2 on the rung under halo=corrupt, traced: "
        f"counters {held['robust']}; the recovery event "
        f"{rep['recoveries']}; populations 7288; the guarded board the "
        "oracle's")
    guards.reset_recovery_log()
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 23 obs: ok ({time.perf_counter() - t0:.2f} s)")
    return {"untraced_vs_traced_s": side_by_side, "held": held}


# Phase 24: the tuner on the batched and sharded paths. Each shape's
# brackets (steps, steps * mult, the least of reps runs each): long enough
# on the kernel paths for the host clock (the 500^2 stacks' 1000 and 3000
# steps take ~1.3-6 ms of a kernel; the difference 2000 steps), short
# enough for the frame path's per-board host loop at 512 boards (one round
# a 64 steps a board). Mult 3 and 2 reps (once 5 and 3) leave phase 27
# room: the tuned paths win by 1.4-13x, far past the brackets' noise.
TUNE_LIFE = (((64, 500, 500), dict(steps=1000, mult=3, reps=2)),
             ((8, 500, 500), dict(steps=1000, mult=3, reps=2)),
             ((512, 95, 130), dict(steps=200, mult=3, reps=2)),
             ((1, 500, 500), dict(steps=1000, mult=3, reps=2)))
TUNE_STENCIL = (("heat", (64, 500, 500)), ("wireworld", (64, 500, 500)))
TUNE_STENCIL_BUDGET = dict(steps=100, mult=3, reps=2)
TUNE_SHARDED_BUDGET = dict(steps=32, mult=3, reps=2)
TUNE_KERNELS = ("vmem_batch", "bitsliced", "fused", "stencil")

# Phase 25: the serving daemon on the card. Its working directory; the
# daemon CLI's burst (the JAX CLI's mixed-shape defaults scaled to
# p46gun_big's 500^2 and phase 6's 95x130, 64-board buckets); the kernels a
# dispatch of its paths launches.
SERVE_ROOT = os.path.join(ROOT, "build", "chip_smoke_serve")
SERVE_BURST = ["--requests", "256", "--shapes", "500x500,95x130",
               "--steps", "1000,100", "--max-batch", "64"]
SERVE_KERNELS = ("vmem_batch", "bitsliced", "stencil")
# The second burst's process, hard-killed after its first batch is
# computed and before its RESOLVE is journaled.
SERVE_CRASH = ["--requests", "128", "--shapes", "95x130", "--steps", "100",
               "--max-batch", "64"]

# The second process of phase 24: a fresh store's install, the dispatch it
# steers, the two damaged launch records loaded, rebuilt and run against
# the oracle, then the kill switch. Prints one JSON object.
TUNE_SECOND_PROCESS = r"""
import json, os, sys
import numpy as np
from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.ops import native_life as nl
from mpi_and_open_mp_tpu_torch.serve import aotcache
from mpi_and_open_mp_tpu_torch.tune import PlanStore
store, chaos_dirs = sys.argv[1], sys.argv[2:]
out = {"install": PlanStore(store).install()}
out["path"] = nl.native_path_batch((64, 500, 500))
spec = stencils.get("life")
rng = np.random.default_rng(46)
stack = np.stack([spec.init(rng, (500, 500)) for _ in range(64)])
for d in chaos_dirs:
    cache = aotcache.AOTCache(d)
    digest, record, status = cache.ensure(stack.shape, stack.dtype)
    cache.call_verified(digest, stack, 8)
    out[os.path.basename(d)] = {"status": status, "stats": cache.stats(),
                                "path": record["path"],
                                "quarantined": sorted(
                                    f for f in os.listdir(d)
                                    if ".aot." in f)}
os.environ["MOMP_TUNE"] = "0"
out["kill_switch"] = {"install": PlanStore(store).install(),
                      "path": nl.native_path_batch((64, 500, 500))}
print(json.dumps(out))
"""


def tune_label(m: dict) -> str:
    """A measured candidate's name: its path, and for a sharded one its
    schedule and interior/boundary depths."""
    if "halo_overlap" not in m:
        return m["path"]
    return (f"{m['path']} {m['halo_overlap']} {m['fuse_steps']}/"
            f"{m['boundary_steps']}")


def phase_tune(card: str, wrappers: dict) -> dict:
    """Phase 24 (module docstring): the tuner, its store, its launch
    records and the CLI's ``--plans``. Returns each pass's measurements and
    the kernels' launches in them."""
    import shutil

    from mpi_and_open_mp_tpu_torch.apps import life as life_app
    from mpi_and_open_mp_tpu_torch.obs import report, trace
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.robust import chaos
    from mpi_and_open_mp_tpu_torch.serve import aotcache
    from mpi_and_open_mp_tpu_torch.tune import PlanStore, space, tune, \
        tune_sharded

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(root, ignore_errors=True)
    plans_dir = os.path.join(root, "plans")
    store = PlanStore(plans_dir)
    counted = {k: wrappers[k] for k in TUNE_KERNELS}
    launches = dict.fromkeys(TUNE_KERNELS, 0)
    passes = {}

    def held(label, res, cands):
        """The pass's contract: no rejection, every candidate timed (each
        after its oracle check), the tuned path the least time (the first
        on a tie), vs_heuristic >= 1."""
        ms = res["measurements"]
        fastest = min(m["steady_s_per_step"] for m in ms)
        first = next(m for m in ms if m["steady_s_per_step"] == fastest)
        if (res["rejected"] or len(ms) != len(cands)
                or res["tuned"] != first or res["vs_heuristic"] < 1.0):
            raise AssertionError(f"phase 24 {label}: {json.dumps(res)}")
        log(f"  tune {label}: heuristic {tune_label(res['heuristic'])}, "
            f"tuned {tune_label(res['tuned'])}, vs_heuristic "
            f"{res['vs_heuristic']}; us a step: "
            + ", ".join(f"{tune_label(m)} {m['steady_s_per_step'] * 1e6:.4f}"
                        + ("" if m["is_differenced"] else " (short bracket)")
                        for m in ms) + f" [{card}]")
        passes[label] = {k: res[k] for k in (
            "heuristic", "tuned", "vs_heuristic", "measurements")}

    def counted_pass(fn):
        res, counts = run_counted(counted, fn)
        for k, n in counts.items():
            launches[k] += n
        return res

    tuned, digests = {}, {}
    for shape, budget in TUNE_LIFE:
        res = counted_pass(lambda: tune("life", shape, store=store,
                                        **budget))
        held(f"life {shape}", res, space.candidates("life", shape))
        tuned[shape] = res["tuned"]["path"]
        digests[shape] = res["digest"]
    for workload, shape in TUNE_STENCIL:
        res = counted_pass(lambda: tune(workload, shape, store=store,
                                        **TUNE_STENCIL_BUDGET))
        held(f"{workload} {shape}", res, space.candidates(workload, shape))
        tuned[(workload, shape)] = res["tuned"]["path"]
        digests[(workload, shape)] = res["digest"]
    mesh = pm.make_mesh_2d(4, 2)
    res = counted_pass(lambda: tune_sharded(
        "life", (500, 500), mesh=mesh, store=store, **TUNE_SHARDED_BUDGET))
    held("life (500, 500) sharded 4x2", res,
         space.sharded_candidates("life", (500, 500), mesh))
    passes["life (500, 500) sharded 4x2"]["vs_sequential"] = res[
        "vs_sequential"]
    missing = [k for k, n in launches.items() if not n]
    if missing:
        raise AssertionError(f"phase 24: kernels of the tuned paths never "
                             f"launched: {missing} ({launches})")
    log(f"  tuning passes: {time.perf_counter() - t0:.2f} s; launches "
        f"{launches}")

    # Two launch records damaged on disk as they are saved, for the second
    # process to find: one bit flipped, one key skewed.
    stack_shape = (64, 500, 500)
    chaos_dirs = []
    for kind in ("bitflip", "skew"):
        d = os.path.join(root, f"aot_{kind}")
        with env_set(chaos.ENV, f"aot_corrupt={kind}:1"):
            chaos.reset()
            try:
                _, record, status = aotcache.AOTCache(d).ensure(
                    stack_shape, np.uint8)
            finally:
                chaos.reset()
        if status != "miss" or record["path"] != tuned[stack_shape]:
            raise AssertionError(f"phase 24 aot_corrupt={kind}: {status} "
                                 f"{record}")
        chaos_dirs.append(d)

    # A second process: the store installed fresh, its dispatch, the
    # damaged records, the kill switch.
    t1 = time.perf_counter()
    second = subprocess.run(
        [sys.executable, "-c", TUNE_SECOND_PROCESS, plans_dir, *chaos_dirs],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    if second.returncode != 0:
        raise AssertionError(f"phase 24 second process: "
                             f"{second.stderr[-3000:]}")
    got = json.loads(second.stdout.strip().splitlines()[-1])
    inst, kill = got["install"], got["kill_switch"]
    ladder = space.heuristic_path("life", stack_shape, True)
    if (inst["installed"] < 1 or inst["installed"] != inst["scanned"]
            or inst["corrupt"] or inst["stale"] or inst["parity_rejected"]
            or got["path"] != tuned[stack_shape]
            or got["aot_bitflip"]["status"] != "corrupt"
            or got["aot_skew"]["status"] != "stale"
            or [len(got[f"aot_{k}"]["quarantined"])
                for k in ("bitflip", "skew")] != [1, 1]
            or not kill["install"]["disabled"] or kill["path"] != ladder):
        raise AssertionError(f"phase 24 second process: {json.dumps(got)}")
    log(f"  second process ({time.perf_counter() - t1:.2f} s): installed "
        f"{inst['installed']} of {inst['scanned']} plans (corrupt, stale, "
        f"parity_rejected 0), native_path_batch((64, 500, 500)) = "
        f"{got['path']}; aot_corrupt=bitflip:1 -> "
        f"{got['aot_bitflip']['status']}, aot_corrupt=skew:1 -> "
        f"{got['aot_skew']['status']}, each quarantined, rebuilt and equal "
        f"to the oracle; MOMP_TUNE=0: disabled, path {kill['path']}")

    # The CLI: --batch 64 on the ladder, then with --plans, traced; the
    # kernel each run launched names its path.
    def cli(argv, path=None):
        with env_set(trace._ENV, path):
            trace.reset()
            try:
                (rc, out, err), counts = run_counted(
                    counted, lambda: run_cli(life_app.main, argv))
            finally:
                trace.reset()
        if rc != 0:
            raise AssertionError(f"phase 24 CLI {argv}: {err[-2000:]}")
        return out, err, counts

    kernel_of = {"bitsliced": "bitsliced", "vmem-grid": "vmem_batch",
                 "frame": "fused", "fused": "fused"}
    batch = [GUN_BIG, "--layout", "serial", "--batch", "64",
             "--print-final-population"]
    # The batched CLI reads a store of the (64, 500, 500) plan and its
    # launch record alone, so that every launch of the run (the install's
    # parity check included) is of the plan's kernel.
    cli_plans = os.path.join(root, "cli_plans")
    os.makedirs(cli_plans)
    for ext in (".plan", ".aot"):
        shutil.copy(os.path.join(plans_dir, digests[stack_shape] + ext),
                    cli_plans)
    with_plans = ["--plans", cli_plans]
    cli_rec = {}
    for label, extra, want_path in (
            ("ladder", [], ladder),
            ("--plans", with_plans, tuned[stack_shape])):
        nl.clear_planned_paths()
        path = os.path.join(root, f"cli_{len(cli_rec)}.jsonl")
        out, err, counts = cli(batch + extra + ["--trace", path], path)
        recs = report.load(path)
        installed = [r["attrs"] for r in recs if r["name"] == "tune.plan"
                     and r["attrs"]["status"] == "installed"]
        engines = {(a["workload"], a["engine"]) for a in installed}
        ran = [k for k, n in counts.items() if n]
        if (err.strip().splitlines()[-1] != "466432"
                or ran != [kernel_of[want_path]]
                or (label == "ladder") != (not installed)
                or (installed and engines != {("life", want_path)})
                or "life.run" not in [r["name"] for r in recs]):
            raise AssertionError(f"phase 24 CLI {label}: population "
                                 f"{err[-200:]!r}, launches {counts}, "
                                 f"installed {installed}")
        cli_rec[label] = {"path": want_path, "launches": counts,
                          "elapsed_s": float(out)}
        log(f"  CLI --batch 64 {label}: population 466432, path "
            f"{want_path} ({ran[0]} launched {counts[ran[0]]}x), "
            f"{len(installed)} plans installed in the trace, elapsed "
            f"{float(out):.6f} s [{card}]")
    # Elapsed seconds untraced, in turns.
    for label, extra in (("--plans", with_plans), ("ladder", []),
                         ("ladder", []), ("--plans", with_plans)):
        nl.clear_planned_paths()
        out, _, _ = cli(batch + extra)
        cli_rec[label].setdefault("untraced_elapsed_s", []).append(
            float(out))
    log("  CLI --batch 64 elapsed seconds untraced (plans, ladder, ladder, "
        f"plans): {cli_rec['--plans']['untraced_elapsed_s'][0]:.6f}, "
        + ", ".join(f"{t:.6f}" for t in cli_rec["ladder"][
            "untraced_elapsed_s"])
        + f", {cli_rec['--plans']['untraced_elapsed_s'][1]:.6f} [{card}]")
    # --resume with --plans: the status line reports the store's plan.
    nl.clear_planned_paths()
    ck = os.path.join(root, "ck")
    single = [GUN_BIG, "--layout", "serial", "--checkpoint-dir", ck]
    cli(single)
    _, err, _ = cli(single + ["--resume", "--plans", plans_dir])
    status = json.loads([ln for ln in err.splitlines()
                         if ln.startswith("{")][-1])
    if (status.get("plan_source") != "store"
            or status.get("plans_installed", 0) < 1
            or status.get("tuned_path") != tuned[(1, 500, 500)]):
        raise AssertionError(f"phase 24 --resume --plans: {status}")
    log(f"  CLI --resume --plans status line: {json.dumps(status)}")
    nl.clear_planned_paths()
    # Phase 25 serves with this store's plans: the 64-board Life bucket's
    # alone (so that a --serve run launches only its kernel), and the two
    # stencil buckets'.
    serve_plans = {}
    for label, keys in (("life", [stack_shape]),
                        ("stencil", list(TUNE_STENCIL))):
        serve_plans[label] = os.path.join(SERVE_ROOT, f"plans_{label}")
        shutil.rmtree(serve_plans[label], ignore_errors=True)
        os.makedirs(serve_plans[label])
        for key in keys:
            for ext in (".plan", ".aot"):
                src = os.path.join(plans_dir, digests[key] + ext)
                if os.path.exists(src):
                    shutil.copy(src, serve_plans[label])
    shutil.rmtree(root, ignore_errors=True)
    budget = {"life": {str(s): b for s, b in TUNE_LIFE},
              "stencils": TUNE_STENCIL_BUDGET,
              "sharded": TUNE_SHARDED_BUDGET}
    log(f"phase 24 tuning: ok ({time.perf_counter() - t0:.2f} s; budgets "
        f"{json.dumps(budget)})")
    return {"passes": passes, "launches": launches, "cli": cli_rec,
            "budget": budget, "serve_plans": serve_plans,
            "serve_tuned": {"life": tuned[stack_shape],
                            **{w: tuned[(w, sh)] for w, sh in TUNE_STENCIL}}}


def phase_serve(card: str, wrappers: dict, gun_board: np.ndarray,
                tune_rec: dict) -> dict:
    """Phase 25 (module docstring): the serving daemon's ticket path on
    the card. Returns each run's record and the kernels' launches in them.
    ``gun_board`` is p46gun_big's oracle board at its 10 000 steps."""
    import shutil

    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.apps import life as life_app
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.robust import chaos
    from mpi_and_open_mp_tpu_torch.serve import ServePolicy, ServingDaemon
    from mpi_and_open_mp_tpu_torch.serve import daemon as daemon_cli
    from mpi_and_open_mp_tpu_torch.serve.queue import DONE
    from mpi_and_open_mp_tpu_torch.tune import PlanStore
    from mpi_and_open_mp_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    plans = tune_rec["serve_plans"]
    for workload, path in tune_rec["serve_tuned"].items():
        want = "vmem-grid" if workload == "life" else "stencil:native"
        if path != want:
            raise AssertionError(f"phase 25: phase 24 tuned {workload} "
                                 f"(64, 500, 500) to {path}, not {want}")
    work = os.path.join(SERVE_ROOT, "runs")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counted = {k: wrappers[k] for k in SERVE_KERNELS}
    launches: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    plain_refs: dict[tuple, np.ndarray] = {}

    def counted_run(label, fn):
        nl.clear_planned_paths()
        out, counts = run_counted(counted, fn)
        launches[label] = counts
        return out

    def card_only(daemon, label):
        """No ticket on the card ever resolves on the plain loop or the
        oracle."""
        bad = sorted({t.engine for t in daemon.queue.tickets()
                      if t.engine and t.engine.startswith(
                          ("batch:plain", "oracle"))})
        if bad:
            raise AssertionError(f"phase 25 {label}: stamps {bad}")

    def plain_life(boards: np.ndarray, steps: int) -> np.ndarray:
        """The plain packed loop on CUDA tensors, called directly."""
        key = (boards.shape, steps, boards.tobytes())
        if key not in plain_refs:
            plain_refs[key] = tb.life_run_bits_plain_batch(
                torch.from_numpy(boards).cuda(), steps).cpu().numpy()
        return plain_refs[key]

    def held_to_plain(daemon, label):
        """Every resolved Life board equal to the plain loop's on the card,
        bucket by bucket."""
        groups: dict[tuple, list] = {}
        for t in daemon.queue.tickets():
            if t.state == DONE:
                groups.setdefault((t.board.shape, t.steps), []).append(t)
        for (_, steps), ts in groups.items():
            want = plain_life(np.stack([t.board for t in ts]), steps)
            got = np.stack([t.result for t in ts])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"phase 25 {label}: {int((got != want).sum())} cells "
                    "differ from the plain loop on the card")
        card_only(daemon, label)

    def daemon_run(label, argv, *, chaos_spec=None, want_rc=0):
        with env_set(chaos.ENV, chaos_spec):
            chaos.reset()
            try:
                rc, rec, daemon = counted_run(
                    label, lambda: daemon_cli.run(argv))
            finally:
                chaos.reset()
        if rc != want_rc:
            raise AssertionError(f"phase 25 {label}: rc {rc}, "
                                 f"{json.dumps(rec)[:2000]}")
        return rec, daemon

    # (a) The Life CLI: --serve 64 --batch 64 on p46gun_big, on the ladder
    # and with phase 24's plan of the 64-board bucket.
    cfg = load_config(GUN_BIG)
    for label, extra, kernel in (("ladder", [], "bitsliced"),
                                 ("--plans", ["--plans", plans["life"]],
                                  "vmem_batch")):
        parser = life_app.build_parser()
        args = parser.parse_args([GUN_BIG, "--layout", "serial", "--serve",
                                  "64", "--batch", "64", *extra])
        (rc, daemon), out, err = counted_run(
            f"life --serve {label}",
            lambda: captured(lambda: life_app.serve(args, cfg, parser)))
        s = daemon.summary()
        counts = launches[f"life --serve {label}"]
        ran = [k for k, n in counts.items() if n]
        pops = {int(t.result.sum()) for t in daemon.queue.tickets()}
        if (rc != 0 or len(out.split()) != 1 or s["resolved"] != 64
                or s["shed"] or s["degraded"] or pops != {7288}
                or "served 64/64 (shed 0, degraded 0" not in err
                or ran != [kernel]
                or not all(np.array_equal(t.result, gun_board)
                           for t in daemon.queue.tickets())):
            raise AssertionError(f"phase 25 life --serve {label}: rc {rc}, "
                                 f"{s}, populations {pops}, launches "
                                 f"{counts}, stderr {err[-500:]!r}")
        card_only(daemon, f"life --serve {label}")
        runs[f"life --serve 64 {label}"] = {
            "elapsed_s": float(out), "engines": s["engines"],
            "p99_latency_s": s["p99_latency_s"], "launches": counts}
        log(f"  Life CLI --serve 64 --batch 64 {label}: 64/64 resolved, "
            f"every board the oracle's (population 7288), "
            f"{s['engines']}, {kernel} launched {counts[kernel]}x, "
            f"elapsed {float(out):.6f} s, p99 {s['p99_latency_s']} s "
            f"[{card}]")

    # (b) The daemon CLI's 256-ticket burst under each journal policy.
    for fsync in ("every-record", "every-chunk"):
        label = f"daemon --wal-fsync {fsync}"
        rec, daemon = daemon_run(label, SERVE_BURST + [
            "--wal", os.path.join(work, f"{fsync}.wal"),
            "--wal-fsync", fsync])
        if rec["resolved"] != 256 or rec["shed"] or rec["degraded"]:
            raise AssertionError(f"phase 25 {label}: {json.dumps(rec)}")
        held_to_plain(daemon, label)
        runs[label] = {k: rec[k] for k in (
            "requests_per_sec", "wall_sec", "p50_latency_s",
            "p99_latency_s", "batches", "engines", "wal")}
        runs[label]["launches"] = launches[label]
        w = rec["wal"]
        log(f"  daemon CLI 256 tickets ({' '.join(SERVE_BURST[2:6])}), "
            f"--wal-fsync {fsync}: {rec['requests_per_sec']} requests/s, "
            f"wall {rec['wall_sec']} s, p50 {rec['p50_latency_s']} s, p99 "
            f"{rec['p99_latency_s']} s, {rec['batches']} batches, "
            f"{rec['engines']}; journal {w['records']} records, "
            f"{w['syncs']} syncs ({w['sync_seconds']} s), {w['bytes']} "
            f"bytes; every board the plain loop's [{card}]")

    # Where a dispatch of the burst's 64 x 500^2 chunk spends its time
    # (host clock around each part, synced; the kernel by CUDA events),
    # three times.
    chunk = [t for t in daemon.queue.tickets()
             if t.board.shape == (500, 500)][:64]
    validator = daemon._validator((64, 500, 500))
    parts: dict[str, list] = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(
            round((time.perf_counter() - t1) * 1e3, 4))
        return out

    for _ in range(3):
        stack = timed("host stack ms", lambda: np.stack(
            [t.board for t in chunk]))
        dev = timed("to card ms", lambda: torch.from_numpy(stack).cuda())
        parts.setdefault("kernel path ms", []).append(round(cuda_ms(
            lambda: nl.life_run_vmem_batch(dev, 1000)), 4))
        out = nl.life_run_vmem_batch(dev, 1000)
        host = timed("to host ms", lambda: out.cpu().numpy())
        timed("validator ms", lambda: validator(host))
    w = runs["daemon --wal-fsync every-record"]["wal"]
    parts["fsync ms a record (every-record)"] = round(
        w["sync_seconds"] / w["syncs"] * 1e3, 4)
    runs["dispatch breakdown 64 x 500^2, 1000 steps"] = parts
    log(f"  a 64 x 500^2 dispatch at 1000 steps, by part: {parts} "
        f"[{card}]")

    # Padding under plans: 40 tickets of 500^2 pad to a 64-board stack
    # (the board-sliced plane rounding) even where a plan sends the
    # bucket to vmem-grid. Its cost: 64 boards against 40, 1000 steps.
    pad = {}
    stacks = {b: torch.from_numpy(np.stack([gun_board] * b)).cuda()
              for b in (64, 40)}
    for b, stack in stacks.items():  # each geometry's first launch
        nl.run_path_batch("vmem-grid", stack, 8)
    for b in (64, 40, 40, 64):
        pad.setdefault(b, []).append(cuda_ms(
            lambda: nl.run_path_batch("vmem-grid", stacks[b], 1000), 3))
    del stacks
    runs["padding under plans"] = {"vmem-grid 1000 steps ms": pad}
    log(f"  padding under plans: vmem-grid 1000 steps of 64 x 500^2 "
        f"{pad[64]} ms against 40 x 500^2 {pad[40]} ms (CUDA events, 3 "
        f"calls each, in turns) [{card}]")

    # (c) Recovery on the card. serve_fail=1 on the ladder (the cell-packed
    # rung) and with the plan (the primary's clean re-run).
    for label, extra, stamp in (
            ("serve_fail ladder", [], "batch:vmem-grid:recovered"),
            ("serve_fail --plans", ["--plans", plans["life"]],
             "batch:vmem-grid:recovered")):
        rec, daemon = daemon_run(label, [
            "--requests", "64", "--shapes", "500x500", "--steps", "100",
            "--max-batch", "64", *extra], chaos_spec="serve_fail=1")
        if (rec["resolved"] != 64 or rec["degraded"] != 1
                or rec["engines"] != {stamp: 64}):
            raise AssertionError(f"phase 25 {label}: {json.dumps(rec)}")
        held_to_plain(daemon, label)
        runs[label] = {"engines": rec["engines"],
                       "launches": launches[label]}
        log(f"  {label}: degraded 1, {rec['engines']}, launches "
            f"{launches[label]}, boards the plain loop's")

    # preempt=1 with a checkpoint: exit 75; --resume --verify drains the
    # rest from the checkpoint, every board held to the NumPy oracle.
    ck = os.path.join(work, "queue.state")
    burst = ["--requests", "128", "--shapes", "95x130", "--steps", "100",
             "--max-batch", "64"]
    rec1, daemon = daemon_run("preempt", burst + ["--checkpoint", ck],
                              chaos_spec="preempt=1", want_rc=75)
    card_only(daemon, "preempt")
    rec2, daemon = daemon_run("resume", [
        "--requests", "0", "--resume", "--checkpoint", ck, "--verify",
        "--max-batch", "64"])
    if (not rec1["preempted"] or rec1["resolved"] != 64
            or rec2["resume_source"] != "checkpoint"
            or rec2["resolved"] != 64 or not rec2["verified"]):
        raise AssertionError(f"phase 25 preempt/resume: {json.dumps(rec1)} "
                             f"{json.dumps(rec2)}")
    card_only(daemon, "resume")
    log(f"  preempt=1: exit 75 after {rec1['batches']} batch, 64 resolved, "
        f"64 checkpointed; --resume --verify: source checkpoint, 64 "
        f"resolved, verified against the oracle, {rec2['engines']}")

    # crash=post-dispatch:1 in a child daemon: exit 137 with the batch
    # computed and unjournaled; resume_any replays it from the journal.
    walp = os.path.join(work, "crash.wal")
    t1 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.serve.daemon",
         *SERVE_CRASH, "--wal", walp],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                           **{chaos.ENV: "crash=post-dispatch:1"}),
        capture_output=True, text=True, timeout=300)
    if child.returncode != chaos.CRASH_EXIT:
        raise AssertionError(f"phase 25 crash child: rc {child.returncode}"
                             f", {child.stderr[-2000:]}")
    def crash_resume():
        d, source, detail = ServingDaemon.resume_any(
            wal_path=walp, policy=ServePolicy(max_batch=64, max_wait_s=0.0))
        d.drain()
        return d, source, detail

    daemon, source, detail = counted_run("crash resume", crash_resume)
    rep = detail["wal_replay"]
    s = daemon.summary()
    if (source != "wal" or rep["pending"] != 128 or rep["in_flight"] != 64
            or s["resolved"] != 128 or s["pending"]):
        raise AssertionError(f"phase 25 crash resume: {source} {detail} "
                             f"{s}")
    held_to_plain(daemon, "crash resume")
    runs["crash"] = {"replay": rep, "engines": s["engines"]}
    log(f"  crash=post-dispatch:1: child exit 137 "
        f"({time.perf_counter() - t1:.2f} s); resume_any from the journal: "
        f"{rep['pending']} pending, {rep['in_flight']} in flight, drained "
        f"{s['resolved']}, {s['engines']}, boards the plain loop's")

    # (d) Heat and wireworld 64 x 500^2 buckets, 100 steps, with phase
    # 24's stencil:native plans installed.
    rng = np.random.default_rng(46)
    specs = [stencils.get(n) for n in ("heat", "wireworld")]
    boards = {sp.name: np.stack([sp.init(rng, (500, 500))
                                 for _ in range(64)]) for sp in specs}

    def stencil_serve():
        # Admission projects a growing bucket's pow2 padding: a bucket
        # that ends full must not be shed on its way there.
        d = ServingDaemon(ServePolicy(max_batch=64, max_depth=256,
                                      max_padding_frac=1.0, max_wait_s=0.0),
                          plan_store=PlanStore(plans["stencil"]))
        for sp in specs:
            for b in boards[sp.name]:
                d.submit(b, 100, workload=sp.name)
        d.serve()
        return d

    daemon = counted_run("stencil buckets", stencil_serve)
    s = daemon.summary()
    if s["resolved"] != 128:
        raise AssertionError(f"phase 25 stencil buckets: {s}")
    errs = {}
    for sp in specs:
        ts = [t for t in daemon.queue.tickets() if t.workload == sp.name]
        got = np.stack([t.result for t in ts])
        want = stencils.run_roll_batch(
            sp, torch.from_numpy(boards[sp.name]).cuda(), 100).cpu().numpy()
        errs[sp.name] = float(np.abs(got.astype(np.float64) - want).max())
        ok = (stencils.parity_ok(sp, got, want,
                                 **stencils.parity_tol_for("offset"))
              if sp.is_float else np.array_equal(got, want))
        if not ok or {t.engine for t in ts} != {
                f"batch:stencil-native:{sp.name}"}:
            raise AssertionError(f"phase 25 {sp.name} bucket: max err "
                                 f"{errs[sp.name]}, {s['engines']}")
    if s["plans_installed"] != 2 or not launches["stencil buckets"][
            "stencil"]:
        raise AssertionError(f"phase 25 stencil buckets: {s}, launches "
                             f"{launches['stencil buckets']}")
    card_only(daemon, "stencil buckets")
    runs["stencil buckets"] = {"engines": s["engines"], "max_abs_err": errs,
                               "launches": launches["stencil buckets"]}
    log(f"  heat and wireworld 64 x 500^2, 100 steps, plans installed: "
        f"{s['engines']}, stencil_padded launched "
        f"{launches['stencil buckets']['stencil']}x; max |err| against "
        f"the roll engine on the card {errs} (heat within "
        f"parity_tol_for('offset'), wireworld exact)")

    # (e) The launch-record rung: 64 x 500^2 at 64 steps, twice.
    aot_dir = os.path.join(work, "aot")
    for label, status in (("aot miss", "misses"), ("aot hit", "hits")):
        rec, daemon = daemon_run(label, [
            "--requests", "64", "--shapes", "500x500", "--steps", "64",
            "--max-batch", "64", "--aot-cache", aot_dir])
        if (rec["engines"] != {"aot:bitsliced": 64} or not rec["aot"][status]
                or (label == "aot hit" and rec["aot"]["misses"])):
            raise AssertionError(f"phase 25 {label}: {json.dumps(rec)}")
        held_to_plain(daemon, label)
        runs[label] = {"engines": rec["engines"], "aot": rec["aot"]}
        log(f"  --aot-cache {label}: {rec['engines']}, aot stats "
            f"{rec['aot']}, boards the plain loop's")

    nl.clear_planned_paths()
    shutil.rmtree(SERVE_ROOT, ignore_errors=True)
    totals = {k: sum(c[k] for c in launches.values()) for k in SERVE_KERNELS}
    log(f"phase 25 serving: ok ({time.perf_counter() - t0:.2f} s; launches "
        f"{totals})")
    return {"runs": runs, "launches": launches, "totals": totals}


# Phase 26: the resident-session pool, on POOL_DEV (the card).
POOL_DEV = torch.device("cuda")
POOL_ROOT = os.path.join(ROOT, "build", "chip_smoke_pool")
# The JAX bench's resident-session A/B (bench.py:775-870): soups at density
# 0.3 from default_rng(48), 4 steps a round, 8 rounds, max_batch 8; at 1024
# sessions of its 48^2 and 256 of p46gun_big's 500^2.
POOL_AB = ((48, 1024), (500, 256))
# 4 rounds (the bench's 8 halved to give phase 27 room; the rates and
# their ratio are per ticket, so the rounds set only how long they run).
POOL_AB_ROUNDS, POOL_AB_STEPS, POOL_AB_SEED, POOL_AB_DENSITY = 4, 4, 48, 0.3
# pool_step (row 5's rounds, the last in the tail mode) against its plain
# version: plane extents (a 1-row and a 1-column torus, whose neighbours
# alias the cell, 3x3, the bench's 48^2, 95x130, the flagship's 500^2),
# slabs of 1 and 2 planes, four masks each, at step counts that take one,
# two and three rounds at the halo-8 geometries (1x7, 3x3 and 48^2 take one
# launch at every count), and 1000 steps at 500^2.
POOL_TAIL_SHAPES = ((1, 7), (7, 1), (3, 3), (48, 48), (95, 130), (500, 500))
POOL_MASKS = ("random", "all", "empty", "lane 31")
POOL_TAIL_STEPS = (1, 2, 8, 9, 17, 33)
# The traced dispatches at 500^2, and the timed ones (500^2 and 48^2).
POOL_TRACE_STEPS, POOL_TIME_STEPS = (4, 100), (4, 1000)
# The default budget (serve/pool.py:95-98) filled with 500^2 one-plane
# slabs of 1 000 000 bytes: 67 slabs of 32 sessions from 64 distinct
# boards; rounds of one step_group over every session.
POOL_BUDGET_ROUNDS, POOL_BUDGET_STEPS, POOL_BUDGET_BOARDS = 3, 100, 64
# Phase 26's kernels, as main names their wrappers (pool_step's launches
# are row 5's kernel's, counted in both).
POOL_KERNELS = ("bitsliced", "pool_step", "pool_lane_write",
                "pool_lane_read")
# The lane kernels' exactness planes: the timed 500^2 and 48^2, a ragged
# 9x14 and 17x33 (126 and 561 cells, not a multiple of the 16-cell chunk).
POOL_LANE_SHAPES = ((500, 500), (48, 48), (9, 14), (17, 33))
# The back-to-back check: creates of distinct 500^2 boards, then as many
# snapshots, no wait between (a slot rewritten before its kernel read it
# would show).
POOL_BACK_TO_BACK = 64
# The lane ops' bound (``lane_bound_ms``) takes the link at the larger of
# PCIe 5.0 x16's nominal rate a direction and the measured rate of a
# page-locked copy of this many bytes that way.
LINK_COPY_BYTES = 64 << 20
# Calls a lane op's host-clock time averages over.
POOL_LANE_HOST_CALLS = 200


def pool_words(g, shape) -> torch.Tensor:
    """Random int32 words (every bit, the sign bit too) on POOL_DEV."""
    return torch.randint(-2**31, 2**31, shape, generator=g, device=POOL_DEV,
                         dtype=torch.int64).to(torch.int32)


def pool_mask(g, kind: str, planes: int) -> torch.Tensor:
    if kind == "random":
        return pool_words(g, (planes,))
    fill = {"all": -1, "empty": 0, "lane 31": -2**31}[kind]
    return torch.full((planes,), fill, dtype=torch.int32, device=POOL_DEV)


def dispatch_records(calls: list, tries: int = 5) -> list[dict]:
    """The device records of one traced call of each ``fn`` of ``calls``,
    ``(fn, want)`` pairs of a pool dispatch and its kernel launches, in one
    ``torch.profiler`` trace: every kernel record must be
    ``bitlife_bitsliced_kernel``, and each dispatch is its memset and the
    kernel records up to the next memset, at most ``want`` of them. The
    card's tracer loses the records of a trace's first milliseconds (see
    :func:`grad_step_kernels`), so each trace first runs a discarded
    warm-up step (20 calls of each, 10 ms), then records one call of each;
    traces are taken until one keeps all (each shortfall logged; raises
    after ``tries``). Returns that trace's counts, a dict a call."""
    from torch.profiler import ProfilerActivity, profile, schedule

    want = [w for _, w in calls]
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for fn, _ in calls:
                for _ in range(20):
                    fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
            prof.step()
            for fn, _ in calls:
                fn()
                torch.cuda.synchronize()
            prof.step()
        names = [ev.name for ev in sorted(
            (ev for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda ev: ev.time_range.start)]
        foreign = sorted({n for n in names if "memset" not in n.lower()
                          and "bitlife_bitsliced_kernel" not in n})
        got = []
        for n in names:
            if "memset" in n.lower():
                got.append(0)
            elif got:
                got[-1] += 1
        if foreign or len(got) > len(calls) or any(
                k > w for k, w in zip(got, want)):
            raise AssertionError(f"phase 26 dispatch trace: kernel records "
                                 f"{got} after each memset, {want} "
                                 f"launched; other device work {foreign}")
        if got == want:
            return [{"bitlife_bitsliced_kernel": k, "memsets": 1,
                     "traces": attempt} for k in got]
        log(f"  dispatch trace {attempt} kept {got} of {want} kernel "
            "records after each memset")
    raise AssertionError(f"phase 26: no trace of {tries} kept the "
                         f"dispatches' {want} kernel records")


def link_rates(reps: int = 5) -> dict[str, float]:
    """Bytes a second of a ``LINK_COPY_BYTES`` copy from page-locked host
    memory to the card (``h2d``) and back (``d2h``), CUDA events over
    ``reps`` copies after one warm-up each."""
    host = torch.ones(LINK_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_COPY_BYTES, dtype=torch.uint8, device="cuda")
    rates = {}
    for way, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps)
        rates[way] = LINK_COPY_BYTES / (ms * 1e-3)
    del host, dev
    return rates


def pcie_line() -> str:
    """``nvidia-smi``'s PCIe generation and width, the link's maximum."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (out.stdout.strip() or out.stderr.strip()).splitlines()[0]


def pinned_bytes() -> dict[str, int] | None:
    """What torch's page-locked host allocator holds from CUDA and hands
    out (``torch.cuda.host_memory_stats``; ``None`` where the installed
    torch lacks it), after a garbage collection (a freed block goes back to
    the allocator's cache, and stays in what it holds)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    gc.collect()
    got = stats()
    return {k: int(got[k]) for k in ("allocated_bytes.current",
                                     "active_bytes.current")}


def host_clock_ms(fn, calls: int) -> float:
    """Host milliseconds a call of ``fn()`` over ``calls`` calls, synced
    before and after (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e3


def lane_records(fn, kernel: str, tries: int = 5) -> dict:
    """The device records of one traced call of ``fn()``, a lane op: it
    must be exactly one ``kernel`` record, no copy, no memset, nothing
    else. Each trace first runs a discarded warm-up step (20 calls, then
    10 ms: the card's tracer loses a trace's first records); traces are
    taken until one keeps the record (raises after ``tries``, or at once
    on any other record)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) > 1 or any(kernel not in n for n in names):
            raise AssertionError(f"phase 26 {kernel}: one op's device "
                                 f"records {names}, want one {kernel}")
        if names:
            return {"records": len(names), "memcpy": 0, "traces": attempt}
        log(f"  lane trace {attempt} kept no {kernel} record")
    raise AssertionError(f"phase 26: no trace of {tries} kept the "
                         f"{kernel} record")


def pinned_board(g, shape, offset: int = 0) -> torch.Tensor:
    """A random page-locked host uint8 board (0 for about 0.6 of the
    cells, else any byte 1..255), starting ``offset`` bytes into its
    buffer."""
    cells = torch.randint(1, 256, shape, generator=g, device=POOL_DEV,
                          dtype=torch.int32)
    live = torch.rand(shape, generator=g, device=POOL_DEV) < 0.4
    buf = torch.empty(offset + shape[0] * shape[1], dtype=torch.uint8,
                      pin_memory=True)
    board = buf[offset:].view(shape)
    board.copy_(torch.where(live, cells, 0).to(torch.uint8))
    return board


def pool_kernel_checks() -> dict:
    """``pool_step`` against its plain version at ``POOL_TAIL_*``, every
    word and change word equal, the input unwritten (the plain steps run
    once a slab, ``_pool_step_plain``'s merge once a mask); the C entry's
    refusals; a traced dispatch at 500^2 for each of ``POOL_TRACE_STEPS``;
    then ``pool_lane_write`` and ``pool_lane_read`` against theirs. Returns
    the case counts and the traces."""
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npl

    g = torch.Generator(device=POOL_DEV).manual_seed(26)
    cases = {"pool_step": 0, "pool_lane_write": 0, "pool_lane_read": 0}
    t0 = time.perf_counter()
    runs = [(planes, shape, steps) for planes in (1, 2)
            for shape in POOL_TAIL_SHAPES for steps in POOL_TAIL_STEPS]
    for planes, shape, steps in runs + [(1, (500, 500), 1000)]:
        slab = pool_words(g, (planes, *shape))
        keep = slab.clone()
        cur, want_change = npl._pool_step_plain(
            slab, steps, pool_mask(g, "all", planes))
        for kind in POOL_MASKS if steps < 1000 else ("random",):
            mask = pool_mask(g, kind, planes)
            want = npl._merge(cur, slab, mask)
            got, change = npl.pool_step(slab, steps, mask)
            if (not torch.equal(got, want)
                    or not torch.equal(change, want_change)
                    or not torch.equal(slab, keep)):
                raise AssertionError(
                    f"phase 26 pool_step {planes} x {shape} at {steps} "
                    f"steps, mask {kind}: {diff_count(got, want)} words and "
                    f"{diff_count(change, want_change)} change words differ "
                    f"from the plain version, {diff_count(slab, keep)} "
                    "input words written")
            cases["pool_step"] += 1
    seconds = {"pool_step": time.perf_counter() - t0}
    # The entry's own refusals: no step, and an output on its input.
    lib = _build.load("bitlife_bitsliced")
    geo = tb.plan_bitsliced(tuple(slab.shape))
    other, change = torch.empty_like(slab), torch.empty(
        slab.shape[0], dtype=torch.int32, device=POOL_DEV)
    launched = ctypes.c_int(0)
    for out, steps, code in ((other, 0, -5), (slab, 1, -6)):
        rc = lib.bitlife_bitsliced_pool(
            slab.data_ptr(), out.data_ptr(), other.data_ptr(),
            mask.data_ptr(), change.data_ptr(), *slab.shape, *geo.args(),
            steps, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
        if rc != code or launched.value:
            raise AssertionError(f"phase 26 bitlife_bitsliced_pool at "
                                 f"{steps} steps: rc {rc}, {launched.value} "
                                 f"launched, want {code}")
    try:
        npl.pool_step(slab, 1, torch.zeros(1, dtype=torch.int32))
    except ValueError:
        pass
    else:
        raise AssertionError("phase 26: a host mask reached the kernel")
    # A dispatch at 500^2 of each of POOL_TRACE_STEPS, traced: row 5's
    # launches and a memset only.
    t0 = time.perf_counter()
    slab = pool_words(g, (1, 500, 500))
    mask = pool_mask(g, "random", 1)
    geo = tb.plan_bitsliced((1, 500, 500))
    traces = dict(zip(POOL_TRACE_STEPS, dispatch_records([
        ((lambda s=steps: npl.pool_step(slab, s, mask)), geo.launches(steps))
        for steps in POOL_TRACE_STEPS])))
    seconds["traces"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases.update(lane_kernel_checks(g))
    torch.cuda.synchronize()
    seconds["lanes"] = time.perf_counter() - t0
    return {**cases, "traces": traces,
            "seconds": {k: round(v, 3) for k, v in seconds.items()}}


def lane_kernel_checks(g) -> dict:
    """``pool_lane_write`` and ``pool_lane_read`` on page-locked host
    boards against their plain versions on the same boards on the card, at
    ``POOL_LANE_SHAPES`` and lanes 0, 31, 32 and 63 of a 2-plane slab, the
    48^2 plane also from and into buffers one byte off 16 (the cell-by-cell
    path); the refusals of a pageable and a device board and of a read
    with no ``out``. Returns the case counts."""
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npl

    cases = {"pool_lane_write": 0, "pool_lane_read": 0}
    runs = [(shape, lane, 0) for shape in POOL_LANE_SHAPES
            for lane in (0, 31, 32, 63)] + [((48, 48), 33, 1)]
    for shape, lane, offset in runs:
        plane, bit = divmod(lane, 32)
        slab = pool_words(g, (2, *shape))
        board = pinned_board(g, shape, offset)
        want, got = slab.clone(), slab.clone()
        npl._lane_write_plain(want, board.to(POOL_DEV), plane, bit)
        npl.pool_lane_write(got, board, plane, bit)
        out = pinned_board(g, shape, offset)
        npl.pool_lane_read(got, plane, bit, out)
        torch.cuda.synchronize()
        if (not torch.equal(got, want) or not torch.equal(
                out, npl._lane_read_plain(want, plane, bit).cpu())
                or not torch.equal(out, (board != 0).to(torch.uint8))):
            raise AssertionError(f"phase 26 lane {lane} at {shape} (offset "
                                 f"{offset}): the write or the read differs")
        cases["pool_lane_write"] += 1
        cases["pool_lane_read"] += 1
    slab = pool_words(g, (1, 48, 48))
    for bad in (torch.zeros((48, 48), dtype=torch.uint8),
                torch.zeros((48, 48), dtype=torch.uint8, device=POOL_DEV)):
        for call in (lambda: npl.pool_lane_write(slab, bad, 0, 0),
                     lambda: npl.pool_lane_read(slab, 0, 0, bad),
                     lambda: npl.pool_lane_read(slab, 0, 0)):
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"phase 26: a lane op took a board on "
                                 f"{bad.device} that is not page-locked")
    return cases


def pool_oracle(boards: list, steps: int) -> list:
    """Each board after ``steps`` steps of an independent engine on the
    card, row 4's cell-packed stack kernel (``life_run_vmem_bits_batch``),
    which phases 4 and 5 hold to its plain version and the NumPy oracle."""
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb

    if steps == 0:
        return list(boards)
    stack = torch.from_numpy(np.stack(boards)).to(POOL_DEV)
    return list(tb.life_run_vmem_bits_batch(stack, steps).cpu().numpy())


def pool_numpy_oracle(board: np.ndarray, steps: int) -> np.ndarray:
    from mpi_and_open_mp_tpu_torch.ops import life_ops

    for _ in range(steps):
        board = life_ops.life_step_numpy(board)
    return board


def phase_pool(card: str, wrappers: dict, gun_board: np.ndarray) -> dict:
    """Phase 26 (module docstring): the resident-session pool on the card.
    Returns the runs' records, the kernels' launches in them and the
    kernel rows' times. ``gun_board`` is p46gun_big's oracle board at its
    10 000 steps."""
    import shutil

    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npl
    from mpi_and_open_mp_tpu_torch.robust import chaos
    from mpi_and_open_mp_tpu_torch.serve import (
        DEFAULT_DEVICE_BUDGET, ServePolicy, ServingDaemon, SessionPool, wal)
    from mpi_and_open_mp_tpu_torch.serve import pool as spool
    from mpi_and_open_mp_tpu_torch.serve.pool import LANE_RING_SLOTS
    from mpi_and_open_mp_tpu_torch.serve.queue import DONE
    from mpi_and_open_mp_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    counted = {k: wrappers[k] for k in POOL_KERNELS}
    launches: dict[str, dict] = {}
    runs: dict[str, dict] = {}

    def counted_run(label, fn):
        npl.pool_step.dispatches = 0
        out, counts = run_counted(counted, fn)
        counts["dispatches"] = npl.pool_step.dispatches
        launches[label] = counts
        return out

    def same(label, got: dict, want: dict) -> None:
        bad = [sid for sid in want if not np.array_equal(got[sid], want[sid])]
        if bad:
            raise AssertionError(f"phase 26 {label}: {len(bad)} of "
                                 f"{len(want)} sessions differ ({bad[:4]})")

    # (a) The kernels against their plain versions (not counted).
    checks = pool_kernel_checks()
    log(f"  pool kernels against their plain versions: {checks}, every "
        "word equal")
    # A one-plane 500^2 slab's launches at s steps.
    plane_launches = tb.plan_bitsliced((1, 500, 500)).launches

    # (b) The flagship's size: p46gun_big and 39 soups of 500^2 in two
    # slabs; a lone step, a 32-lane group and both slabs, 10 000 steps.
    life = stencils.get("life")
    rng = np.random.default_rng(46)
    gun0 = load_config(GUN_BIG).board()
    soups = {f"soup{i:02d}": life.init(rng, (500, 500)) for i in range(39)}

    def flagship():
        pool = SessionPool(device=POOL_DEV)
        pool.create("gun", gun0)
        for sid, b in soups.items():
            pool.create(sid, b)
        slab0 = [sid for sid in pool.sessions() if pool.handle(sid).slab == 0]
        n = [pool.step_group(["gun"], 1), pool.step_group(slab0, 999),
             pool.step_group(pool.sessions(), 9000)]
        return slab0, n, {sid: pool.snapshot(sid) for sid in pool.sessions()}

    t1 = time.perf_counter()
    slab0, dispatches, snaps = counted_run("flagship", flagship)
    flag_s = time.perf_counter() - t1
    in0 = [sid for sid in soups if sid in slab0]
    in1 = [sid for sid in soups if sid not in slab0]
    want = dict(zip(in0, pool_oracle([soups[s] for s in in0], 9999)))
    want.update(zip(in1, pool_oracle([soups[s] for s in in1], 9000)))
    want["gun"] = gun_board
    counts = launches["flagship"]
    flag_launches = (plane_launches(1) + plane_launches(999)
                     + 2 * plane_launches(9000))
    if (dispatches != [1, 1, 2] or len(in0) != 31
            or int(snaps["gun"].sum()) != 7288
            or counts["dispatches"] != 4
            or counts["pool_step"] != flag_launches
            or counts["bitsliced"] != flag_launches
            or counts["pool_lane_write"] != 40
            or counts["pool_lane_read"] != 40):
        raise AssertionError(f"phase 26 flagship: dispatches {dispatches}, "
                             f"population {int(snaps['gun'].sum())}, "
                             f"launches {counts}")
    same("flagship", snaps, want)
    runs["flagship 40 x 500^2"] = {"dispatches": dispatches,
                                   "launches": counts, "seconds": flag_s}
    log(f"  p46gun_big and 39 soups of 500^2 in 2 slabs (a lone step, a "
        f"32-lane group of 999, both slabs 9000): p46gun_big's snapshot the "
        f"oracle's (population 7288), every soup row 4's board at 9999 or "
        f"9000 steps; launches {counts} ({flag_s:.3f} s)")

    # (b2) Back to back: distinct 500^2 boards created with no wait between
    # them, then snapshotted the same way, every board exact; the ring's
    # page-locked bytes one ring, and torch's page-locked allocator holding
    # and handing out what it did after the first create (the ring made).
    brng = np.random.default_rng(2626)
    fresh = [life.init(brng, (500, 500)) for _ in range(POOL_BACK_TO_BACK)]

    def back_to_back():
        pool = SessionPool(device=POOL_DEV)
        pool.create("f00", fresh[0])
        before = pinned_bytes()
        for i, b in enumerate(fresh[1:], 1):
            pool.create(f"f{i:02d}", b)
        snaps = [pool.snapshot(f"f{i:02d}") for i in range(len(fresh))]
        return snaps, pool.lane_ring_bytes(), (before, pinned_bytes())

    snaps, ring_bytes, host = counted_run("back to back", back_to_back)
    counts = launches["back to back"]
    bad = [i for i, (a, b) in enumerate(zip(snaps, fresh))
           if not np.array_equal(a, b)]
    if (bad or ring_bytes != LANE_RING_SLOTS * 500 * 500
            or host[0] != host[1]
            or counts["pool_lane_write"] != POOL_BACK_TO_BACK
            or counts["pool_lane_read"] != POOL_BACK_TO_BACK):
        raise AssertionError(f"phase 26 back to back: boards {bad[:4]} "
                             f"differ, ring {ring_bytes} B, torch's "
                             f"page-locked allocator {host[0]} then "
                             f"{host[1]}, launches {counts}")
    runs["back to back"] = {"boards": POOL_BACK_TO_BACK,
                            "ring_bytes": ring_bytes,
                            "host_allocator": host[1], "launches": counts}
    log(f"  back to back: {POOL_BACK_TO_BACK} creates of distinct 500^2 "
        f"boards, then {POOL_BACK_TO_BACK} snapshots, every board exact; "
        f"the ring {ring_bytes} B page-locked; torch's page-locked host "
        f"allocator {host[1]} after them as after the first create "
        f"(None: this torch has no host_memory_stats); launches {counts}")

    # (c) The default budget filled with 500^2 slabs.
    n_slabs = DEFAULT_DEVICE_BUDGET // (500 * 500 * 4)
    n_sess = n_slabs * 32
    brng = np.random.default_rng(64)
    distinct = [life.init(brng, (500, 500))
                for _ in range(POOL_BUDGET_BOARDS)]
    sids = [f"b{i:04d}" for i in range(n_sess)]
    pool = SessionPool(device=POOL_DEV)
    for i, sid in enumerate(sids):
        pool.create(sid, distinct[i % POOL_BUDGET_BOARDS])
    st = pool.stats()
    if st["slabs"] != n_slabs or st["spills"]:
        raise AssertionError(f"phase 26 budget fill: {st}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # the slabs and earlier phases'

    def budget_rounds():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(POOL_BUDGET_ROUNDS):
            pool.step_group(sids, POOL_BUDGET_STEPS)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    wall = counted_run("default budget", budget_rounds)
    peak = torch.cuda.max_memory_allocated()
    steps_done = POOL_BUDGET_ROUNDS * POOL_BUDGET_STEPS
    rate = n_sess * steps_done / wall
    counts = launches["default budget"]
    n_disp = n_slabs * POOL_BUDGET_ROUNDS
    if (counts["dispatches"] != n_disp or counts["pool_step"] != n_disp
            * plane_launches(POOL_BUDGET_STEPS)
            or counts["bitsliced"] != counts["pool_step"]):
        raise AssertionError(f"phase 26 default budget: launches {counts}")
    # One create more spills exactly one session, the least recently used
    # (the first stepped); its snapshot comes from the host copy.
    pool.create("extra", distinct[0])
    st = pool.stats()
    spilled = [s for s in pool.sessions() if pool.handle(s) is None]
    ref = pool_oracle(distinct, steps_done)
    if (st["spills"] != 1 or spilled != [sids[0]]
            or not np.array_equal(pool.snapshot(sids[0]), ref[0])
            or pool.stats()["revivals"]):
        raise AssertionError(f"phase 26 spill: {st}, spilled {spilled}")
    pool.step(sids[0], 1)  # a pool.miss: revived, one more spills
    st = pool.stats()
    if st["misses"] != 1 or st["revivals"] != 1 or st["spills"] != 2:
        raise AssertionError(f"phase 26 revival: {st}")
    want = {sid: ref[i % POOL_BUDGET_BOARDS] for i, sid in enumerate(sids)}
    want[sids[0]] = pool_oracle([distinct[0]], steps_done + 1)[0]
    want["extra"] = distinct[0]
    same("default budget",
         {sid: pool.snapshot(sid) for sid in pool.sessions()}, want)
    runs["default budget"] = {
        "sessions": n_sess, "slabs": n_slabs, "rounds": POOL_BUDGET_ROUNDS,
        "steps_a_round": POOL_BUDGET_STEPS, "seconds": wall,
        "session_steps_per_sec": rate, "gcups": rate * 500 * 500 / 1e9,
        "launches": counts, "budget_bytes": DEFAULT_DEVICE_BUDGET,
        "slab_bytes": pool.device_bytes(), "max_memory_allocated": peak,
        "allocated_before": base, "transient_bytes": peak - base,
        "stats": st}
    log(f"  default budget ({DEFAULT_DEVICE_BUDGET} B): {n_sess} sessions of "
        f"500^2 in {n_slabs} one-plane slabs from {POOL_BUDGET_BOARDS} "
        f"boards, {POOL_BUDGET_ROUNDS} rounds of {POOL_BUDGET_STEPS} steps in "
        f"{wall:.4f} s: {rate:.6g} session-steps/s, "
        f"{rate * 500 * 500 / 1e9:.6g} Gcups; launches {counts}; "
        f"max_memory_allocated {peak} B, {peak - base} B over the "
        f"{base} B allocated before the rounds (the {pool.device_bytes()} B "
        f"of slabs and what earlier phases hold); one create more spilled "
        f"{sids[0]} (its snapshot from the host copy), its next step a "
        f"pool.miss; every session row 4's board [{card}]")
    del pool

    # (d) Compaction: evict 31 of 32, compact, the survivor bit-equal.
    crng = np.random.default_rng(POOL_AB_SEED)
    small = {f"c{i:02d}": (crng.random((48, 48)) < POOL_AB_DENSITY).astype(
        np.uint8) for i in range(40)}

    def compaction():
        pool = SessionPool(device=POOL_DEV)
        for sid, b in small.items():
            pool.create(sid, b)
        pool.step_group(list(small), 10)
        first = [s for s in small if pool.handle(s).slab == 0]
        for sid in first[1:]:
            pool.evict(sid)
        before = pool.snapshot(first[0])
        res = pool.compact()
        after = pool.snapshot(first[0])
        pool.step(first[0], 10)
        return res, before, after, pool.snapshot(first[0]), first[0]

    res, before, after, last, survivor = counted_run("compaction", compaction)
    if (res["migrated"] < 1 or res["slabs"] != 1
            or not np.array_equal(before, after) or not np.array_equal(
                last, pool_numpy_oracle(small[survivor], 20))):
        raise AssertionError(f"phase 26 compaction: {res}")
    runs["compaction"] = {**res, "launches": launches["compaction"]}
    log(f"  compaction: 31 of 32 evicted, {res}, the survivor bit-equal, "
        "then the oracle's at 20 steps")

    # (e) The settled skip: a slab of still lifes skips its second dispatch
    # with no launch at all; a blinker and a mixed slab never skip.
    def still(k):
        b = np.zeros((48, 48), np.uint8)
        y, x = 2 + (k // 8) * 11, 2 + (k % 8) * 5
        b[y:y + 2, x:x + 2] = 1
        return b

    blinker = np.zeros((48, 48), np.uint8)
    blinker[24, 23:26] = 1
    pool = SessionPool(device=POOL_DEV)
    stills = [f"q{k:02d}" for k in range(32)]
    for k, sid in enumerate(stills):
        pool.create(sid, still(k))
    first = counted_run("settled first", lambda: pool.step_group(stills, 4))
    second = counted_run("settled skip", lambda: pool.step_group(stills, 4))
    skip_counts = launches["settled skip"]
    if (first != 1 or second != 0 or pool.counts["settled_skips"] != 1
            or skip_counts["bitsliced"] or skip_counts["pool_step"]
            or skip_counts["dispatches"]
            or not all(np.array_equal(pool.snapshot(s), still(k))
                       for k, s in enumerate(stills))):
        raise AssertionError(f"phase 26 settled skip: {first} {second} "
                             f"{pool.counts} {skip_counts}")
    for label, boards in (("blinker", {"osc": blinker}),
                          ("mixed", {"still": still(0), "osc": blinker})):
        p = SessionPool(device=POOL_DEV)
        for sid, b in boards.items():
            p.create(sid, b)
        n = counted_run(f"settled {label}", lambda: [
            p.step_group(list(boards), 2) for _ in range(3)])
        if n != [1, 1, 1] or p.counts["settled_skips"] or not all(
                np.array_equal(p.snapshot(sid), pool_numpy_oracle(b, 6))
                for sid, b in boards.items()):
            raise AssertionError(f"phase 26 settled {label}: {n}, "
                                 f"{p.counts}")
    runs["settled"] = {"skip_launches": skip_counts,
                       "settled_skips": pool.counts["settled_skips"]}
    log(f"  settled skip: 32 still lifes dispatched once, then skipped "
        f"(launches {skip_counts}); a blinker and a mixed slab dispatched "
        "every time, boards the oracle's")
    del pool

    # (f) The daemon: submit_session tickets through pump, then the bench's
    # resident A/B, each side gated on its boards before any number.
    def tickets():
        d = ServingDaemon(ServePolicy(max_batch=8, max_wait_s=0.0),
                          device=POOL_DEV)
        for sid, b in small.items():
            d.create_session(sid, b)
        ts = [d.submit_session(sid, 4) for sid in small]
        d.pump(drain=True)
        return d, ts

    d, ts = counted_run("daemon tickets", tickets)
    s = d.summary()
    if ({t.state for t in ts} != {DONE}
            or s["engines"] != {"pool:bitsliced": len(ts)}
            or s["pool_sessions"] != len(small)):
        raise AssertionError(f"phase 26 daemon tickets: {s}")
    same("daemon tickets", {sid: d.snapshot_session(sid) for sid in small},
         {sid: pool_numpy_oracle(b, 4) for sid, b in small.items()})
    log(f"  daemon: {len(ts)} submit_session tickets through pump, "
        f"{s['engines']}, {s['batches']} batches, every board the oracle's")

    ab = {}
    for edge, n in POOL_AB:
        arng = np.random.default_rng(POOL_AB_SEED)
        boards0 = {f"sess{i:04d}": (arng.random((edge, edge))
                                    < POOL_AB_DENSITY).astype(np.uint8)
                   for i in range(n)}
        policy = ServePolicy(max_batch=8, max_depth=max(64, 4 * n),
                             max_wait_s=0.0)
        total = POOL_AB_ROUNDS * POOL_AB_STEPS
        ref = dict(zip(boards0, pool_oracle(list(boards0.values()), total)))
        for sid in list(boards0)[:4]:
            if not np.array_equal(ref[sid], pool_numpy_oracle(
                    boards0[sid], total)):
                raise AssertionError(f"phase 26 A/B {edge}^2: row 4 and the "
                                     "NumPy oracle differ")
        daemon = ServingDaemon(policy, device=POOL_DEV)
        for sid, b in boards0.items():
            daemon.create_session(sid, b)

        def resident():
            done = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(POOL_AB_ROUNDS):
                for sid in boards0:
                    done.append(daemon.submit_session(sid, POOL_AB_STEPS))
                daemon.pump(drain=True)
            torch.cuda.synchronize()
            return time.perf_counter() - t, done

        label = f"A/B {edge}^2 x {n}"
        res_wall, done = counted_run(label, resident)
        res_done = sum(1 for t in done if t.state == DONE)
        same(f"{label} resident",
             {sid: daemon.snapshot_session(sid) for sid in boards0}, ref)
        rs = daemon.summary()
        ship = ServingDaemon(policy, device=POOL_DEV)
        cur = dict(boards0)
        ship_done = 0
        t = time.perf_counter()
        for _ in range(POOL_AB_ROUNDS):
            tks = {sid: ship.submit(cur[sid], POOL_AB_STEPS) for sid in cur}
            ship.pump(drain=True)
            for sid, tk in tks.items():
                if tk.state == DONE:
                    ship_done += 1
                    cur[sid] = np.asarray(tk.result)
        ship_wall = time.perf_counter() - t
        same(f"{label} ship", cur, ref)
        if res_done != ship_done or res_done != n * POOL_AB_ROUNDS:
            raise AssertionError(f"phase 26 {label}: resident {res_done}, "
                                 f"ship {ship_done} of {n * POOL_AB_ROUNDS}")
        ss = ship.summary()
        res_rate, ship_rate = res_done / res_wall, ship_done / ship_wall
        ab[label] = {
            "session_requests_per_sec": res_rate,
            "ship_requests_per_sec": ship_rate,
            "session_vs_ship": res_rate / ship_rate,
            "session_p50_latency_s": rs["p50_latency_s"],
            "session_p99_latency_s": rs["p99_latency_s"],
            "ship_p50_latency_s": ss["p50_latency_s"],
            "ship_p99_latency_s": ss["p99_latency_s"],
            "session_dispatches": rs["batches"], "ship_batches": ss["batches"],
            "ship_engines": ss["engines"], "resident_s": res_wall,
            "ship_s": ship_wall, "launches": launches[label]}
        log(f"  A/B {edge}^2 x {n} sessions, {POOL_AB_ROUNDS} rounds of "
            f"{POOL_AB_STEPS} steps: resident {res_rate:.2f} requests/s "
            f"({res_wall:.4f} s, p50 {rs['p50_latency_s']} s, p99 "
            f"{rs['p99_latency_s']} s, {rs['batches']} dispatches), ship "
            f"{ship_rate:.2f} requests/s ({ship_wall:.4f} s, p50 "
            f"{ss['p50_latency_s']} s, p99 {ss['p99_latency_s']} s, "
            f"{ss['engines']}), session_vs_ship {res_rate / ship_rate:.4f}; "
            f"both sides' boards row 4's [{card}]")
        del daemon, ship
    runs["A/B"] = ab

    # (g) Crashes on the card: a child in pool mode killed at post-step, one
    # in settled mode; each journal resumed to the acked ledger.
    shutil.rmtree(POOL_ROOT, ignore_errors=True)
    os.makedirs(POOL_ROOT)
    crash = {}
    # The two children side by side: each its own journal and ack file.
    children = {}
    for mode, spec in (("pool", "crash=post-step:5"),
                       ("settled", "crash=post-step:15")):
        walp = os.path.join(POOL_ROOT, f"{mode}.wal")
        ackp = os.path.join(POOL_ROOT, f"{mode}.acked")
        children[mode] = (spec, walp, ackp, time.perf_counter(),
                          spawn(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_wal_crash_driver.py"),
             walp, "every-record", ackp, "4", mode, POOL_DEV.type],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                               **{chaos.ENV: spec}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for mode, (spec, walp, ackp, t1, proc) in children.items():
        _, err = proc.communicate(timeout=300)
        if proc.returncode != chaos.CRASH_EXIT:
            raise AssertionError(f"phase 26 {mode} crash child: rc "
                                 f"{proc.returncode}, {err[-2000:]}")
        acked: dict[str, int] = {}
        for op in (ln.split() for ln in open(ackp).read().splitlines()):
            if op and op[0] == "S":
                acked[op[1]] = acked.get(op[1], 0) + int(op[2])
        rep = wal.replay(walp)
        d, source, _ = ServingDaemon.resume_any(
            wal_path=walp, policy=ServePolicy(max_batch=4, max_wait_s=0.0),
            device=POOL_DEV)
        if source != "wal" or sorted(d.sessions()) != sorted(
                rep.pool_sessions):
            raise AssertionError(f"phase 26 {mode} resume: {source}")
        for sid, entry in rep.pool_sessions.items():
            if entry["steps"] not in (acked.get(sid, 0),
                                      acked.get(sid, 0) + 2):
                raise AssertionError(f"phase 26 {mode}: {sid} journaled "
                                     f"{entry['steps']} steps, acked "
                                     f"{acked.get(sid, 0)}")
            if not np.array_equal(d.snapshot_session(sid), pool_numpy_oracle(
                    np.asarray(entry["board"]), int(entry["steps"]))):
                raise AssertionError(f"phase 26 {mode}: {sid} after resume")
        crash[mode] = {"acked_steps": acked,
                       "sessions": len(rep.pool_sessions),
                       "seconds": time.perf_counter() - t1}
        log(f"  {spec} ({mode} mode): child exit 137, acked steps {acked}; "
            f"resume_any re-materialized {len(rep.pool_sessions)} sessions, "
            f"each the oracle's board at its journaled total "
            f"({time.perf_counter() - t1:.2f} s)")
    runs["crash"] = crash
    shutil.rmtree(POOL_ROOT, ignore_errors=True)

    # (h) Times. Each lane op whole, as the pool runs it (serve.pool's
    # _lane_write of a pageable numpy board and _lane_read through a lane
    # ring) at a 500^2 and a 48^2 plane: one traced call held to one kernel
    # record and no copy; its device time (the union of its records) and
    # host-clock time, the kernel's own record, the plain op (the board to
    # the card and the plain version, or back; CUDA events) and the bound
    # restated for the link (link_rates, measured here). Then a dispatch's
    # device time (the union of its records, the memset's too) against
    # bitsliced_steps(slab, s)'s at POOL_TIME_STEPS, in turns: the tail
    # mode's marginal time, beside the bound of what it adds (the first
    # input read once more, 3 operations a word) and the plain dispatch at
    # the fewer steps.
    rates = link_rates()
    pcie = pcie_line()
    log(f"  link: a {LINK_COPY_BYTES} B page-locked copy "
        f"{rates['h2d'] / 1e9:.3f} GB/s to the card, {rates['d2h'] / 1e9:.3f} "
        f"GB/s back (CUDA events); nvidia-smi pcie.link.gen.max, "
        f"pcie.link.width.max: {pcie} [{card}]")
    g = torch.Generator(device=POOL_DEV).manual_seed(260)
    times = {"link": {"h2d_bytes_per_s": rates["h2d"],
                      "d2h_bytes_per_s": rates["d2h"], "pcie": pcie}}
    for edge in (500, 48):
        words = edge * edge
        slab = pool_words(g, (1, edge, edge))
        mask = pool_mask(g, "random", 1)
        board = np.random.default_rng(edge).random((edge, edge)) < 0.4
        board = board.astype(np.uint8)
        ring = spool._LaneRing((edge, edge), POOL_DEV)
        pinned = pinned_board(g, (edge, edge))
        rows = {}
        for name, fn, kernel, plain in (
                ("pool_lane_write",
                 lambda: spool._lane_write(slab, board, 31, ring),
                 lambda: npl.pool_lane_write(slab, pinned, 0, 31),
                 lambda: npl._lane_write_plain(
                     slab, torch.from_numpy(board).to(POOL_DEV), 0, 31)),
                ("pool_lane_read",
                 lambda: spool._lane_read(slab, 31, ring),
                 lambda: npl.pool_lane_read(slab, 0, 31, pinned),
                 lambda: npl._lane_read_plain(slab, 0, 31).cpu().numpy())):
            for _ in range(3):
                fn()
                plain()
            trace = lane_records(fn, f"{name}_kernel")
            bound, term = lane_bound_ms(name, words, rates)
            ms = device_span_ms(fn, 50, "", 1)[0]
            rows[name] = {
                "ms": ms, "host_ms": host_clock_ms(fn, POOL_LANE_HOST_CALLS),
                "kernel_ms": device_ms(kernel, 50,
                                       kernel_name=f"{name}_kernel"),
                "plain_ms": cuda_ms(plain, 20), "bound_ms": bound,
                "bound_by": "bytes", "bound_term": term,
                "share": bound / ms, "trace": trace,
                "shape": f"1 x {edge} x {edge} int32 slab, a {edge}^2 board"}
        del ring
        geo = tb.plan_bitsliced((1, edge, edge))
        bound, by = bound_ms(POOL_TAIL_OPS_PER_WORD * words, 4 * words)
        for steps in POOL_TIME_STEPS:
            n, reps = geo.launches(steps), 20 if steps < 100 else 3
            fns = {"pool_step": lambda: npl.pool_step(slab, steps, mask),
                   "bitsliced_steps": lambda: tb.bitsliced_steps(slab, steps)}
            span = {"pool_step": [], "bitsliced_steps": []}
            for which in ("pool_step", "bitsliced_steps"):
                fns[which]()
            for which in ("pool_step", "bitsliced_steps", "bitsliced_steps",
                          "pool_step"):
                span[which].append(device_span_ms(
                    fns[which], reps, "", n + (which == "pool_step"))[0])
            pool_ms = sum(span["pool_step"]) / 2
            rows[f"pool_step {steps}"] = {
                "ms": pool_ms - sum(span["bitsliced_steps"]) / 2,
                "dispatch_ms": span["pool_step"],
                "bitsliced_steps_ms": span["bitsliced_steps"],
                "events_ms": cuda_ms(fns["pool_step"], reps),
                "plain_ms": (cuda_ms(lambda: npl._pool_step_plain(
                    slab, steps, mask), 3) if steps < 100 else None),
                "bound_ms": bound, "bound_by": by, "launches": n,
                "shape": f"1 x {edge} x {edge} int32 slab, {steps} steps"}
        times[edge] = rows
        log(f"  {edge}^2 plane, the whole lane op as the pool runs it: "
            + "; ".join(
                f"{k} {v['ms']:.6f} ms device (one kernel record, no copy), "
                f"{v['host_ms']:.6f} ms host clock, the kernel's record "
                f"{v['kernel_ms']:.6f}, plain {v['plain_ms']:.6f}, bound "
                f"{v['bound_ms']:.6f} ({v['bound_term']}), {v['share']:.3f} "
                f"of it" for k, v in rows.items()
                if not k.startswith("pool_step")) + f" [{card}]")
        for steps in POOL_TIME_STEPS:
            r = rows[f"pool_step {steps}"]
            log(f"  {edge}^2 plane, a {steps}-step dispatch: "
                f"{r['dispatch_ms']} ms device (the union of its "
                f"{r['launches']} launches and memset; {r['events_ms']:.5f} by "
                f"events) against bitsliced_steps(slab, {steps}) "
                f"{r['bitsliced_steps_ms']}, in turns: the tail mode "
                f"{r['ms']:.6f} ms, bound {r['bound_ms']:.6f} "
                f"({r['bound_by']}), plain dispatch {r['plain_ms']} [{card}]")
    runs["times"] = times
    totals = {k: sum(c[k] for c in launches.values())
              for k in (*POOL_KERNELS, "dispatches")}
    log(f"phase 26 session pool: ok ({time.perf_counter() - t0:.2f} s; "
        f"launches {totals})")
    return {"runs": runs, "launches": launches, "totals": totals,
            "checks": checks, "times": times}


# Phase 27: the serving fleet on the card, at the flagship's size. The JAX
# bench's fleet and loadgen lines (bench.py:408-520, 520-700) with their
# policies (max_batch 8, max_wait 0.005 s; the loadgen's max_depth 256),
# mix (batch 0.7, resident 0.25, snapshot 0.05), duration (2 s,
# bench.py:2036) and SLO (p99 0.5 s, goodput 0.5), at p46gun_big's 500^2
# and phase 6's 95x130 (spec.init(default_rng(46)), p46gun_big every 16th
# ticket) and steps (100, 1000) where the bench has 48^2 and 64^2 at (4, 8)
# and (2, 4); the worker-process CLI as JAX serve/fleet.py:467-510 runs it.
FLEET_ROOT = os.path.join(ROOT, "build", "chip_smoke_fleet")
FLEET_WORKERS = 3
FLEET_SHAPES = ((500, 500), (95, 130))
FLEET_STEPS = (100, 1000)
FLEET_BURST, FLEET_KEYS, FLEET_GUN_EVERY = 192, 24, 16
FLEET_SESSIONS, FLEET_DRAIN_TICKETS = 96, 16
FLEET_LOADGEN_S, FLEET_RATE_MULTS = 2.0, (0.5, 1.0, 2.0)
FLEET_SLO = dict(p99_s=0.5, goodput_frac=0.5)
FLEET_CLI = ["--workers", "3", "--requests", "96", "--sessions", "12",
             "--shapes", "500x500,95x130", "--steps", "100,1000",
             "--max-batch", "8", "--verify"]
# Phase 27's kernels, as main names their wrappers: a worker's buckets
# (rows 4 and 5) and its resident sessions (rows 5 and 12).
FLEET_KERNELS = ("vmem_batch", "bitsliced", "pool_step",
                 "pool_lane_write", "pool_lane_read")


def phase_fleet(card: str, wrappers: dict) -> dict:
    """Phase 27 (module docstring): the serving fleet on the card. Returns
    each drill's record and the kernels' launches in the in-process
    drills (the worker processes count their own)."""
    import shutil

    from mpi_and_open_mp_tpu_torch import load_config, stencils
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import life_ops
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.robust import chaos
    from mpi_and_open_mp_tpu_torch.serve import (
        SLO, ConsistentHashRing, ElasticityPolicy, Fleet, ScenarioMix,
        ServePolicy, run_open_loop, saturation_knee, wal)
    from mpi_and_open_mp_tpu_torch.serve import fleet as fleet_cli
    from mpi_and_open_mp_tpu_torch.serve.queue import DONE

    t0 = time.perf_counter()
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    os.makedirs(FLEET_ROOT)
    counted = {k: wrappers[k] for k in FLEET_KERNELS}
    launches: dict[str, dict] = {}
    runs: dict[str, dict] = {}
    drill_s: dict[str, float] = {}

    def counted_run(label, fn):
        out, counts = run_counted(counted, fn)
        launches[label] = counts
        return out

    def on_card(boards, fn, steps):
        stack = torch.from_numpy(np.stack(boards)).cuda()
        return fn(stack, steps).cpu().numpy()

    def plain(boards, steps):
        """The plain packed loop on the card (no kernel)."""
        return on_card(boards, tb.life_run_bits_plain_batch, steps)

    def row4(boards, steps):
        """Row 4's board: one bitlife_vmem_batch launch."""
        return on_card(boards, lambda x, n: nl.run_path_batch(
            "vmem-grid", x, n), steps)

    def held(label, tickets, ref) -> int:
        """Every resolved one-shot board equal to ``ref``'s, a (shape,
        steps) bucket a call; no ticket resolved on the plain loop or the
        oracle."""
        groups: dict[tuple, list] = {}
        for t in tickets:
            if t.state == DONE and t.board is not None:
                groups.setdefault((t.board.shape, t.steps), []).append(t)
                if t.engine.startswith(("batch:plain", "oracle")):
                    raise AssertionError(f"phase 27 {label}: {t.engine}")
        for (_, steps), ts in groups.items():
            want = ref([t.board for t in ts], steps)
            got = np.stack([t.result for t in ts])
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"phase 27 {label}: {int((got != want).sum())} cells of "
                    f"{len(ts)} boards at {steps} steps differ")
        return sum(len(ts) for ts in groups.values())

    def sessions_held(label, fleet, boards) -> int:
        """Every session's snapshot equal to row 4's board at its journaled
        step total (the create board from ``boards``)."""
        by_steps: dict[tuple, list] = {}
        for sid in boards:
            home = fleet.router._home_worker(sid)
            by_steps.setdefault((int(home.daemon._session_log[sid]["steps"]),
                                 boards[sid].shape), []).append(sid)
        for (steps, _), sids in by_steps.items():
            want = row4([boards[s] for s in sids], steps)
            for sid, w in zip(sids, want):
                if not np.array_equal(fleet.snapshot_session(sid), w):
                    raise AssertionError(f"phase 27 {label}: session {sid} "
                                         f"at {steps} steps differs")
        return len(boards)

    def books(label, fleet) -> dict:
        s = fleet.summary()
        if not s["balanced"] or s["pending"] or s["in_transit"]:
            raise AssertionError(f"phase 27 {label}: books {s}")
        return s

    life = stencils.get("life")
    rng = np.random.default_rng(46)
    gun0 = load_config(GUN_BIG).board()
    gun100 = gun0
    for _ in range(FLEET_STEPS[0]):
        gun100 = life_ops.life_step_numpy(gun100)

    # (4, started) The worker-process CLI, clean and under
    # kill_worker=1:2, each parent spawning its own 3 workers on the card:
    # the kill run (the longer chain: parent, workers, recovery workers)
    # from the phase's start, the clean run after the burst, both going on
    # while the in-process drills run (whose host-bound numbers carry that
    # contention).
    procs = {}
    cli_dirs = {}

    def cli_start(label, spec):
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop(chaos.ENV, None)
        env.pop("MOMP_TRACE", None)
        if spec:
            env[chaos.ENV] = spec
        d = cli_dirs[label] = os.path.join(FLEET_ROOT,
                                           "cli_" + label.split("=")[0])
        # The parents' output to files: nothing reads a pipe meanwhile.
        with open(d + ".out", "wb") as out, open(d + ".err", "wb") as err:
            procs[label] = (time.perf_counter(), spawn(
                [sys.executable, "-m",
                 "mpi_and_open_mp_tpu_torch.serve.fleet", *FLEET_CLI,
                 "--dir", d], cwd=ROOT, env=env, stdout=out, stderr=err))

    def cli_stop():
        """A failed drill stops the CLI runs too: each parent leads its own
        session, so its workers go with it."""
        for _, proc in procs.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    t_cli = time.perf_counter()
    cli_start("kill_worker=1:2", "kill_worker=1:2")
    # (1) A 192-ticket burst over 24 session keys into 3 workers with
    # journals; the deepest worker wedged mid-burst.
    burst = []
    for i in range(FLEET_BURST):
        shape, steps = FLEET_SHAPES[i % 2], FLEET_STEPS[(i // 2) % 2]
        gun = i % FLEET_GUN_EVERY == 0  # 500^2 at 100 steps
        burst.append((gun0 if gun else life.init(rng, shape), steps,
                      f"s{i % FLEET_KEYS:04d}", gun))
    policy = ServePolicy(max_batch=8, max_depth=max(64, 2 * FLEET_BURST),
                         max_wait_s=0.005)

    def burst_drill():
        fleet = Fleet(FLEET_WORKERS, policy,
                      wal_dir=os.path.join(FLEET_ROOT, "burst"),
                      heartbeat_interval_s=0.01)
        t_start = time.monotonic()
        tickets = [fleet.submit(b, n, session=k)
                   for b, n, k, _ in burst[:FLEET_BURST // 2]]
        fleet.pump()
        tickets += [fleet.submit(b, n, session=k)
                    for b, n, k, _ in burst[FLEET_BURST // 2:]]
        victim = max(fleet.handles,
                     key=lambda h: h.daemon.queue.depth()).index
        depth = fleet.handles[victim].daemon.queue.depth()
        t_kill = time.monotonic()
        fleet.wedge(victim)
        fleet.serve_until_drained()
        return fleet, tickets, victim, depth, t_start, t_kill, time.monotonic()

    t1 = time.perf_counter()
    try:
        fleet, tickets, victim, depth, t_start, t_kill, t_end = counted_run(
            "burst", burst_drill)
    except BaseException:
        cli_stop()
        raise
    s = books("burst", fleet)
    rehomed = fleet.router.last_rehomed
    recovered = [t.resolved_at for t in rehomed if t.resolved_at is not None]
    # Re-homed tickets resolve as new tickets at their survivors: the
    # fleet's resolved set, not the submitted one, carries every board.
    done = fleet.resolved_tickets()
    guns = [t for t in done if t.board.shape == gun0.shape
            and np.array_equal(t.board, gun0)]
    n_guns = sum(1 for *_, gun in burst if gun)
    rep = wal.replay(fleet.handles[victim].wal_path)
    if (s["resolved"] != FLEET_BURST or s["shed"] or s["door_shed"]
            or s["wedged"] != [victim] or not depth or not rehomed
            or len(recovered) != len(rehomed) or rep.pending
            or s["rehomed_resolved"] != s["rehomed"] or len(guns) != n_guns
            or not all(np.array_equal(t.result, gun100) for t in guns)):
        raise AssertionError(f"phase 27 burst: {s}, victim {victim} depth "
                             f"{depth}, {len(rehomed)} re-homed, "
                             f"{len(recovered)} resolved")
    checked = held("burst", done, plain)
    rps = s["resolved"] / (t_end - t_start)
    runs["burst"] = {
        "fleet_requests_per_sec": rps, "wall_s": t_end - t_start,
        "fleet_p50_latency_s": s["p50_latency_s"],
        "fleet_p99_latency_s": s["p99_latency_s"], "steals": s["steals"],
        "victim": victim, "victim_depth": depth, "rehomed": s["rehomed"],
        "fleet_kill_recovery_s": max(recovered) - t_kill,
        "books": s, "launches": launches["burst"]}
    drill_s["burst"] = time.perf_counter() - t1
    log(f"  burst: {FLEET_BURST} tickets over {FLEET_KEYS} keys "
        f"({', '.join(f'{a}x{b}' for a, b in FLEET_SHAPES)} at steps "
        f"{FLEET_STEPS}), worker {victim} wedged with {depth} pending: "
        f"fleet_requests_per_sec {rps:.2f}, p50 {s['p50_latency_s']} s, "
        f"p99 {s['p99_latency_s']} s, steals {s['steals']}, re-homed "
        f"{s['rehomed']} (all resolved), fleet_kill_recovery_s "
        f"{max(recovered) - t_kill:.4f}; books balanced; {checked} boards "
        f"the plain loop's on the card, {len(guns)} p46gun_big the "
        f"oracle's at {FLEET_STEPS[0]} steps; victim's journal replays to "
        f"0 pending; launches {launches['burst']} "
        f"({drill_s['burst']:.2f} s) [{card}]")

    cli_start("clean", None)
    try:
        # (2) 96 resident sessions of 500^2 on the same fleet (the wedged
        # worker out), stepped in rounds; the wedged worker rejoins and claims
        # whole slab groups; another worker drains.
        t1 = time.perf_counter()
        full = ConsistentHashRing(range(FLEET_WORKERS))
        names = [f"r{i:04d}" for i in range(4 * FLEET_SESSIONS)]
        lead = [n for n in names if full.lookup(n) == victim][:1]
        order = lead + [n for n in names if n not in lead][:FLEET_SESSIONS - 1]
        sboards = {sid: gun0 if k == 1 else life.init(rng, (500, 500))
                   for k, sid in enumerate(order)}

        def rounds(fleet, sids, steps):
            ts = [fleet.step_session(sid, steps) for sid in sids]
            fleet.serve_until_drained()
            if {t.state for t in ts} != {DONE}:
                raise AssertionError("phase 27 sessions: a step did not resolve")

        def sessions_drill():
            for sid, b in sboards.items():
                fleet.create_session(sid, b)
            for steps in FLEET_STEPS:
                rounds(fleet, sboards, steps)
            before = {h.index: h.daemon.pool.slab_groups()
                      for h in fleet.router.live_workers()}
            want = sorted(sid for groups in before.values()
                          for sids in groups.values()
                          if full.lookup(str(sids[0])) == victim for sid in sids)
            t2 = time.perf_counter()
            claimed = fleet.rejoin_worker(victim)
            claim_s = time.perf_counter() - t2
            return want, claimed, claim_s

        want, claimed, claim_s = counted_run("sessions", sessions_drill)
        moved = sorted(sid for sid in sboards
                       if fleet.router._home_worker(sid).index == victim)
        if not want or claimed != len(want) or moved != want:
            raise AssertionError(f"phase 27 rejoin: claimed {claimed}, whole "
                                 f"groups {len(want)}, on the rejoiner "
                                 f"{len(moved)}")
        sessions_held("rejoin", fleet, sboards)
        # The drain: the live worker with the most sessions, a whole pending
        # bucket routed to it, every session's next step journaled first.
        live = [h for h in fleet.router.live_workers() if h.index != victim]
        dst = max(live, key=lambda h: len(h.daemon.sessions()))
        held_sessions = len(dst.daemon.sessions())
        keys, j = [], 0
        while len(keys) < FLEET_DRAIN_TICKETS:
            if fleet.router.target_for(f"d{j:04d}") == dst.index:
                keys.append(f"d{j:04d}")
            j += 1
        dboards = [life.init(rng, (500, 500)) for _ in keys]

        def drain_drill():
            ts = [fleet.submit(b, FLEET_STEPS[0], session=k)
                  for b, k in zip(dboards, keys)]
            steps = [fleet.step_session(sid, FLEET_STEPS[0]) for sid in sboards]
            t2 = time.perf_counter()
            stats = fleet.drain_worker(dst.index)
            drain_s = time.perf_counter() - t2
            fleet.serve_until_drained()
            return ts, steps, stats, drain_s

        ts, steps, stats, drain_s = counted_run("drain", drain_drill)
        rep = wal.replay(dst.wal_path)
        dkeys = {b.tobytes() for b in dboards}
        owners = {h.index for h in fleet.router.live_workers()
                  for t in h.daemon.queue.tickets()
                  if t.resumed and t.board is not None
                  and t.board.tobytes() in dkeys}
        s = books("sessions", fleet)
        if (stats["tickets_moved"] != FLEET_DRAIN_TICKETS
                or stats["sessions_moved"] != held_sessions or len(owners) != 1
                or rep.pending or rep.pool_sessions
                or {t.state for t in steps} != {DONE} or s["rejoins"] != 1
                or s["drains"] != 1 or s["drained"] != [dst.index]):
            raise AssertionError(f"phase 27 drain: {stats}, owners {owners}, "
                                 f"journal {rep.counts()}, books {s}")
        held("drain", fleet.resolved_tickets(), plain)
        sessions_held("drain", fleet, sboards)
        runs["membership"] = {
            "claim_s": claim_s, "claimed_sessions": claimed,
            "drain_s": drain_s, "drained_worker": dst.index,
            "drain_sessions_moved": stats["sessions_moved"],
            "drain_tickets_moved": stats["tickets_moved"], "books": s,
            "launches": {k: launches[k] for k in ("sessions", "drain")}}
        drill_s["membership"] = time.perf_counter() - t1
        log(f"  membership: {FLEET_SESSIONS} sessions of 500^2 (p46gun_big "
            f"among them) created and stepped {FLEET_STEPS}; worker {victim} "
            f"rejoined, claimed {claimed} sessions in whole slab groups in "
            f"{claim_s:.4f} s; worker {dst.index} drained in {drain_s:.4f} s "
            f"({stats['tickets_moved']} tickets in one bucket to one worker, "
            f"{stats['sessions_moved']} sessions, its journal replays to "
            f"nothing); every snapshot row 4's board at its journaled total, "
            f"every one-shot board the plain loop's; books balanced; launches "
            f"{launches['sessions']}, {launches['drain']} "
            f"({drill_s['membership']:.2f} s) [{card}]")
        del fleet
        torch.cuda.empty_cache()

        # (3) The load generator: 3 fresh fleets at 1/2, 1 and 2x the burst's
        # requests a second, then one membership cycle at the knee.
        t1 = time.perf_counter()
        mix = ScenarioMix(batch=0.7, resident=0.25, snapshot=0.05,
                          shapes=FLEET_SHAPES, steps=FLEET_STEPS,
                          sessions=max(8, 2 * FLEET_WORKERS))
        slo = SLO(**FLEET_SLO)
        lpolicy = ServePolicy(max_batch=8, max_depth=256, max_wait_s=0.005)
        rates = [m * rps for m in FLEET_RATE_MULTS]

        def gated(label, fleet, rep):
            n = held(label, fleet.resolved_tickets(), row4)
            sessions_held(label, fleet, rep.resident_boards)
            if not rep.books["balanced"]:
                raise AssertionError(f"phase 27 {label}: {rep.books}")
            return n

        reports = []
        for rate in rates:
            lfleet = Fleet(FLEET_WORKERS, lpolicy, heartbeat_interval_s=0.01,
                           telemetry_interval_s=0.02)
            rep = counted_run(f"loadgen {rate:.1f}/s", lambda: run_open_loop(
                lfleet, rate, FLEET_LOADGEN_S, mix=mix, slo=slo, seed=17))
            gated(f"loadgen {rate:.1f}/s", lfleet, rep)
            reports.append(rep)
            del lfleet
        knee = saturation_knee(reports)
        at_knee = next((r for r in reversed(reports) if r.slo_ok), reports[0])
        cycle_rate = knee["knee_rps"] or rates[0]
        cfleet = Fleet(FLEET_WORKERS, lpolicy, heartbeat_interval_s=0.01,
                       telemetry=True, telemetry_interval_s=0.02,
                       elasticity=ElasticityPolicy(
                           slo_p99_s=slo.p99_s, slo_goodput_frac=slo.goodput_frac,
                           min_workers=1, max_workers=FLEET_WORKERS + 2,
                           surplus_p99_frac=0.0))
        cycle: dict = {}

        def ev_wedge(fl):
            h = max((w for w in fl.handles if not (w.wedged or w.drained)),
                    key=lambda w: w.daemon.queue.depth())
            cycle["victim"] = h.index
            fl.wedge(h.index)

        def ev_rejoin(fl):
            deadline = time.monotonic() + 10.0
            while cycle["victim"] not in fl.router.wedged_workers:
                fl.pump()
                time.sleep(fl.router.heartbeat_interval_s)
                if time.monotonic() > deadline:
                    raise AssertionError("phase 27 cycle: the victim was never "
                                         "declared")
            t2 = time.perf_counter()
            cycle["claimed"] = fl.rejoin_worker(cycle["victim"])
            cycle["rejoin_s"] = time.perf_counter() - t2

        def ev_drain(fl):
            h = max((w for w in fl.handles if not (w.wedged or w.drained
                                                    or w.halted)
                     and w.index != cycle["victim"]),
                    key=lambda w: w.daemon.queue.depth())
            cycle["drained"] = h.index
            t2 = time.perf_counter()
            fl.drain_worker(h.index)
            cycle["drain_s"] = time.perf_counter() - t2

        crep = counted_run("membership cycle", lambda: run_open_loop(
            cfleet, cycle_rate, FLEET_LOADGEN_S, mix=mix, slo=slo, seed=23,
            events=[(0.25, ev_wedge), (0.45, ev_rejoin), (0.65, ev_drain)]))
        gated("membership cycle", cfleet, crep)
        cs = cfleet.summary()
        if cs["rejoins"] != 1 or cs["drains"] < 1 or not cs["wedged"]:
            raise AssertionError(f"phase 27 membership cycle: {cs}")
        burn = cfleet.burn.summary()
        runs["loadgen"] = {
            "rates": rates, "knee": knee,
            "at_knee": {"offered_rps": at_knee.offered_rps,
                        "goodput_rps": at_knee.goodput_rps,
                        "p50_s": at_knee.p50_s, "p99_s": at_knee.p99_s,
                        "p999_s": at_knee.p999_s, "shed": at_knee.shed},
            "cycle": {**crep.to_dict(), **cycle, "burn": burn,
                      "decisions": cfleet.decisions,
                      "telemetry": cfleet.router.telemetry.summary(),
                      "books": cs},
            "launches": {k: v for k, v in launches.items()
                         if k.startswith(("loadgen", "membership cycle"))}}
        drill_s["loadgen"] = time.perf_counter() - t1
        log(f"  loadgen (3 fresh fleets, {FLEET_LOADGEN_S} s each, mix batch "
            f"0.7 / resident 0.25 / snapshot 0.05, SLO p99 {slo.p99_s} s, "
            f"goodput {slo.goodput_frac}): offered "
            + ", ".join(f"{r.offered_rps:.1f}/s -> goodput {r.goodput_rps:.1f},"
                        f" p99 {r.p99_s:.4f} s, shed {sum(r.shed.values())}, "
                        f"slo_ok {r.slo_ok}" for r in reports)
            + f"; saturation_knee {knee['knee_rps']} (breach "
            f"{knee['breach_rps']}); at the knee goodput "
            f"{at_knee.goodput_rps:.2f}/s, p50 {at_knee.p50_s:.4f}, p99 "
            f"{at_knee.p99_s:.4f}, p999 {at_knee.p999_s:.4f} s [{card}]")
        log(f"  membership cycle at {cycle_rate:.1f}/s (wedge 0.25, rejoin "
            f"0.45, drain 0.65, telemetry on): goodput {crep.goodput_rps:.2f}/s,"
            f" p99 {crep.p99_s:.4f} s, shed {crep.shed}, worker "
            f"{cycle['victim']} rejoined ({cycle['claimed']} claimed, "
            f"{cycle['rejoin_s']:.4f} s), worker {cycle['drained']} drained "
            f"({cycle['drain_s']:.4f} s); burn-rate peak short "
            f"{burn['burn_peak_short']} long {burn['burn_peak_long']}, alerts "
            f"{burn['burn_alerts']}; decisions {json.dumps(cfleet.decisions)}; "
            f"every resident snapshot and one-shot board row 4's; books "
            f"balanced ({drill_s['loadgen']:.2f} s) [{card}]")
        del cfleet
        torch.cuda.empty_cache()
    except BaseException:
        cli_stop()
        raise

    # (4, collected) The CLI runs' lines, each worker's own line beside.
    t1 = time.perf_counter()
    results = {}
    for label, (t2, proc) in procs.items():
        proc.wait(timeout=600)
        wall = time.perf_counter() - t2
        with open(cli_dirs[label] + ".out") as out, \
                open(cli_dirs[label] + ".err") as err:
            results[label] = (proc.returncode, out.read(), err.read(), wall)
    cli = {}
    for label, (rc, out, err, wall) in results.items():
        try:
            line = json.loads(out.strip().splitlines()[-1])
        except (IndexError, ValueError):
            line = {}
        tel = line.get("telemetry", {})
        ok = (rc == 0 and line.get("books_balance") is True
              and line.get("verified") is True and line.get("device") ==
              "cuda" and line.get("resolved") == 96 and tel.get("snapshots")
              and "loss" in tel)
        if label == "clean":
            ok = ok and line.get("worker_rcs") == [0, 0, 0]
        else:
            ok = (ok and line.get("worker_rcs", [])[1:2] == [137]
                  and line.get("victims") == [1]
                  and line.get("recovery_rcs")
                  and all(r == 0 for r in line["recovery_rcs"])
                  and line.get("rehomed_parity") is True)
        if not ok:
            raise AssertionError(f"phase 27 CLI {label}: rc {rc}, {out[-3000:]}"
                                 f" {err[-3000:]}")
        workers = {}
        for name in sorted(os.listdir(cli_dirs[label])):
            if name.endswith(".out"):
                w = fleet_cli._read_worker_line(
                    os.path.join(cli_dirs[label], name)) or {}
                workers[name[:-4]] = {k: w.get(k) for k in (
                    "wall_sec", "resolved", "batches", "verified")}
        cli[label] = {"rc": rc, "wall_s": wall, **{k: line.get(k) for k in (
            "worker_rcs", "recovery_rcs", "rehomed", "rehomed_resolved",
            "resolved", "wall_sec", "fleet_requests_per_sec",
            "fleet_p99_latency_s", "fleet_kill_recovery_s")},
            "telemetry_loss": tel["loss"], "workers": workers}
        log(f"  fleet CLI {label}: rc 0, {cli[label]['wall_s']:.2f} s "
            f"(the parent's wall_sec {line['wall_sec']}), worker rcs "
            f"{line['worker_rcs']}, recovery rcs {line['recovery_rcs']}, "
            f"re-homed {line['rehomed']}, resolved {line['resolved']}, books "
            f"balanced, verified (every board the plain loop's on the card), "
            f"telemetry {tel['snapshots']} snapshots, loss {tel['loss']}; "
            f"each worker's serve seconds "
            f"{ {k: v['wall_sec'] for k, v in workers.items()} } [{card}]")
    runs["cli"] = cli
    drill_s["cli (beside drills 1-3)"] = time.perf_counter() - t_cli
    drill_s["cli wait after drill 3"] = time.perf_counter() - t1
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    totals = {k: sum(c[k] for c in launches.values()) for k in FLEET_KERNELS}
    runs["drill_seconds"] = drill_s
    log(f"phase 27 serving fleet: ok ({time.perf_counter() - t0:.2f} s; "
        f"drills {json.dumps({k: round(v, 2) for k, v in drill_s.items()})};"
        f" launches {totals})")
    return {"runs": runs, "launches": launches, "totals": totals}


# Phase 28: native IO. The 10000^2 soup each VTK writer writes (its seed
# and density, made on the host), beside p46gun_big's board at step 10 000;
# the child process's directory and time limit; the 500^2 snapshots each
# writer times alone in phase 28 itself.
VTK_SOUP_SHAPE, VTK_SOUP_SEED, VTK_SOUP_DENSITY = (10000, 10000), 28, 0.35
VTK_DIR = os.path.join(ROOT, "build", "vtk_phase28")
VTK_TIMEOUT_S = 600
VTK_REPS = 5


def native_io_child(out_path: str) -> int:
    """``chip_smoke.py --native-io OUT``: phase 28's host work, in a
    process of its own beside the phases from 7 on (it needs the library
    from phase 1 and no card). The C and Python parsers on every
    ``configs/*.cfg``; p46gun_big after 10 000 steps of the compiled
    oracle (``native.life_steps(bits=True)``, saved for the parent to hold
    against the card's board); the C and Python VTK writers on that board
    and on a 10000^2 soup, each timed alone, one after the other, their
    files compared byte for byte. Writes the record to OUT as JSON; raises
    on a difference."""
    import filecmp
    import glob

    sys.path.insert(0, ROOT)
    from mpi_and_open_mp_tpu_torch.utils import config as tcfg
    from mpi_and_open_mp_tpu_torch.utils import native
    from mpi_and_open_mp_tpu_torch.utils import vtk

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"native/liblifeio.so did not load "
                             f"({native._SO_PATH})")
    rec = {"configs": [], "vtk": {}}
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.cfg"))):
        a, b = native.load_config(path), tcfg.load_config_py(path)
        if ((a.steps, a.save_steps, a.nx, a.ny)
                != (b.steps, b.save_steps, b.nx, b.ny)
                or not np.array_equal(a.cells, b.cells)):
            raise AssertionError(f"{path}: the native and Python parsers "
                                 "differ")
        rec["configs"].append(os.path.basename(path))
    os.makedirs(VTK_DIR, exist_ok=True)
    t1 = time.perf_counter()
    gun = native.life_steps(tcfg.load_config_py(GUN_BIG).board(), 10000,
                            bits=True)
    rec["oracle_s"] = time.perf_counter() - t1
    rec["gun_npy"] = os.path.join(VTK_DIR, "gun_10000.npy")
    np.save(rec["gun_npy"], gun)
    rng = np.random.default_rng(VTK_SOUP_SEED)
    boards = {"p46gun_big at step 10000": gun,
              "10000^2 soup": (rng.random(VTK_SOUP_SHAPE, np.float32)
                               < VTK_SOUP_DENSITY).astype(np.uint8)}
    for what, board in boards.items():
        paths = {name: os.path.join(VTK_DIR, f"{name}.vtk")
                 for name in ("native", "python")}
        ms = {}
        for name, writer in (("native", native.write_vtk),
                             ("python", vtk.write_vtk_py)):
            t2 = time.perf_counter()
            writer(paths[name], board)
            ms[name] = (time.perf_counter() - t2) * 1e3
        size = os.path.getsize(paths["native"])
        if not filecmp.cmp(paths["native"], paths["python"], shallow=False):
            raise AssertionError(f"{what}: the VTK writers' files differ")
        for path in paths.values():
            os.remove(path)
        rec["vtk"][what] = {"shape": list(board.shape), "bytes": size,
                            "native_ms": ms["native"],
                            "python_ms": ms["python"]}
    rec["seconds"] = time.perf_counter() - t0
    rec["end_wall"] = time.time()
    with open(out_path, "w") as fd:
        json.dump(rec, fd)
    return 0


def phases_beside(t_from: float, t_to: float) -> list[int]:
    """The phases whose span (from the previous closing line to their
    own) overlaps ``[t_from, t_to]``."""
    out, last = [], None
    for n, t in PHASE_ENDS:
        if last is not None and last < t_to and t > t_from:
            out.append(n)
        last = t
    return out


def vtk_alone_ms(board: np.ndarray) -> dict:
    """Each VTK writer's host milliseconds a snapshot of ``board``, with
    nothing else running: ``VTK_REPS`` writes each, the two in turn, the
    median; their files byte-identical."""
    import filecmp

    from mpi_and_open_mp_tpu_torch.utils import native, vtk

    paths = {name: os.path.join(VTK_DIR, f"alone_{name}.vtk")
             for name in ("native", "python")}
    ms = {"native": [], "python": []}
    for _ in range(VTK_REPS):
        for name, writer in (("native", native.write_vtk),
                             ("python", vtk.write_vtk_py)):
            t0 = time.perf_counter()
            writer(paths[name], board)
            ms[name].append((time.perf_counter() - t0) * 1e3)
    if not filecmp.cmp(paths["native"], paths["python"], shallow=False):
        raise AssertionError("the VTK writers' files differ")
    for path in paths.values():
        os.remove(path)
    return {f"{k}_ms": float(np.median(v)) for k, v in ms.items()}


def start_native_io() -> tuple:
    """Phase 28's child (:func:`native_io_child`), started; its output to
    files under ``VTK_DIR``. Returns (the process, the record's path, its
    start on this process's clock and on the wall clock)."""
    os.makedirs(VTK_DIR, exist_ok=True)
    out = os.path.join(VTK_DIR, "record.json")
    with open(out + ".log", "wb") as log_fd:
        proc = spawn(
            [sys.executable, os.path.abspath(__file__), "--native-io", out],
            cwd=ROOT, stdout=log_fd, stderr=subprocess.STDOUT)
    return proc, out, (time.perf_counter(), time.time())


def phase_native_io(card: str, child: tuple, gun_final: np.ndarray) -> dict:
    """Phase 28 (module docstring): the child's record (it ran beside the
    phases from 7 on), the compiled oracle's p46gun_big held against the
    card's board, then each writer timed alone on that board."""
    t0 = time.perf_counter()
    proc, out, t_child = child
    try:
        rc = proc.wait(timeout=VTK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    if rc != 0:
        raise AssertionError(f"phase 28's child: rc {rc}\n"
                             f"{open(out + '.log').read()[-3000:]}")
    with open(out) as fd:
        rec = json.load(fd)
    beside = phases_beside(t_child[0],
                           t_child[0] + rec["end_wall"] - t_child[1])
    oracle = np.load(rec["gun_npy"])
    if not np.array_equal(oracle, gun_final) or int(oracle.sum()) != 7288:
        raise AssertionError("native.life_steps(bits=True) of p46gun_big "
                             "differs from the card's board")
    log(f"  parsers: {len(rec['configs'])} configs equal "
        f"({', '.join(rec['configs'])})")
    log(f"  native.life_steps(bits=True), p46gun_big 10 000 steps: the "
        f"card's board, population 7288 ({rec['oracle_s']:.3f} s, host)")
    for what, r in rec["vtk"].items():
        log(f"  VTK {what} {tuple(r['shape'])}: byte-identical "
            f"({r['bytes']} B); a snapshot native {r['native_ms']:.1f} ms, "
            f"Python {r['python_ms']:.1f} ms (host clock, each alone in the "
            f"child, one after the other, the child beside phases "
            f"{beside}) [{card}]")
    log(f"  the child took {rec['seconds']:.2f} s, beside phases {beside}")
    alone = vtk_alone_ms(oracle)
    rec["vtk"]["p46gun_big at step 10000"]["alone"] = alone
    log(f"  VTK p46gun_big at step 10000 (500, 500), nothing else running: "
        f"a snapshot native {alone['native_ms']:.3f} ms, Python "
        f"{alone['python_ms']:.3f} ms (host clock, the median of "
        f"{VTK_REPS} each, the two in turn) [{card}]")
    log(f"phase 28 native IO: ok ({time.perf_counter() - t0:.2f} s)")
    return {**rec["vtk"], "child_beside_phases": beside}


def phase_graft_entry(card: str, wrappers: dict) -> dict:
    """Phase 29 (module docstring): ``graft_entry.entry()``'s step against
    the plain step, and ``dryrun_multichip(8)`` on the card, the launch
    counts set to 0 just before each and read just after."""
    from mpi_and_open_mp_tpu_torch import graft_entry
    from mpi_and_open_mp_tpu_torch.ops import life_ops

    t0 = time.perf_counter()
    fn, (board,) = graft_entry.entry()
    got, counts = run_counted(wrappers, lambda: fn(board))
    same = torch.equal(got, life_ops.life_step_roll(board))
    if (not same or counts["vmem"] != 1
            or any(c for k, c in counts.items() if k != "vmem")):
        raise AssertionError(f"graft_entry.entry(): equal to the plain step "
                             f"{same}, launches {counts}")
    log(f"  entry(): one bitlife_vmem launch, the 512^2 step bit for bit "
        f"the plain life_step_roll's")
    t1 = time.perf_counter()
    _, dry = run_counted(wrappers,
                         lambda: graft_entry.dryrun_multichip(8))
    dry_s = time.perf_counter() - t1
    dry = {k: c for k, c in dry.items() if c}
    for name in ("window", "flash_fwd", "flash_hop_dq", "flash_hop_dkv",
                 "quadrature"):
        if not dry.get(name):
            raise AssertionError(f"dryrun_multichip(8) launched no {name}: "
                                 f"{dry}")
    log(f"  dryrun_multichip(8): ok in {dry_s:.2f} s, the hop engines' "
        f"stamps the kernels'; launches {json.dumps(dry)} [{card}]")
    log(f"phase 29 graft entry: ok ({time.perf_counter() - t0:.2f} s)")
    return {"entry_launches": counts["vmem"], "dryrun_launches": dry,
            "dryrun_s": dry_s}


# Phase 30: runs across two processes on the one card (staged gloo). Each
# rank's time limit; the integral CLI's N (the reference's 10^12 through
# its 32-bit atoi) and shards; p46gun_big's save cadence for the Life runs
# (a snapshot every DIST_SAVE steps, which also sets the CLI's warm-up run
# to DIST_SAVE steps; the last, at 9 000, is compared) and their halo
# depth: a staged exchange costs ~1-3 ms (the probe's alpha, PERF.md PR
# 27), so the runs exchange once every DIST_FUSE steps (the CLI's
# --fuse-steps) to fit the script's time; the attention CLI's ring.
DIST_PROCS = 2
DIST_TIMEOUT_S = 240
DIST_INTEGRAL_N, DIST_INTEGRAL_SHARDS = 3567587328, 8
DIST_SAVE, DIST_FUSE = 1000, 20
DIST_LIFE = {"row native": ["--layout", "row", "--impl", "native",
                            "--devices", "2"],
             "cart native": ["--layout", "cart", "--impl", "native",
                             "--mesh", "2,2", "--virtual-devices", "2"]}
DIST_ATTENTION = ["--variant", "ring", "--devices", "2", "--seq", "4096",
                  "--heads", "8", "--head-dim", "128", "--causal", "--grad"]
DIST_ROOT = os.path.join(ROOT, "build", "dist_phase30")
# The RDMA rung across the processes (MOMP_HALO_RDMA=1, RUNG_ENV): the
# same two Life runs at --fuse-steps 1, one halo_frame round a step
# reading the other rank's shards through its window (10 000 rounds, each
# a race that a missing wait would lose; the worker runs under the flag
# too); then, alone after the other pairs, the rung's times at cart 2x2's
# run of p46gun_big (RUNG_TIME_BLOCK, depth 1): RUNG_TIME_REPS handshakes
# and frame rounds on the host clock, and the frame kernel's device time
# by profiler over RUNG_TIME_KERNELS launches, rank 0 alone.
RUNG_ENV = {"MOMP_HALO_RDMA": "1"}
DIST_RUNG = {"row rung": DIST_LIFE["row native"],
             "cart rung": DIST_LIFE["cart native"]}
RUNG_TIME_BLOCK = (1, 2, 250, 250)
RUNG_TIME_REPS, RUNG_TIME_KERNELS = 2000, 50
CHILD_RUNG = "CHILD_RUNG "


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(label: str, argv_of, env: dict | None = None) -> dict:
    """``DIST_PROCS`` processes, ``argv_of(rank)`` each (after the
    interpreter), with ``env`` over this process's environment, their
    output to files under ``DIST_ROOT``; each leads its own session."""
    procs_ = []
    full_env = {**os.environ, **(env or {})}
    for r in range(DIST_PROCS):
        base = os.path.join(DIST_ROOT, f"{label.replace(' ', '_')}.{r}")
        with open(base + ".out", "wb") as out, \
                open(base + ".err", "wb") as err:
            procs_.append((base, spawn(
                [sys.executable, *argv_of(r)], cwd=ROOT, stdout=out,
                stderr=err, env=full_env)))
    return {"label": label, "t0": time.perf_counter(), "procs": procs_}


def finish_ranks(run: dict) -> dict:
    """Wait for a run's ranks (each within ``DIST_TIMEOUT_S`` of its
    start), kill any left, and fail unless every rank exited 0; returns
    each rank's output and the run's seconds."""
    outs, rcs = [], []
    for base, proc in run["procs"]:
        left = DIST_TIMEOUT_S - (time.perf_counter() - run["t0"])
        try:
            proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            pass
    for base, proc in run["procs"]:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        rcs.append(proc.returncode)
        outs.append((open(base + ".out").read(), open(base + ".err").read()))
    seconds = time.perf_counter() - run["t0"]
    if rcs != [0] * DIST_PROCS:
        raise AssertionError(
            f"{run['label']} across {DIST_PROCS} processes: rcs {rcs}\n"
            + "\n".join(f"rank {r}: {o[-1500:]}\n{e[-3000:]}"
                        for r, (o, e) in enumerate(outs)))
    return {"outs": outs, "seconds": seconds}


def transport_line(err: str) -> dict:
    """The transport JSON line the primary stamps on stderr."""
    for line in err.splitlines():
        if line.startswith('{"transport"'):
            return json.loads(line)
    raise AssertionError(f"no transport line: {err[-1500:]}")


def child_procs(err: str) -> dict:
    """The calls between processes a ``--cli-child`` CLI printed."""
    for line in err.splitlines():
        if line.startswith(CHILD_PROCS):
            return json.loads(line[len(CHILD_PROCS):])
    raise AssertionError(f"no process calls in a child's stderr: "
                         f"{err[-2000:]}")


def rung_times_child(argv: list[str]) -> int:
    """``rung-times`` in a ``--cli-child`` chain: one rank of phase 30's
    timing of the RDMA rung (``RUNG_TIME_*``), joined at the chain's
    ``--distributed`` flags. Each rank holds its
    run of p46gun_big on cart 2x2; both time ``RUNG_TIME_REPS``
    handshakes, then as many ``halo_frame`` rounds (copy into the window,
    publish, launch; synced), on the host clock; then rank 0 alone, rank 1
    waiting at a barrier, the frame kernel's device time by profiler on
    the run's table (no publish: the slots hold the last round). Rank 0
    prints the figures as one ``CHILD_RUNG`` JSON line on stderr."""
    import argparse

    from mpi_and_open_mp_tpu_torch.ops import native_halo as nh
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.parallel import procs
    from mpi_and_open_mp_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    a = ap.parse_args(argv)
    w = procs.init(a.coordinator, a.num_processes, a.process_id, "cuda")
    mesh = pm.make_mesh_2d(w.procs, 2, device="cuda")
    board = torch.from_numpy(load_config(GUN_BIG).board()).cuda()
    block = pm.local_part(pm.shard(board, *mesh.axis_sizes), mesh)
    if tuple(block.shape) != RUNG_TIME_BLOCK:
        raise AssertionError(f"rung-times: a run of {tuple(block.shape)}")
    rec = {}

    def host_us(fn):
        procs.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RUNG_TIME_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / RUNG_TIME_REPS * 1e6

    rec["handshake_us"] = host_us(lambda: procs.handshake())
    nh.halo_frame(block, 1, "cart")
    rec["round_us"] = host_us(lambda: nh.halo_frame(block, 1, "cart"))
    launch = next(v for v in nh._FRAME_LAUNCHES.values()
                  if isinstance(v, nh._RunFrameLaunch))
    procs.barrier()
    torch.cuda.synchronize()
    if w.rank == 0:
        out = torch.empty(launch.shape, dtype=launch.dtype, device="cuda")
        src = launch.window.ptrs[launch.window.rank]
        stream = torch.cuda.current_stream().cuda_stream
        rec["ipc_frame_ms"] = device_ms(
            lambda: launch.fn(src, out.data_ptr(), *launch.args, stream),
            RUNG_TIME_KERNELS, "halo_frame_kernel")
    procs.barrier()
    if w.rank == 0:
        print(CHILD_RUNG + json.dumps(rec), file=sys.stderr, flush=True)
    procs.shutdown()
    return 0


def child_rung(err: str) -> dict:
    for line in err.splitlines():
        if line.startswith(CHILD_RUNG):
            return json.loads(line[len(CHILD_RUNG):])
    raise AssertionError(f"no rung times in a child's stderr: {err[-2000:]}")


def phase_processes(card: str, wrappers: dict) -> dict:
    """Phase 30 (module docstring): the port across two processes on the
    one card. Six pairs of ranks start together: the worker, the Life CLI
    on row and on cart through the staged exchange and on the RDMA rung,
    and one pair that runs hello, then waits until the other pairs are
    done and runs the rung's times and the integral, attention and
    pingpong CLIs in turn, so that their times, elapsed, grad step and
    probe figures time only their own work."""
    import shutil

    from mpi_and_open_mp_tpu_torch.models.integral import Integral
    from mpi_and_open_mp_tpu_torch.models.life import LifeSim
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.ops import native_halo as nh
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.parallel import context as cx
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.utils.config import (
        config_from_board, load_config, save_config)
    from mpi_and_open_mp_tpu_torch.utils.vtk import read_vtk, vtk_path

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_dist_worker as worker

    t0 = time.perf_counter()
    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    os.makedirs(DIST_ROOT)
    me = os.path.abspath(__file__)

    def cli(label, chain, env=None):
        """A pair running ``chain``'s CLIs ([app, *args] each, or ["wait",
        path]) in turn, each CLI its own run across the two processes."""
        coords = [f"localhost:{free_port()}" for _ in chain]

        def argv_of(r):
            argv = [me, "--cli-child"]
            for i, (app, *args) in enumerate(chain):
                argv += ["+"] if i else []
                argv += [app, *args]
                if app != "wait":
                    argv += ["--distributed", "--coordinator", coords[i],
                             "--num-processes", str(DIST_PROCS),
                             "--process-id", str(r)]
            return argv

        return start_ranks(label, argv_of, env)

    gun = load_config(GUN_BIG)
    cfg_path = os.path.join(DIST_ROOT, "gun_big_save.cfg")
    save_config(cfg_path, config_from_board(gun.board(), gun.steps,
                                            DIST_SAVE))
    coord = f"localhost:{free_port()}"
    npz = os.path.join(DIST_ROOT, "worker.npz")
    go = os.path.join(DIST_ROOT, "pingpong.go")
    runs = {"worker": start_ranks("worker", lambda r: [
        os.path.join(ROOT, "tests", "_torch_dist_worker.py"), str(r),
        str(DIST_PROCS), coord, "--device", "cuda", "--snapshot-dir",
        DIST_ROOT, *(["--out", npz] if r == 0 else [])], RUNG_ENV)}
    life_runs = {**{k: (v, DIST_FUSE, None) for k, v in DIST_LIFE.items()},
                 **{k: (v, 1, RUNG_ENV) for k, v in DIST_RUNG.items()}}
    for label, (args, fuse, env) in life_runs.items():
        runs[label] = cli(label, [["life", cfg_path, *args, "--fuse-steps",
                                   str(fuse), "--outdir",
                                   os.path.join(DIST_ROOT,
                                                label.replace(" ", "_")),
                                   "--print-final-population"]], env)
    runs["clis"] = cli("clis", [
        ["hello", "--devices", "4"], ["wait", go], ["rung-times"],
        ["integral", str(DIST_INTEGRAL_N), "--devices",
         str(DIST_INTEGRAL_SHARDS), "--print-value"],
        ["attention", *DIST_ATTENTION], ["pingpong", "--fit"]])

    # Meanwhile, the one-process runs of the same meshes on the card.
    m2 = pm.make_mesh_1d(DIST_PROCS, axis="y", device="cuda", virtual=True)
    one = {"integral": Integral(worker.INTEGRAL_N, mesh=m2).compute()}
    board = worker.board0()
    sim = LifeSim(config_from_board(board, worker.LIFE_STEPS, 0),
                  layout="row", impl="halo", mesh=m2)
    sim.step(worker.LIFE_STEPS)
    one["board"] = sim.collect()
    sp = pm.make_mesh_1d(DIST_PROCS, axis=cx.AXIS_SP, device="cuda",
                         virtual=True)
    q, k, v = worker.ring_inputs("cuda")
    one["ring"] = cx.ring_attention(q, k, v, mesh=sp, causal=True)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    for name, g in zip("qkv", torch.autograd.grad(
            (cx.ring_attention(*qkv, mesh=sp, causal=True) ** 2).sum(),
            qkv)):
        one[f"d{name}"] = g
    zs = [cx.zigzag_shard(x, DIST_PROCS) for x in (q, k, v)]
    one["zigzag"] = cx.ring_attention(*zs, mesh=sp, causal=True,
                                      layout="zigzag")
    last_save = (gun.steps - 1) // DIST_SAVE * DIST_SAVE
    gun_at_save = nl.life_run_vmem(
        torch.from_numpy(gun.board()).cuda(), last_save).cpu().numpy()
    m8 = pm.make_mesh_1d(DIST_INTEGRAL_SHARDS, device="cuda", virtual=True)
    one_integral = Integral(DIST_INTEGRAL_N, mesh=m8).compute()
    # The worker's rung drill on one process: the frames of the global
    # stacks by the kernel and by its plain version, heat on a virtual 2x2
    # mesh under the flag; and the one-process frame kernel at the rung
    # times' block, by profiler.
    for dtype in worker.RUNG_DTYPES:
        stack = pm.shard(torch.from_numpy(worker.rung_board(dtype)).cuda(),
                         DIST_PROCS, 2)
        for d in worker.RUNG_DEPTHS:
            one[f"rung_frame_{dtype}_d{d}"] = (
                nh.halo_frame(stack, d, "cart"),
                nh.halo_frame_plain(stack, d, "cart"))
    with env_set("MOMP_HALO_RDMA", "1"):
        m22 = pm.make_mesh_2d(DIST_PROCS, 2, device="cuda", virtual=True)
        one["rung_heat"] = stencils.run_sharded(
            stencils.get("heat"), worker.heat_board(),
            worker.RUNG_HEAT_STEPS, mesh=m22, layout="cart", fuse_steps=2,
            boundary_steps=1)
        one["rung_heat_engine"] = stencils.run_sharded.last_plan.engine
    time_block = pm.shard(torch.from_numpy(gun.board()).cuda(), DIST_PROCS,
                          2)[:1].contiguous()
    one_frame_ms = device_ms(lambda: nh.halo_frame(time_block, 1, "cart"),
                             RUNG_TIME_KERNELS, "halo_frame_kernel")

    rec = {"runs": {}}
    res = {}
    try:
        for label in ("worker", *life_runs):
            res[label] = finish_ranks(runs.pop(label))
        # The other pairs are done: the last pair goes on alone.
        open(go, "w").close()
        res["clis"] = finish_ranks(runs.pop("clis"))
    finally:
        for run in runs.values():  # a failed pair stops the others
            for _, proc in run["procs"]:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    # The worker: its checks passed in both ranks; its results against
    # the one-process run of the same meshes.
    got = np.load(npz)
    diffs = {}
    for key in ("ring", "dq", "dk", "dv", "zigzag"):
        want = one[key].detach().cpu().numpy()
        diffs[key] = float(np.abs(got[key] - want).max())
    equal = {"integral": bool(got["integral"] == one["integral"]),
             "board": bool(np.array_equal(got["board"], one["board"])),
             **{k: d == 0.0 for k, d in diffs.items()}}
    for dtype in worker.RUNG_DTYPES:
        for d in worker.RUNG_DEPTHS:
            key = f"rung_frame_{dtype}_d{d}"
            kern, plain = (x.cpu().numpy() for x in one[key])
            equal[key] = bool(np.array_equal(got[key], kern)
                              and np.array_equal(got[key], plain))
    equal["rung_heat"] = bool(np.array_equal(
        got["rung_heat"], one["rung_heat"].cpu().numpy()))
    rung_counts = {k: int(got[f"rung_{k}"]) for k in (
        "frame_launches", "frame_exchanges", "heat_pair_launches",
        "heat_frame_launches", "heat_exchanges", "handshakes")}
    frames = len(worker.RUNG_DTYPES) * len(worker.RUNG_DEPTHS)
    if (not all(equal.values()) or "DIST_OK" not in res["worker"]["outs"][0][0]
            or str(got["transport"]) != "gloo-staged"
            or str(got["rung_heat_engine"]) != "overlap:rdma:pb1"
            or one["rung_heat_engine"] != "overlap:rdma:pb1"
            or rung_counts["frame_launches"] != frames
            or not rung_counts["heat_pair_launches"]
            or not rung_counts["heat_frame_launches"]
            or rung_counts["frame_exchanges"] or rung_counts["heat_exchanges"]):
        raise AssertionError(f"the worker across processes against one "
                             f"process: equal {equal}, max |diff| {diffs}, "
                             f"transport {got['transport']}, heat "
                             f"{got['rung_heat_engine']}, rung counts "
                             f"{rung_counts}")
    rec["runs"]["worker"] = {"seconds": res["worker"]["seconds"],
                             "equal_to_one_process": equal,
                             "rung_rank0": rung_counts,
                             "launches_rank0": {
                                 "halo_frame": rung_counts["frame_launches"]
                                 + rung_counts["heat_frame_launches"],
                                 "edge_pair": rung_counts[
                                     "heat_pair_launches"]}}
    log(f"  worker (integral 10^6, row halo 64x40 x 6 steps and collect, "
        f"ring h2 n64 d16 output, gradients, zigzag, a rank-0 snapshot; "
        f"under MOMP_HALO_RDMA=1 the rung's drill: halo_frame of each "
        f"rank's run of cart 2x2 48x40 uint8 and float32 at depth 1 and 2 "
        f"through the windows, heat pb1 through run_sharded): DIST_OK, "
        f"gloo-staged, every result equal to the one-process run of the "
        f"same meshes, the rung's frames to halo_frame and "
        f"halo_frame_plain on the global stack bit for bit, heat "
        f"overlap:rdma:pb1 bit for bit; rank 0's rung counts "
        f"{json.dumps(rung_counts)} ({res['worker']['seconds']:.2f} s)")
    for label in life_runs:
        (out0, err0), (out1, _) = (
            (child_sections(o)["life"], child_sections(e)["life"])
            for o, e in res[label]["outs"])
        pops = [line for line in err0.splitlines() if line.strip() == "7288"]
        snap = read_vtk(vtk_path(os.path.join(DIST_ROOT,
                                              label.replace(" ", "_")),
                                 last_save))
        counts = child_launches(err0)
        calls = [child_procs(child_sections(e)["life"])
                 for _, e in res[label]["outs"]]
        fuse, env = life_runs[label][1:]
        stamp = "overlap:rdma" if env else "overlap:deferred"
        rung_ok = (not env or (counts["halo_frame"] and all(
            c["exchange_calls"] == 0 and c["handshakes"] for c in calls)))
        if (not pops or len(out0.split()) != 1 or out1.strip()
                or not np.array_equal(snap, gun_at_save)
                or transport_line(err0)["transport"] != "gloo-staged"
                or not counts["life_padded"] or not rung_ok
                or not any(f"engine={stamp}," in k
                           for k in calls[0]["plans"])):
            raise AssertionError(f"life {label} across processes: stdout "
                                 f"{out0!r} / {out1!r}, population lines "
                                 f"{pops}, snapshot at {last_save} equal "
                                 f"{np.array_equal(snap, gun_at_save)}, "
                                 f"launches {counts}, calls between the "
                                 f"processes by rank {calls}")
        launched = {k: c for k, c in counts.items() if c}
        steps = gun.steps
        rec["runs"][f"life {label}"] = {
            "seconds": res[label]["seconds"], "elapsed_s": float(out0),
            "fuse_steps": fuse, "us_per_step": float(out0) / steps * 1e6,
            "launches_rank0": launched, "calls_by_rank": calls}
        log(f"  life p46gun_big {label} --fuse-steps {fuse} across 2 "
            f"processes{' under MOMP_HALO_RDMA=1' if env else ''}: "
            f"population 7288, the step-{last_save} snapshot (gathered, "
            f"written by rank 0) the one-process board, plans "
            f"{json.dumps(calls[0]['plans'])}, elapsed {float(out0):.3f} s "
            f"({float(out0) / steps * 1e6:.1f} us a step; beside the other "
            f"pairs), rank 0 launched {json.dumps(launched)}, "
            f"procs.exchange calls by rank "
            f"{[c['exchange_calls'] for c in calls]}, handshakes "
            f"{[c['handshakes'] for c in calls]} "
            f"({res[label]['seconds']:.2f} s) [{card}]")
    outs = [tuple(child_sections(x) for x in pair)
            for pair in res["clis"]["outs"]]
    times = child_rung(outs[0][1]["rung-times"])
    times["one_process_frame_ms"] = one_frame_ms
    # The block read once and the frame written once, as phase 18's bound.
    cells = (int(np.prod(RUNG_TIME_BLOCK[:2])) * (RUNG_TIME_BLOCK[2] + 2)
             * (RUNG_TIME_BLOCK[3] + 2))
    times["bound_ms"], times["bound_by"] = bound_ms(
        0, int(np.prod(RUNG_TIME_BLOCK)) + cells)
    rec["rung_times"] = times
    log(f"  rung times alone, cart 2x2's run of p46gun_big "
        f"{RUNG_TIME_BLOCK} uint8, depth 1: a handshake "
        f"{times['handshake_us']:.2f} us, a frame round (copy, publish, "
        f"launch) {times['round_us']:.2f} us on the host clock over "
        f"{RUNG_TIME_REPS}; the frame kernel through the window "
        f"{times['ipc_frame_ms']:.6f} ms of device time against "
        f"{one_frame_ms:.6f} ms on one process at the same block "
        f"(profiler, {RUNG_TIME_KERNELS} launches); bound "
        f"{times['bound_ms']:.7f} ms ({times['bound_by']}) [{card}]")
    (out0, err0), (out1, err1) = ((o["integral"], e["integral"])
                                  for o, e in outs)
    value = float(next(line for line in err0.splitlines()
                       if line.startswith("3.14")))
    # Each rank's chunk and Kahan passes, a warm-up compute and a timed
    # one; rank 1's run starts past chunk 0 (quadrature_chunk_kernel<true>).
    quad = [child_launches(e)["quadrature"] for e in (err0, err1)]
    if value != one_integral or quad != [4, 4] or out1.strip():
        raise AssertionError(f"integral across processes {value!r} against "
                             f"one process {one_integral!r}, quadrature "
                             f"launches by rank {quad}")
    rec["runs"]["integral"] = {"elapsed_s": float(out0), "value": value,
                               "quadrature_launches_by_rank": quad}
    log(f"  integral {DIST_INTEGRAL_N} on {DIST_INTEGRAL_SHARDS} shards "
        f"across 2 processes: {value!r}, the one-process value to the bit; "
        f"elapsed {float(out0):.6f} s (alone); quadrature launches by rank "
        f"{quad} [{card}]")
    for r, (o, _) in enumerate(outs):
        if not o["hello"].strip().endswith("ring ok"):
            raise AssertionError(f"hello rank {r}: {o['hello']!r}")
    log("  hello --devices 4 across 2 processes: ring ok in both")
    out0, err0 = outs[0][0]["attention"], outs[0][1]["attention"]
    counts = child_launches(err0)
    if ("parity ok" not in err0 or not counts["flash_fwd"]
            or not counts["flash_hop_dq"]):
        raise AssertionError(f"attention across processes: {err0[-2000:]}")
    launched = {k: c for k, c in counts.items() if c}
    rec["runs"]["attention"] = {"elapsed_s": float(out0),
                                "launches_rank0": launched}
    log(f"  attention {' '.join(DIST_ATTENTION)} across 2 processes: parity "
        f"ok, grad step {float(out0):.6f} s (alone), rank 0 launched "
        f"{json.dumps(launched)} [{card}]")
    rec["runs"]["clis"] = {"seconds": res["clis"]["seconds"]}
    # The probe, alone: the staged transport between the two processes.
    out0, out1 = outs[0][0]["pingpong"], outs[1][0]["pingpong"]
    lines = out0.strip().splitlines()
    fit = json.loads(lines[-1])
    if (lines[0] != "size,time" or len(lines) != 9 or out1.strip()
            or fit.get("transport") != "gloo-staged"):
        raise AssertionError(f"pingpong across processes: {out0!r}")
    for line in lines[1:-1]:
        log(f"  pingpong across 2 processes: {line}")
    rec["pingpong_fit"] = fit
    log(f"  pingpong --fit across 2 processes (gloo-staged, one card): "
        f"alpha {fit['alpha_us']:.3f} us, 1/beta "
        f"{fit['bandwidth_mb_s']} MB/s, r2 {fit['r2']:.3f} [{card}]")
    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    log(f"phase 30 processes: ok ({time.perf_counter() - t0:.2f} s)")
    return rec


class MetaWarmup:
    """A roll of a ``meta`` tensor on a thread, begun while phase 1 waits on
    ``nvcc``: torch's Python meta functions import ``torch._dynamo``, its
    symbolic shapes and sympy on their first call, and where torch's
    bytecode is not cached those modules compile from source for seconds,
    which phase 31's ``cost`` would otherwise pay. The main thread runs no
    torch op and imports nothing while it runs; :meth:`join` logs its
    seconds and raises what it raised."""

    def __init__(self):
        import threading

        self.error, self.seconds = None, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        t0 = time.perf_counter()
        try:
            torch.roll(torch.empty((2, 2), device="meta"), 1, 0)
        except BaseException as e:  # re-raised by join()
            self.error = e
        self.seconds = time.perf_counter() - t0

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        log(f"  meta warm-up beside the build: {self.seconds:.2f} s")


# Phase 31: p46gun_big's steady rate in the run ledger, under the JAX
# bench's metric name, written under build/ and read back.
PROFILE_LEDGER = os.path.join(ROOT, "build", "ledger", "chip_smoke.jsonl")
PROFILE_METRIC = "life_steady_cups_p46gun_big"


def phase_profile(card: str, gun_packed: torch.Tensor, ny: int, nx: int,
                  steps: int, us_step: float, row_bound_ms: float) -> dict:
    """``obs.profile`` and ``obs.ledger`` on the flagship, from phase 6's
    measurements (no timing of its own): the card's peak row, the plain
    step's work and its roofline at phase 6's differenced seconds a step,
    the memory gauges with the packed board live, and a ledger entry of
    its cups written, read back and keyed."""
    from mpi_and_open_mp_tpu_torch.obs import ledger, metrics, profile
    from mpi_and_open_mp_tpu_torch.ops import life_ops

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, label = profile.peaks_for(kind)
    if not label.startswith("h100"):
        raise AssertionError(f"peaks_for({kind!r}) gave {label}, no H100 row")
    log(f"  peaks_for({kind!r}): {label}, {peak_flops:.4g} FLOP/s, "
        f"{peak_bw:.4g} B/s (data sheet) [{card}]")

    board = torch.empty((ny, nx), dtype=torch.uint8, device="meta")
    work = profile.cost(life_ops.life_step_roll, board)
    if (work["flops"], work["bytes"]) != (10 * ny * nx, 2 * ny * nx):
        raise AssertionError(f"cost(life_step_roll) at {ny}x{nx}: {work}")
    seconds = us_step * 1e-6
    headline = profile.roofline(work["flops"], work["bytes"], seconds, kind)
    int32 = profile.roofline(work["flops"], work["bytes"], seconds, kind,
                             peak_flops=INT32_OPS_PER_S)
    log(f"  cost(life_step_roll, {ny}x{nx} uint8): {work['flops']:.0f} ops, "
        f"{work['bytes']:.0f} B ({work['compile_seconds']} s meta trace); "
        f"roofline at {us_step:.4f} us/step: headline peaks "
        f"{headline['roofline_pct']} % ({headline['bound']}; flops "
        f"{headline['flops_pct']} %, bw {headline['bw_pct']} %), INT32 "
        f"{int32['roofline_pct']} % ({int32['bound']}; flops "
        f"{int32['flops_pct']} %, bw {int32['bw_pct']} %); row 1's bound "
        f"{row_bound_ms:.4f} ms a {steps}-step call = "
        f"{row_bound_ms / steps * 1e3:.6f} us/step on the packed kernel's "
        f"{OPS_PER_WORD_STEP} INT32 instructions a 32-cell word [{card}]")

    live = profile.record_memory_gauges()
    gauges = metrics.snapshot()["gauges"]
    in_use = gauges["memory.device_bytes_in_use{device=0}"]
    watermark = gauges["memory.live_buffer_watermark_bytes"]
    packed = gun_packed.numel() * gun_packed.element_size()
    if not (live >= packed and in_use > 0 and watermark >= live):
        raise AssertionError(f"memory gauges: live {live}, watermark "
                             f"{watermark}, in use {in_use}, packed {packed}")
    log(f"  record_memory_gauges(): live {live} B (the packed board "
        f"{packed} B), watermark {watermark} B, device 0 in use {in_use} B")

    cups = ny * nx / seconds
    record = {"metric": PROFILE_METRIC, "value": cups,
              "unit": "cell_updates_per_sec", "board": [ny, nx],
              "steps": steps, "dtype": "uint8", "backend": "gpu",
              "impl": "vmem", "device_kind": kind, "roofline": int32}
    entry = ledger.stamp(record, source="chip_smoke.py", platform="gpu",
                         device_kind=kind,
                         device_count=torch.cuda.device_count())
    if os.path.exists(PROFILE_LEDGER):
        os.remove(PROFILE_LEDGER)
    ledger.append(entry, PROFILE_LEDGER)
    loaded = ledger.load(PROFILE_LEDGER)
    if loaded != [json.loads(json.dumps(entry))]:
        raise AssertionError(f"ledger read back {loaded}, wrote {entry}")
    key = ledger.config_key(loaded[0])
    found = ledger.query(loaded, metric=PROFILE_METRIC, shape=f"{ny}x{nx}",
                         topology=f"gpu:{torch.cuda.device_count()}")
    if len(found) != 1:
        raise AssertionError(f"ledger query found {len(found)} of 1: {key}")
    log(f"  ledger: {PROFILE_METRIC} {cups:.6g} cups, {key}, "
        f"git {loaded[0]['git_sha']}, read back from "
        f"{os.path.relpath(PROFILE_LEDGER, ROOT)}")
    log(f"phase 31 profile and ledger: ok ({time.perf_counter() - t0:.2f} s)")
    return {"peaks": label, "cost": work, "roofline_headline": headline,
            "roofline_int32": int32, "live_bytes": live,
            "device_bytes_in_use": in_use, "ledger_key": key, "cups": cups}


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by name: each adds one to its
    ``launches`` where it launches its kernel."""
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd as fhb
    from mpi_and_open_mp_tpu_torch.ops import native_flash as nf
    from mpi_and_open_mp_tpu_torch.ops import native_halo as nh
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npool
    from mpi_and_open_mp_tpu_torch.ops import native_quadrature as nq
    from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns

    return {"vmem": tb.vmem_steps, "fused": tb.fused_steps,
            "window": tb.window_steps,
            "life_padded": nl.life_step_padded_native,
            "vmem_batch": tb.vmem_batch_steps,
            "bitsliced": tb.bitsliced_steps,
            "stencil": ns.stencil_step_padded,
            "flash_fwd": nf.flash_fwd, "flash_hop_dq": fhb.flash_hop_dq,
            "flash_hop_dkv": fhb.flash_hop_dkv,
            "edge_pair": nh.edge_pair, "halo_frame": nh.halo_frame,
            "quadrature": nq.trapezoid_circle,
            "pool_step": npool.pool_step,
            "pool_lane_write": npool.pool_lane_write,
            "pool_lane_read": npool.pool_lane_read}


# The markers a ``--cli-child`` rank prints: each CLI's start (on stdout
# and stderr), its launch counts and its calls between processes (stderr).
CHILD_APP, CHILD_LAUNCHES = "CHILD_APP ", "CHILD_LAUNCHES "
CHILD_PROCS = "CHILD_PROCS "


def cli_child(argv: list[str]) -> int:
    """``chip_smoke.py --cli-child APP ARGS... [+ APP ARGS...]``: one rank
    of phase 30's runs across processes. Runs each port CLI ``apps.APP``
    with its ``ARGS`` in turn in this process (``wait PATH`` instead waits
    for the file PATH), every launch count set to 0 just before each and
    printed after it on stderr as one ``CHILD_LAUNCHES`` JSON line (``rung-
    times ARGS`` instead runs :func:`rung_times_child`), then
    one ``CHILD_PROCS`` line: its ``procs.exchange`` calls, its ring
    handshakes (``procs.handshake``, the RDMA rung's) and the halo plans it
    built by engine stamp (``halo.schedule.traced``); each CLI's output
    after a ``CHILD_APP`` line; stops at the first CLI that fails and
    returns its exit code."""
    import importlib

    sys.path.insert(0, ROOT)
    from mpi_and_open_mp_tpu_torch.obs import metrics
    from mpi_and_open_mp_tpu_torch.parallel import procs

    wrappers = kernel_wrappers()
    chain, cur = [], []
    for arg in argv:
        if arg == "+":
            chain.append(cur)
            cur = []
        else:
            cur.append(arg)
    chain.append(cur)
    for name, *args in chain:
        if name == "wait":
            t0 = time.perf_counter()
            while not os.path.exists(args[0]):
                if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                    return 1
                time.sleep(0.05)
            continue
        for stream in (sys.stdout, sys.stderr):
            print(CHILD_APP + name, file=stream, flush=True)
        if name == "rung-times":
            rung_times_child(args)
            continue
        app = importlib.import_module(f"mpi_and_open_mp_tpu_torch.apps.{name}")
        procs.exchange.calls = procs.handshake.calls = 0
        plans0 = metrics.snapshot()["counters"]
        rc, counts = run_counted(wrappers, lambda: app.main(args))
        sys.stdout.flush()
        print(CHILD_LAUNCHES + json.dumps(counts), file=sys.stderr,
              flush=True)
        plans = {k: v - plans0.get(k, 0)
                 for k, v in metrics.snapshot()["counters"].items()
                 if k.startswith("halo.schedule.traced")
                 and v != plans0.get(k, 0)}
        print(CHILD_PROCS + json.dumps({
            "exchange_calls": procs.exchange.calls,
            "handshakes": procs.handshake.calls, "plans": plans}),
            file=sys.stderr, flush=True)
        if rc:
            return rc
    return 0


def child_sections(text: str) -> dict[str, str]:
    """A ``--cli-child`` rank's stdout or stderr, by CLI."""
    out, name = {}, None
    for line in text.splitlines(keepends=True):
        if line.startswith(CHILD_APP):
            name = line[len(CHILD_APP):].strip()
            out[name] = ""
        elif name is not None:
            out[name] += line
    return out


def child_launches(err: str) -> dict:
    """The launch counts a ``--cli-child`` CLI printed."""
    for line in err.splitlines():
        if line.startswith(CHILD_LAUNCHES):
            return json.loads(line[len(CHILD_LAUNCHES):])
    raise AssertionError(f"no launch counts in a child's stderr: "
                         f"{err[-2000:]}")


def life_oracle(board: np.ndarray, n: int) -> np.ndarray:
    """``board`` after ``n`` steps of the compiled Life oracle
    (``utils.native.life_steps``, bit-packed; tier-1 holds it to the NumPy
    oracle bit for bit): the oracle of the 2048^2 boards, where the NumPy
    loop costs ~30 ms a step (the NumPy loop, cut for time)."""
    from mpi_and_open_mp_tpu_torch.utils import native

    return native.life_steps(board, n, bits=True)


def life_ops_oracle(cfg, n: int) -> np.ndarray:
    """``cfg``'s board after ``n`` NumPy oracle steps."""
    from mpi_and_open_mp_tpu_torch.ops import life_ops

    board = cfg.board()
    for _ in range(n):
        board = life_ops.life_step_numpy(board)
    return board


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cli-child"]:
        return cli_child(sys.argv[2:])
    if sys.argv[1:2] == ["--native-io"]:
        return native_io_child(sys.argv[2])
    if not os.path.isdir(os.path.join(ROOT, "mpi_and_open_mp_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Where torch is installed without bytecode and PYTHONDONTWRITEBYTECODE
    # is set, every child process compiles torch's Python sources again on
    # import. The children share one bytecode cache under build/ instead;
    # the first one writes it.
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(ROOT, "build",
                                                     "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config, stencils
    from mpi_and_open_mp_tpu_torch.ops import _build, life_ops
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd as fhb
    from mpi_and_open_mp_tpu_torch.ops import native_flash as nf
    from mpi_and_open_mp_tpu_torch.ops import native_halo as nh
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.parallel import haloplan as hp
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns
    from mpi_and_open_mp_tpu_torch.parallel import context as cx
    from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher
    from mpi_and_open_mp_tpu_torch.stencils import engine as se
    from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

    wrappers = kernel_wrappers()

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    # The native IO library (host C++, phase 28) beside the kernels, before
    # any config is read, so every load_config and snapshot of the script
    # goes through it (utils.native reads the library once).
    make = spawn(["make", "-B", "-C", os.path.join(ROOT, "native")],
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    warm = MetaWarmup()
    logs = _build.build(force=True)
    warm.join()
    make_out = make.communicate(timeout=300)[0]
    if make.returncode != 0:
        raise AssertionError(f"make -C native failed:\n{make_out}")
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (set-up; "
        "native/liblifeio.so built beside the kernels)")
    for name, text in logs.items():
        log(f"  {name}: built in {_build.BUILD_SECONDS[name]:.2f} s")
        if name in ("flash_fwd", "flash_hop_bwd", "stencil_padded",
                    "bitlife_window", "bitlife_vmem", "bitlife_vmem_batch",
                    "bitlife_fused",
                    "bitlife_bitsliced"):
            continue  # per kernel below
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")
    # The attention kernels one by one: registers, spills and shared
    # memory, and the tensor-core instructions (HGMMA: wgmma) in each one's
    # SASS.
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    flash_build, flash_keys = {}, {}
    for lib in ("flash_fwd", "flash_hop_bwd"):
        lib_sass = sass_counts(cuobjdump, _build.lib_path(lib), "HGMMA")
        for (kernel, d, dtype), props in ptxas_kernels(logs[lib]).items():
            props["hgmma"] = lib_sass[kernel, d, dtype]
            label = f"{kernel}<{d}, {str(dtype)[6:]}>"
            flash_build[label] = props
            flash_keys[label] = (lib, kernel, d, dtype)
            log(f"  {lib} {label}: {props['registers']} registers, "
                f"{props['spill_stores']} + {props['spill_loads']} bytes "
                f"spilled, {props['hgmma']} HGMMA")
            if dtype == torch.bfloat16 and not props["hgmma"]:
                raise AssertionError(f"{label} has no wgmma (HGMMA) in its "
                                     "SASS")
    tc_built = sorted(label for label in flash_build if "_tc<" in label)
    if tc_built != [f"{k}_tc<{d}, bfloat16>" for k in (
            "flash_fwd", "flash_hop_dkv", "flash_hop_dq") for d in (128, 64)]:
        raise AssertionError(f"tensor-core kernels built: {tc_built}")
    # The stencil kernels one by one: registers and spills from the build
    # log (none may spill), then the CUDA runtime's registers, local bytes
    # and shared memory, and the dynamic shared memory a launch asks for,
    # which must be the wrapper's smem_bytes (the layout it documents).
    stencil_build = {}
    for (rule_id, fixed), props in ptxas_kernels(
            logs["stencil_padded"], STENCIL_KERNEL,
            lambda m: (int(m[1]), int(m[2]))).items():
        label = (f"stencil_padded_kernel<{STENCIL_RULE_NAMES[rule_id]}, "
                 f"{fixed}>")
        stencil_build[label] = props
        log(f"  stencil_padded {label}: {props['registers']} registers, "
            f"{props['spill_stores']} + {props['spill_loads']} bytes "
            "spilled")
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"{label} spills registers")
    want_built = {f"stencil_padded_kernel<{n}, {r}>"
                  for n in STENCIL_RULE_NAMES
                  for r in (0, 8 if n == "lenia" else 1)}
    if set(stencil_build) != want_built:
        raise AssertionError(f"stencil kernels built: {sorted(stencil_build)}")
    stencil_r_max = max(r for r in range(1, 128)
                        if ns.fits_shared_memory(stencils.make_lenia(r)))
    stencil_lib, attrs = _build.load("stencil_padded"), (ctypes.c_int * 4)()
    stencil_attrs = {}
    for spec in [stencils.get(n) for n in stencils.names()] + [
            stencils.make_lenia(r) for r in (3, 55, stencil_r_max)]:
        rc = stencil_lib.stencil_padded_attributes(
            ns.kernel_rule(spec).rule, spec.radius, attrs)
        _build.check(stencil_lib, "stencil_padded", rc)
        regs, local, static, dynamic = attrs
        stencil_attrs[spec.name] = {"registers": regs, "local_bytes": local,
                                    "smem_bytes": static + dynamic}
        log(f"  stencil_padded {spec.name} (r = {spec.radius}, CUDA "
            f"runtime): {regs} registers, {local} local bytes, {static} + "
            f"{dynamic} bytes shared memory (static + dynamic), tile "
            f"{ns.TILE_ROWS} x {ns.layout(spec)['tile_w']}")
        if local or dynamic != ns.smem_bytes(spec):
            raise AssertionError(
                f"stencil_padded {spec.name}: {local} local bytes, {dynamic} "
                f"bytes of dynamic shared memory, smem_bytes says "
                f"{ns.smem_bytes(spec)}")

    # The window kernels one by one (bitlife_window_kernel<RT>, RT rows a
    # thread): registers and spills from the build log, none may spill;
    # then for each shard window of the main paths the geometry that
    # window_launch_geometry chooses at k = k_max and what the CUDA runtime
    # reports for it: registers, local bytes, shared memory (the dynamic
    # size must be the geometry's smem_bytes) and the clusters the card
    # can hold at once (cudaOccupancyMaxActiveClusters; 0 and the entry
    # refuses the launch).
    window_build = {}
    for (rt,), props in ptxas_kernels(logs["bitlife_window"], WINDOW_KERNEL,
                                      lambda m: (int(m[1]),)).items():
        window_build[f"bitlife_window_kernel<{rt}>"] = props
        log(f"  bitlife_window bitlife_window_kernel<{rt}>: "
            f"{props['registers']} registers, {props['spill_stores']} + "
            f"{props['spill_loads']} bytes spilled")
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"bitlife_window_kernel<{rt}> spills")
    if set(window_build) != {f"bitlife_window_kernel<{rt}>"
                             for rt in tb.WINDOW_ROWS_PER_THREAD}:
        raise AssertionError(f"window kernels built: {sorted(window_build)}")
    window_geo = {}
    for what, shards, nw_w, W_w, h_w, hx_w in window_shapes(tb):
        R_w, C_w = nw_w + 2 * h_w, W_w + 2 * hx_w
        k_w = tb.window_max_steps(h_w, hx_w)
        geo = tb.window_launch_geometry(shards, R_w, C_w, k_w)
        at = tb.window_attributes(shards, R_w, C_w, h_w, hx_w, k_w, geo)
        window_geo[what] = {"geometry": dataclasses.asdict(geo), **at}
        one_wave = at["max_active_clusters"] * geo.cluster >= (
            shards * geo.strips)
        log(f"  bitlife_window {what} {shards}x{R_w}x{C_w} k={k_w}: "
            f"(strips, cluster, g, rt, tau) = {geo.args()}, "
            f"{geo.threads} threads, {at['registers']} registers, "
            f"{at['local_bytes']} local bytes, {at['static_smem_bytes']} + "
            f"{at['dynamic_smem_bytes']} bytes shared memory; the card "
            f"holds {at['max_active_clusters']} such clusters at once "
            f"({'one wave' if one_wave else 'more than one wave'}; "
            f"{geo.reason})")
        if at["local_bytes"] or at["dynamic_smem_bytes"] != geo.smem_bytes:
            raise AssertionError(f"bitlife_window {what}: {at}")

    # The big-board fused kernels one by one (bitlife_fused_kernel<RT>, RT
    # rows a thread): registers and spills from the build log, none may
    # spill; then for each frame of phase 3 the geometry that
    # fused_launch_geometry chooses at k = k_max and what the CUDA runtime
    # reports for it: registers, local bytes (0), shared memory (the
    # geometry's smem_bytes) and the clusters the card holds at once (at
    # least 1).
    fused_build = {}
    for (rt,), props in ptxas_kernels(logs["bitlife_fused"], FUSED_KERNEL,
                                      lambda m: (int(m[1]),)).items():
        fused_build[f"bitlife_fused_kernel<{rt}>"] = props
        log(f"  bitlife_fused bitlife_fused_kernel<{rt}>: "
            f"{props['registers']} registers, {props['spill_stores']} + "
            f"{props['spill_loads']} bytes spilled")
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"bitlife_fused_kernel<{rt}> spills")
    if set(fused_build) != {f"bitlife_fused_kernel<{rt}>"
                            for rt in tb.FUSED_ROWS_PER_THREAD}:
        raise AssertionError(f"fused kernels built: {sorted(fused_build)}")
    fused_geo = {}
    for what, plan in fused_check_frames(tb):
        nw_f, W_f, k_f = plan.nw_s, plan.W, plan.k_max
        geo = tb.fused_launch_geometry(nw_f, W_f, plan.h, plan.hx, k_f)
        at = tb.fused_attributes(plan, k_f, geo)
        ratio = tb.fused_stepped_words(nw_f, W_f, geo) / (nw_f * W_f)
        fused_geo[what] = {"geometry": dataclasses.asdict(geo),
                           "waves": tb.fused_waves(geo),
                           "stepped_over_useful": ratio, **at}
        log(f"  bitlife_fused {what} frame {nw_f + 2 * plan.h}x"
            f"{W_f + 2 * plan.hx} k={k_f}: (bands, tiles, wall, strips, "
            f"cluster, g, rt, tau) = {geo.args()}, {geo.segments} segments "
            f"x {geo.warps} warps = {geo.threads} threads, "
            f"{at['registers']} registers, {at['local_bytes']} local bytes, "
            f"{at['static_smem_bytes']} + {at['dynamic_smem_bytes']} bytes "
            f"shared memory; the card holds {at['max_active_clusters']} "
            f"such clusters at once; {tb.fused_waves(geo)} waves at one "
            f"block an SM, {ratio:.3f}x the useful words stepped "
            f"({geo.reason})")
        if (at["local_bytes"] or at["dynamic_smem_bytes"] != geo.smem_bytes
                or at["max_active_clusters"] < 1):
            raise AssertionError(f"bitlife_fused {what}: {at}")

    # The resident-board kernels one by one (bitlife_vmem_cluster_kernel<RT,
    # FULL> and the one-block bitlife_vmem_kernel): registers and spills from
    # the build log, none may spill; then p46gun_big's and a tall board's
    # geometry and what the CUDA runtime reports for it: registers, local
    # bytes, shared memory (the dynamic size must be the geometry's
    # smem_bytes) and the clusters the card can hold at once.
    vmem_build = {}
    for (rt, full), props in ptxas_kernels(
            logs["bitlife_vmem"], VMEM_KERNEL,
            lambda m: (int(m[1] or 0), m[2] == "1")).items():
        label = (f"bitlife_vmem_cluster_kernel<{rt}, "
                 f"{'full' if full else 'ragged'}>" if rt else
                 "bitlife_vmem_kernel (one block)")
        vmem_build[label] = props
        log(f"  bitlife_vmem {label}: {props['registers']} registers, "
            f"{props['spill_stores']} + {props['spill_loads']} bytes spilled")
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"{label} spills")
    if len(vmem_build) != 2 * len(tb.WINDOW_ROWS_PER_THREAD) + 1:
        raise AssertionError(f"vmem kernels built: {sorted(vmem_build)}")
    vmem_geo = {}
    for ny_v, nx_v in ((500, 500), (16400, 24)):
        geo = tb.vmem_launch_geometry(ny_v, nx_v)
        at = tb.vmem_attributes(ny_v, nx_v, geo)
        vmem_geo[f"{ny_v}x{nx_v}"] = {"geometry": dataclasses.asdict(geo),
                                      **at}
        log(f"  bitlife_vmem ({ny_v}, {nx_v}): (strips, cluster, g, rt, tau) "
            f"= {geo.args()}, {geo.threads} threads, {at['registers']} "
            f"registers, {at['local_bytes']} local bytes, "
            f"{at['static_smem_bytes']} + {at['dynamic_smem_bytes']} bytes "
            f"shared memory; the card holds {at['max_active_clusters']} such "
            f"clusters at once ({geo.reason})")
        if (at["local_bytes"] or at["dynamic_smem_bytes"] != geo.smem_bytes
                or at["max_active_clusters"] < 1):
            raise AssertionError(f"bitlife_vmem ({ny_v}, {nx_v}): {at}")

    # The cell-packed stack kernel's: the same cluster kernels and its
    # one-block form, registers and spills from its own build log (none may
    # spill); then the geometry of the main path's 4-board stack and of 64
    # boards of 500^2, with what the CUDA runtime reports for it.
    vmem_batch_build = {}
    for (rt, full), props in ptxas_kernels(
            logs["bitlife_vmem_batch"], VMEM_BATCH_KERNEL,
            lambda m: (int(m[1] or 0), m[2] == "1")).items():
        label = (f"bitlife_vmem_cluster_kernel<{rt}, "
                 f"{'full' if full else 'ragged'}>" if rt else
                 "bitlife_vmem_batch_kernel (one block)")
        vmem_batch_build[label] = props
        log(f"  bitlife_vmem_batch {label}: {props['registers']} registers, "
            f"{props['spill_stores']} + {props['spill_loads']} bytes spilled")
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"bitlife_vmem_batch {label} spills")
    if len(vmem_batch_build) != 2 * len(tb.WINDOW_ROWS_PER_THREAD) + 1:
        raise AssertionError(
            f"vmem_batch kernels built: {sorted(vmem_batch_build)}")
    vmem_batch_geo = {}
    for b_v in (4, 64):
        geo = tb.vmem_batch_launch_geometry(b_v, 500, 500)
        at = tb.vmem_batch_attributes(b_v, 500, 500, geo)
        vmem_batch_geo[f"{b_v}x500x500"] = {
            "geometry": dataclasses.asdict(geo), **at,
            "waves_modelled": tb.vmem_batch_waves(b_v, geo)}
        log(f"  bitlife_vmem_batch {b_v} x (500, 500): (strips, cluster, g, "
            f"rt, tau) = {geo.args()}, {geo.threads} threads, "
            f"{at['registers']} registers, {at['local_bytes']} local bytes, "
            f"{at['static_smem_bytes']} + {at['dynamic_smem_bytes']} bytes "
            f"shared memory; the card holds {at['max_active_clusters']} such "
            f"clusters at once, {b_v} in the launch ({geo.reason})")
        if (at["local_bytes"] or at["dynamic_smem_bytes"] != geo.smem_bytes
                or at["max_active_clusters"] < 1):
            raise AssertionError(f"bitlife_vmem_batch {b_v} x 500^2: {at}")

    # The board-sliced kernels one by one (bitlife_bitsliced_kernel<RT, CT,
    # FULL, TAIL>): registers and spills from the build log, none may spill
    # (the tail forms the pool's geometries reach named); then
    # the batched main path's geometry (64 boards of 500^2, 2 planes) and
    # B = 512's, with what the CUDA runtime reports for each: registers,
    # local bytes (0), shared memory (the dynamic size must be the
    # geometry's smem_bytes) and the clusters the card can hold at once.
    sliced_build = {}
    pool_forms = {}
    for planes_p in (1, 2):
        for shape_p in POOL_TAIL_SHAPES:
            geo = tb.plan_bitsliced((planes_p, *shape_p))
            full_p = geo.window_rows == geo.segments * geo.rows_per_thread
            pool_forms.setdefault(
                (geo.rows_per_thread, geo.cols_per_thread, full_p),
                []).append(f"{planes_p}x{shape_p[0]}x{shape_p[1]}")
    for (rt, ct, full, tail), props in ptxas_kernels(
            logs["bitlife_bitsliced"], SLICED_KERNEL,
            lambda m: (int(m[1]), int(m[2]), m[3] == "1",
                       m[4] == "1")).items():
        label = (f"bitlife_bitsliced_kernel<{rt}, {ct}, "
                 f"{'full' if full else 'ragged'}"
                 f"{', tail' if tail else ''}>")
        sliced_build[label] = props
        reached = pool_forms.get((rt, ct, full)) if tail else None
        log(f"  bitlife_bitsliced {label}: {props['registers']} registers, "
            f"{props['spill_stores']} + {props['spill_loads']} bytes spilled"
            + (f" (the pool's {', '.join(reached)})" if reached else ""))
        if props["spill_stores"] or props["spill_loads"]:
            raise AssertionError(f"{label} spills")
    want_sliced = 2 * (len(tb.SLICED_KERNELS) + sum(
        ct <= tb.SLICED_RAGGED_MAX_COLS for _, ct in tb.SLICED_KERNELS))
    if len(sliced_build) != want_sliced:
        raise AssertionError(f"bitsliced kernels built: {sorted(sliced_build)}")
    sliced_geo = {}
    for shape_s in ((2, 500, 500), (16, 500, 500)):
        geo = tb.plan_bitsliced(shape_s)
        at = tb.bitsliced_attributes(shape_s, geo)
        sliced_geo["x".join(map(str, shape_s))] = {
            "geometry": dataclasses.asdict(geo), **at,
            "waves_modelled": tb.sliced_waves(shape_s[0], geo)}
        log(f"  bitlife_bitsliced {shape_s}: (bands, halo, strips, cluster, "
            f"g, rt, ct, tau) = {geo.args()}, {geo.threads} threads, "
            f"{at['registers']} registers, {at['local_bytes']} local bytes, "
            f"{at['static_smem_bytes']} + {at['dynamic_smem_bytes']} bytes "
            f"shared memory; the card holds {at['max_active_clusters']} such "
            f"clusters at once, {shape_s[0] * geo.bands * geo.strips // geo.cluster} "
            f"in the launch ({geo.reason})")
        if (at["local_bytes"] or at["dynamic_smem_bytes"] != geo.smem_bytes
                or at["max_active_clusters"] < 1):
            raise AssertionError(f"bitlife_bitsliced {shape_s}: {at}")

    # ------------------------------------------------ 2. vmem against plain
    t0 = time.perf_counter()
    vmem_err = 0
    vmem_cases = []
    seed = 100
    gen_v = torch.Generator(device="cuda").manual_seed(12)
    for shape in [(500, 500), (37, 45), (62, 1000), (95, 130)] + VMEM_SHAPES:
        ny = shape[0]
        if shape in VMEM_SHAPES:
            # Random words: ghost and junk bits random too.
            packed = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                   (tb.n_words(ny), shape[1]), generator=gen_v,
                                   device="cuda", dtype=torch.int32)
        else:
            packed = tb.pack_board(soup(shape, seed))
            seed += 1
        geo = tb.vmem_launch_geometry(*shape)
        log(f"  vmem {shape}: (strips, cluster, g, rt, tau) = {geo.args()}, "
            f"{geo.threads} threads ({geo.reason})")
        want, done = packed, 0
        for n in sorted({0, 1, 7, geo.ghost, geo.ghost + 1, 129, 1000}):
            got = tb.vmem_steps(packed, ny, n)
            want = tb._vmem_steps_plain(want, ny, n - done)
            done = n
            bad = diff_count(got, want)
            cells = diff_count(tb.unpack_board(got, ny),
                               tb.unpack_board(want, ny))
            vmem_err = max(vmem_err, min(cells, 1))
            vmem_cases.append({"shape": list(shape), "n": n,
                               "geometry": list(geo.args()),
                               "differing_words": bad})
            log(f"  vmem {shape} n={n}: differing words {bad}")
            if bad:
                raise AssertionError(f"bitlife_vmem disagrees at {shape} n={n}")
    log(f"phase 2 vmem vs plain: ok ({time.perf_counter() - t0:.2f} s)")

    # ----------------------------------------------- 3. fused against plain
    # Each frame of fused_check_frames under every geometry family
    # (fused_families, each rebuilt for the k of each round), packed words
    # bit for bit against the plain version: the boards through the runner
    # (_run_plan) at n in {1, g, g + 1, 128, 300}, g the chosen geometry's
    # ghost; the cart 2x2 shard (whose rounds need the mesh's exchange,
    # phase 14) as one launch over random words at k in {1, g, g + 1, 128}.
    def plain_steps(ext, k, plan):
        return tb._fused_steps_plain(ext, k, plan)

    def forced(geo):
        def steps(ext, k, plan):
            g = tb.fused_geometry(plan.nw_s, plan.W, plan.h, plan.hx, k,
                                  *geo.args()[:4], *geo.args()[5:])
            return tb.fused_steps(ext, k, plan, geometry=g)
        return steps

    t0 = time.perf_counter()
    fused_err = 0
    fused_cases = []
    frame_plain_10k = None
    for what, plan in fused_check_frames(tb):
        ny, nx = plan.shape
        fams = fused_families(tb, plan)
        g_c = fams["chosen"].ghost
        shard = plan.y_sharded or plan.x_sharded
        if shard:
            ext = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                (plan.nw_s + 2 * plan.h,
                                 plan.W + 2 * plan.hx), generator=torch.
                                Generator(device="cuda").manual_seed(seed),
                                device="cuda", dtype=torch.int32)
            n_steps = sorted({1, g_c, g_c + 1, plan.k_max})
        else:
            board = soup((ny, nx), 7 if what == "10000^2 frame" else seed)
            frame = torch.zeros(plan.frame, dtype=torch.uint8, device="cuda")
            frame[:ny] = board
            q = tb.pack_board_exact(frame)
            del board, frame
            n_steps = sorted({1, g_c, g_c + 1, 128, 300})
        seed += 1
        for n in n_steps:
            if shard:
                want = plain_steps(ext, n, plan)
            else:
                want = tb._run_plan(q, n, plan, plain_steps)
            for fam, geo in fams.items():
                if shard:
                    got = (tb.fused_steps(ext, n, plan) if fam == "chosen"
                           else forced(geo)(ext, n, plan))
                else:
                    got = tb._run_plan(q, n, plan, None if fam == "chosen"
                                       else forced(geo))
                bad = diff_count(got, want)
                fused_err = max(fused_err, min(bad, 1))
                fused_cases.append({"frame": what, "n": n, "family": fam,
                                    "geometry": list(geo.args()),
                                    "differing_words": bad})
                if bad:
                    raise AssertionError(
                        f"bitlife_fused disagrees at {what} n={n} under "
                        f"{fam} {geo.args()}: {bad} words")
            if what == "10000^2 frame" and n == 300:
                frame_plain_10k = tb.unpack_board_exact(want)[:ny]
            del want, got
        log(f"  fused {what} (plan hx={plan.hx} pad_y={plan.pad_y}) n in "
            f"{n_steps}: equal words under "
            + ", ".join(f"{fam} {geo.args()}" for fam, geo in fams.items()))
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log(f"phase 3 fused vs plain: ok ({time.perf_counter() - t0:.2f} s)")

    # ------------------------------------ 4. batched kernels against plain
    t0 = time.perf_counter()
    batch_err = {"vmem_batch": 0, "bitsliced": 0}
    shapes = [(500, 500), (37, 45), (95, 130)]
    vmem_batch_cases = []

    def vmem_batch_case(what, packed, ny, geo, forced, ns):
        """``bitlife_vmem_batch`` at each n of ``ns`` under ``geo`` (given
        through ``geometry=`` when ``forced``) against the plain version,
        advanced from the last n."""
        log(f"  vmem_batch {what}: (strips, cluster, g, rt, tau) = "
            f"{geo.args()}, {geo.threads} threads, grid "
            f"{tb.vmem_batch_grid(packed.shape[0], geo)} "
            f"({'forced' if forced else geo.reason})")
        want, done = packed, 0
        for n in sorted(ns):
            got = tb.vmem_batch_steps(packed, ny, n,
                                      geometry=geo if forced else None)
            want = tb._vmem_batch_steps_plain(want, ny, n - done)
            done = n
            bad = diff_count(got, want)
            batch_err["vmem_batch"] = max(batch_err["vmem_batch"],
                                          min(bad, 1))
            vmem_batch_cases.append({"case": what, "n": n,
                                     "geometry": list(geo.args()),
                                     "differing_words": bad})
            log(f"  vmem_batch {what} n={n}: differing words {bad}")
            if bad:
                raise AssertionError(
                    f"bitlife_vmem_batch disagrees at {what} n={n}")

    for b in (1, 3, 4, 7, 8, 16, 64):
        for shape in shapes:
            ny = shape[0]
            packed = tb.pack_boards(soup((b, *shape), seed))
            seed += 1
            geo = tb.vmem_batch_launch_geometry(b, *shape)
            vmem_batch_case(f"B={b} {shape}", packed, ny, geo, False,
                            {0, 1, 13, 1000, geo.ghost, geo.ghost + 1})
    # Each geometry family forced at B = 4, at 500^2 and 95x130; a board
    # no cluster holds (the one-block form, random words, ghost and junk
    # bits too); a stack past the grid's y extent (65 535 boards).
    for shape in ((500, 500), (95, 130)):
        packed = tb.pack_boards(soup((4, *shape), seed))
        seed += 1
        for family, args in (("a cluster of 16", (16, 8, 4, 4)),
                             ("a cluster of 2", (2, 8, 16, 1)),
                             ("one block", (1, 0, 0, 0))):
            geo = tb.vmem_geometry(*shape, *args)
            vmem_batch_case(f"B=4 {shape} {family}", packed, shape[0], geo,
                            True, {1, 13, geo.ghost, geo.ghost + 1, 200})
    for b, shape in ((2, VMEM_SHAPES[-1]), (70000, (1, 8))):
        ny = shape[0]
        packed = torch.randint(-2 ** 31, 2 ** 31 - 1,
                               (b, tb.n_words(ny), shape[1]), generator=gen_v,
                               device="cuda", dtype=torch.int32)
        geo = tb.vmem_batch_launch_geometry(b, *shape)
        vmem_batch_case(f"B={b} {shape} random words", packed, ny, geo,
                        False, {1, 13, geo.ghost + 1})
    # The board-sliced kernel at n in {0, 1, 13, 1000} and at its
    # geometry's edges: g and g + 1 (the first strip refresh), k and k + 1
    # (one launch of the halo's depth, then a second launch).
    sliced_cases = []
    sliced_stacks = [(b, shape) for b in (8, 33, 64, 256)
                     for shape in shapes + [(1, 8), (8, 1), (2, 2)]]
    for b, shape in sliced_stacks + [(512, (500, 500))]:
        planes = tb.pack_batch_bits(soup((b, *shape), seed))
        seed += 1
        geo = tb.plan_bitsliced(tuple(planes.shape))
        edges = {geo.ghost, geo.ghost + 1}
        if geo.halo:
            edges |= {geo.halo, geo.halo + 1}
        log(f"  bitsliced B={b} {shape}: (bands, halo, strips, cluster, g, "
            f"rt, ct, tau) = {geo.args()}, {geo.threads} threads "
            f"({geo.reason})")
        want, done = planes, 0
        for n in sorted({0, 1, 13, 1000} | edges):
            got = tb.bitsliced_steps(planes, n)
            want = tb._bitsliced_steps_plain(want, n - done)
            done = n
            bad = diff_count(got, want)
            batch_err["bitsliced"] = max(batch_err["bitsliced"], min(bad, 1))
            sliced_cases.append({"boards": b, "shape": list(shape), "n": n,
                                 "geometry": list(geo.args()),
                                 "differing_words": bad})
            log(f"  bitsliced B={b} {shape} n={n}: differing words {bad}")
            if bad:
                raise AssertionError(
                    f"bitlife_bitsliced disagrees at B={b} {shape} n={n}")
    del packed, planes, got, want
    log(f"phase 4 batched kernels vs plain: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # --------------------------------------------------------- 5. main paths
    t0 = time.perf_counter()
    cfg = load_config(GUN_BIG)
    sim = LifeSim(cfg, layout="serial", impl="auto")
    final, launches_gun = run_counted(wrappers, sim.run)
    log(f"  main path p46gun_big: impl={sim.impl} path={sim.native_path} "
        f"steps={sim.step_count} launches={launches_gun}")
    if sim.native_path != "vmem" or launches_gun["vmem"] != 1:
        raise AssertionError("p46gun_big did not run through one "
                             "bitlife_vmem launch")
    oracle = cfg.board()
    for _ in range(cfg.steps):
        oracle = life_ops.life_step_numpy(oracle)
    population = int(final.sum())
    if not np.array_equal(final, oracle) or population != 7288:
        raise AssertionError(
            f"p46gun_big at step {cfg.steps}: population {population}, "
            f"{int((final != oracle).sum())} cells differ from the oracle")
    log(f"  p46gun_big matches the numpy oracle, population {population}")
    gun_serial = final.copy()  # phase 14's reference for the sharded runs

    big = soup((10000, 10000), 7).cpu().numpy()
    big_cfg = LifeConfig(steps=300, save_steps=0, nx=10000, ny=10000,
                         cells=np.zeros((0, 2), np.int64))
    big_sim = LifeSim(big_cfg, layout="serial", impl="auto",
                      initial_board=big)
    big_final, launches_big = run_counted(wrappers, big_sim.run)
    log(f"  main path 10000^2 soup: path={big_sim.native_path} "
        f"launches={launches_big}")
    if big_sim.native_path != "frame" or launches_big["fused"] < 1:
        raise AssertionError("10000^2 did not run through bitlife_fused")
    if not np.array_equal(big_final, frame_plain_10k.cpu().numpy()):
        raise AssertionError("10000^2 LifeSim board differs from the plain "
                             "version's")
    roll = torch.from_numpy(big).cuda()
    for _ in range(big_cfg.steps):
        roll = life_ops.life_step_roll(roll)
    roll_bad = int((roll.cpu().numpy() != big_final).sum())
    if roll_bad:
        raise AssertionError(f"10000^2 LifeSim board: {roll_bad} cells differ "
                             "from unpacked life_step_roll")
    log("  10000^2 LifeSim board matches the plain version's and "
        f"{big_cfg.steps} unpacked life_step_roll steps")
    # Phase 14 holds the sharded 10000^2 run against this serial board.
    soup_10k, serial_10k = big, big_final
    del big_sim, frame_plain_10k, roll
    torch.cuda.empty_cache()

    def cli_run(*extra, population, before=""):
        env = dict(os.environ, PYTHONPATH=ROOT)
        cli = subprocess.run(
            [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.life",
             GUN_BIG, "--layout", "serial", "--print-final-population",
             *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if cli.returncode != 0:
            raise AssertionError(f"CLI failed: {cli.stderr[-2000:]}")
        lines = cli.stdout.strip().splitlines()
        if (len(lines) != 1
                or cli.stderr.strip().splitlines()[-1] != str(population)):
            raise AssertionError(f"CLI output: {cli.stdout!r} {cli.stderr!r}")
        log(f"  CLI p46gun_big{''.join(' ' + e for e in extra)}: "
            f"{float(lines[0]):.6f} s elapsed line, population {population}"
            + (f" ({before})" if before else ""))

    cli_run(population=7288)

    # The batched paths: 64 boards, board 0 p46gun_big and 63 soups.
    ny, nx = cfg.shape
    stack = soup((64, ny, nx), 21).cpu().numpy()
    stack[0] = cfg.board()
    bsim = LifeSim(cfg, layout="serial", impl="auto", initial_board=stack)
    bfinal, launches_sliced = run_counted(wrappers, bsim.run)
    log(f"  main path 64 x p46gun_big-size stack: path={bsim.native_path} "
        f"steps={bsim.step_count} launches={launches_sliced}")
    if (bsim.native_path != "batch:bitsliced"
            or launches_sliced["bitsliced"] < 1):
        raise AssertionError("the 64-board stack did not run through "
                             "bitlife_bitsliced")
    if not np.array_equal(bfinal[0], oracle):
        raise AssertionError(
            f"stack board 0: {int((bfinal[0] != oracle).sum())} cells differ "
            "from the oracle")
    for b in range(64):
        alone = tb.life_run_vmem_bits(torch.from_numpy(stack[b]).cuda(),
                                      cfg.steps).cpu().numpy()
        if not np.array_equal(bfinal[b], alone):
            raise AssertionError(
                f"stack board {b}: {int((bfinal[b] != alone).sum())} cells "
                "differ from the single-board bitlife_vmem run")
    log(f"  stack board 0 matches the oracle (population "
        f"{int(bfinal[0].sum())}); all 64 boards match bitlife_vmem")

    gsim = LifeSim(cfg, layout="serial", impl="auto", initial_board=stack[:4])
    gfinal, launches_grid = run_counted(wrappers, gsim.run)
    grid_geo = tb.vmem_batch_launch_geometry(4, ny, nx)
    log(f"  main path 4-board stack: path={gsim.native_path} "
        f"launches={launches_grid}; (strips, cluster, g, rt, tau) = "
        f"{grid_geo.args()}, {grid_geo.threads} threads ({grid_geo.reason})")
    if (gsim.native_path != "batch:vmem-grid"
            or launches_grid["vmem_batch"] < 1):
        raise AssertionError("the 4-board stack did not run through "
                             "bitlife_vmem_batch")
    if not np.array_equal(gfinal[0], oracle):
        raise AssertionError("the 4-board vmem-grid stack's board 0 differs "
                             "from the oracle")
    if not np.array_equal(gfinal, bfinal[:4]):
        raise AssertionError("the 4-board vmem-grid stack differs from the "
                             "bitsliced stack's first 4 boards")
    log("  4-board vmem-grid stack matches the oracle (board 0) and the "
        "bitsliced stack's first 4 boards")
    del bsim, gsim, gfinal

    cli_run("--batch", "64", population=64 * 7288,
            before=("0.041-0.043 s before the board-sliced kernel's "
                    "redesign, PERF.md section 5"))

    requests = [(soup((ny, nx), 300 + i).cpu().numpy(), 1000 if i % 5 else 2500)
                for i in range(40)]
    batcher = ShapeBucketBatcher(max_batch=64)
    for board, steps in requests:
        batcher.submit(board, steps)
    served, launches_batcher = run_counted(wrappers, batcher.flush)
    stats = [(s.steps, s.requests, s.padded_batch, s.path)
             for s in batcher.last_flush_stats]
    log(f"  batcher: 40 requests, dispatches {stats}, "
        f"launches={launches_batcher}")
    if launches_batcher["bitsliced"] < 1:
        raise AssertionError("the batcher did not run bitlife_bitsliced")
    for i, ((board, steps), got) in enumerate(zip(requests, served)):
        alone = tb.life_run_vmem_bits(torch.from_numpy(board).cuda(),
                                      steps).cpu().numpy()
        if not np.array_equal(got, alone):
            raise AssertionError(f"batcher request {i} differs from the "
                                 "single-board bitlife_vmem run")
    log("  every batcher result matches bitlife_vmem")
    del requests, served, stack, bfinal
    torch.cuda.empty_cache()
    log(f"phase 5 main paths: ok ({time.perf_counter() - t0:.2f} s)")

    # ---------------------------------------------------------- 6. timings
    t0 = time.perf_counter()
    ny, nx = cfg.shape
    gun_packed = tb.pack_board(torch.from_numpy(cfg.board()).cuda())
    n_main = cfg.steps
    tb.vmem_steps(gun_packed, ny, 100)  # warm-up
    vmem_ms = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, n_main), reps=3)
    plain_vmem_ms = cuda_ms(
        lambda: tb._vmem_steps_plain(gun_packed, ny, n_main))
    words = gun_packed.numel()
    vmem_bound, vmem_by = bound_ms(OPS_PER_WORD_STEP * words * n_main,
                                   2 * 4 * words)
    t_a = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, 2000))
    t_b = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, 12000))
    vmem_us_step = (t_b - t_a) / 10000 * 1e3
    vmem_dev = device_ms(lambda: tb.vmem_steps(gun_packed, ny, n_main), 5,
                         "bitlife_vmem")
    gun_geo = tb.vmem_launch_geometry(ny, nx)
    vmem_bound_occupied = vmem_bound * N_SMS / gun_geo.strips
    log(f"  vmem p46gun_big {n_main} steps: {vmem_ms:.4f} ms per call "
        f"(device {vmem_dev:.4f} ms), plain {plain_vmem_ms:.2f} ms, bound "
        f"{vmem_bound:.4f} ms (card) / {vmem_bound_occupied:.4f} ms (the "
        f"{gun_geo.strips} SMs of its blocks); (strips, cluster, g, rt, tau) "
        f"= {gun_geo.args()}, {gun_geo.threads} threads; "
        f"{vmem_us_step:.4f} us/step, "
        f"{ny * nx / vmem_us_step / 1e3:.3f} Gcups (differenced) [{card}]")

    # bitlife_fused at the main paths' frames (fused_shapes): device time
    # per launch from a profiler trace (the mean of the kernel records
    # kept), CUDA events around 10 launches, the plain version, the bound
    # on the words written, and the runner's us a step differenced over
    # 640 - 128 steps (the serial runners; the cart 2x2 shard's, the
    # bitfused LifeSim on cart 2x2, four shard launches a round).
    rates = {}
    fused_rec = None
    fused_per_shape = {}
    for what, plan in fused_shapes(tb):
        ny_f, nx_f = plan.shape
        k = plan.k_max
        board = soup((ny_f, nx_f), 11)
        if plan.y_sharded or plan.x_sharded:
            e = torch.randint(-2 ** 31, 2 ** 31 - 1,
                              (plan.nw_s + 2 * plan.h, plan.W + 2 * plan.hx),
                              generator=torch.Generator(
                                  device="cuda").manual_seed(12),
                              device="cuda", dtype=torch.int32)
            c = LifeConfig(steps=640, save_steps=0, nx=nx_f, ny=ny_f,
                           cells=np.zeros((0, 2), np.int64))
            ssim = LifeSim(c, layout="cart", impl="bitfused",
                           mesh=pm.make_mesh_2d(plan.py, plan.px),
                           initial_board=board.cpu().numpy())
            if ssim.plan_note != "tiled":
                raise AssertionError(f"{what}: plan {ssim.plan_note}")

            def run_n(n, ssim=ssim):
                return ssim._advance(ssim.board, n)
        else:
            frame = torch.zeros(plan.frame, dtype=torch.uint8, device="cuda")
            frame[:ny_f] = board
            e = tb.local_wrap_y(plan, tb.pack_board_exact(frame))
            if plan.hx:
                e = torch.cat([e[:, -plan.hx:], e, e[:, : plan.hx]], dim=1)
            del frame
            runner = (tb.life_run_frame_bits if plan.pad_y
                      else tb.life_run_fused_bits)

            def run_n(n, runner=runner, board=board):
                return runner(board, n)

        def launch(e=e, k=k, plan=plan):
            return tb.fused_steps(e, k, plan)

        launch()  # warm-up
        dev = device_ms(launch, 10, "bitlife_fused")
        events = cuda_ms(launch, reps=10)
        plain_ms = cuda_ms(lambda: plain_steps(e, k, plan))
        out_words = plan.nw_s * plan.W
        fb, fby = bound_ms(OPS_PER_WORD_STEP * out_words * k,
                           4 * (e.numel() + out_words))
        run_n(k)  # warm-up
        t_a = cuda_ms(lambda: run_n(128))
        t_b = cuda_ms(lambda: run_n(640))
        us_step = (t_b - t_a) / 512 * 1e3
        rates[what] = us_step
        geo = tb.fused_launch_geometry(plan.nw_s, plan.W, plan.h, plan.hx, k)
        fused_per_shape[what] = {
            "frame": list(e.shape), "k": k, "device_ms": dev,
            "events_ms": events, "plain_ms": plain_ms, "bound_ms": fb,
            "bound_by": fby, "runner_us_per_step": us_step,
            "geometry": list(geo.args()),
            "stepped_over_useful": tb.fused_stepped_words(
                plan.nw_s, plan.W, geo) / out_words}
        log(f"  fused {what} frame {e.shape[0]}x{e.shape[1]} k={k}: device "
            f"{dev:.4f} ms per launch (events {events:.4f}), plain "
            f"{plain_ms:.2f} ms, bound {fb:.4f} ms ({fby}, "
            f"{fb / dev:.3f} of it reached); geometry {geo.args()}; runner "
            f"{us_step:.4f} us/step, {ny_f * nx_f / us_step / 1e3:.3f} "
            f"Gcups (differenced 640-128 steps) [{card}]")
        if what == "10000^2 frame":
            fused_rec = (dev, plain_ms, fb, fby)
        del board, e
        torch.cuda.empty_cache()

    # The batched kernels at the main paths' stacks: the cell-packed one at
    # the "vmem-grid" stack of 4 boards of 500^2 and at 64, the board-sliced
    # one at 64 (board 0 p46gun_big, the rest soups).
    nb = 64
    cells = soup((nb, ny, nx), 31)
    cells[0] = torch.from_numpy(cfg.board()).cuda()
    vb_rec = {}
    for nb_v in (4, nb):
        stack_packed = tb.pack_boards(cells[:nb_v])
        geo_v = tb.vmem_batch_launch_geometry(nb_v, ny, nx)

        def vb_call(n=n_main):
            return tb.vmem_batch_steps(stack_packed, ny, n)

        vb_call(100)  # warm-up
        vb_ms = cuda_ms(vb_call, reps=3)
        try:
            vb_dev = device_ms(vb_call, 5, "bitlife_vmem")
        except RuntimeError as e:  # the tracer kept no record
            log(f"  vmem_batch {nb_v} x {ny}x{nx}: device time not measured "
                f"({e})")
            vb_dev = None
        plain_vb_ms = cuda_ms(
            lambda: tb._vmem_batch_steps_plain(stack_packed, ny, n_main))
        vb_words = stack_packed.numel()
        vb_bound, vb_by = bound_ms(OPS_PER_WORD_STEP * vb_words * n_main,
                                   2 * 4 * vb_words)
        vb_sms = min(N_SMS, nb_v * geo_v.strips)
        t_a = cuda_ms(lambda: vb_call(2000))
        t_b = cuda_ms(lambda: vb_call(12000))
        vb_us_step = (t_b - t_a) / 10000 * 1e3
        vb_rec[nb_v] = {
            "ms": vb_ms, "device_ms": vb_dev, "plain_ms": plain_vb_ms,
            "bound_ms": vb_bound, "bound_by": vb_by,
            "bound_ms_occupied": vb_bound * N_SMS / vb_sms,
            "us_per_step": vb_us_step, "geometry": dataclasses.asdict(geo_v),
            "waves_modelled": tb.vmem_batch_waves(nb_v, geo_v),
            "shape": f"{nb_v} x {ny}x{nx}, {n_main} steps per call"}
        dev_text = "not measured" if vb_dev is None else f"{vb_dev:.4f} ms"
        log(f"  vmem_batch {nb_v} x {ny}x{nx} {n_main} steps: {vb_ms:.4f} ms "
            f"per call (device {dev_text}), plain {plain_vb_ms:.2f} ms, "
            f"bound {vb_bound:.4f} ms (card) / "
            f"{vb_bound * N_SMS / vb_sms:.4f} ms (the {vb_sms} SMs of its "
            f"blocks); (strips, cluster, g, rt, tau) = {geo_v.args()}, "
            f"{geo_v.threads} threads, {nb_v * geo_v.strips} blocks "
            f"({geo_v.reason}); {vb_us_step:.4f} us/step, "
            f"{nb_v * ny * nx / vb_us_step / 1e3:.3f} Gcups (differenced) "
            f"[{card}]")
        del stack_packed

    planes = tb.pack_batch_bits(cells)
    plan = tb.plan_bitsliced(tuple(planes.shape))
    tb.bitsliced_steps(planes, 100)  # warm-up
    bs_ms = cuda_ms(lambda: tb.bitsliced_steps(planes, n_main), reps=3)
    plain_bs_ms = cuda_ms(lambda: tb._bitsliced_steps_plain(planes, n_main))
    bs_words = planes.numel()
    bs_bound, bs_by = bound_ms(OPS_PER_SLICED_WORD_STEP * bs_words * n_main,
                               2 * 4 * bs_words)
    t_a = cuda_ms(lambda: tb.bitsliced_steps(planes, 2000))
    t_b = cuda_ms(lambda: tb.bitsliced_steps(planes, 12000))
    bs_us_step = (t_b - t_a) / 10000 * 1e3
    rounds = plan.launches(n_main)
    bs_dev, bs_kept = device_span_ms(
        lambda: tb.bitsliced_steps(planes, n_main), 3, "bitlife_bitsliced",
        rounds)
    blocks = planes.shape[0] * plan.bands * plan.strips
    bs_stepped = blocks * plan.window_rows * (-(-nx // plan.strips)
                                              + 2 * plan.ghost)
    bs_bound_occupied = bs_bound * N_SMS / min(blocks, N_SMS)
    log(f"  bitsliced {nb} x {ny}x{nx} {n_main} steps: {bs_ms:.4f} ms per "
        f"call (device {bs_dev:.4f} ms, {bs_kept} of {3 * rounds} kernel "
        f"records kept; {rounds} launches; (bands, halo, "
        f"strips, cluster, g, rt, ct, tau) = {plan.args()}, {blocks} blocks, "
        f"{bs_stepped / bs_words:.3f}x the useful words stepped), plain "
        f"{plain_bs_ms:.2f} ms, bound {bs_bound:.4f} ms (card) / "
        f"{bs_bound_occupied:.4f} ms (the {min(blocks, N_SMS)} SMs of its "
        f"blocks); {bs_us_step:.4f} us/step, "
        f"{nb * ny * nx / bs_us_step / 1e3:.3f} Gcups (differenced) [{card}]")
    # Where the batched main path's device time goes: LifeSim.step packs
    # the stack, runs the kernel and unpacks; collect() copies to the host.
    stepped = tb.bitsliced_steps(planes, n_main)
    final_cells = tb.unpack_batch_bits(stepped, nb)
    split = {"pack": cuda_ms(lambda: tb.pack_batch_bits(cells), reps=3),
             "kernel": bs_ms,
             "unpack": cuda_ms(lambda: tb.unpack_batch_bits(stepped, nb),
                               reps=3),
             "to_host": cuda_ms(lambda: final_cells.cpu(), reps=3)}
    log("  bitsliced path split, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" [{card}]")
    del cells, planes, stepped, final_cells
    torch.cuda.empty_cache()

    # Both batched kernels on the same stacks: which one a stack size
    # favours. Per-step times from the difference of 1200 and 200 steps,
    # each the least of three calls (a stall of the host in one call once
    # made a difference negative).
    def per_step_us(fn):
        fn(200)  # warm-up
        t_a = min(cuda_ms(lambda: fn(200)) for _ in range(3))
        t_b = min(cuda_ms(lambda: fn(1200)) for _ in range(3))
        return (t_b - t_a) / 1000 * 1e3

    sweep = [(shape, b) for shape in ((500, 500), (95, 130))
             for b in BATCH_SWEEP]
    side_by_side = []
    for shape, b in sweep:
        ny_s = shape[0]
        cells = soup((b, *shape), 41 + b)
        packed = tb.pack_boards(cells)
        planes = tb.pack_batch_bits(cells)
        grid_us = per_step_us(lambda n: tb.vmem_batch_steps(packed, ny_s, n))
        sliced_us = per_step_us(lambda n: tb.bitsliced_steps(planes, n))
        grid_board = tb.unpack_boards(
            tb.vmem_batch_steps(packed, ny_s, 1200), ny_s)
        sliced_board = tb.unpack_batch_bits(
            tb.bitsliced_steps(planes, 1200), b)
        bad = diff_count(grid_board, sliced_board)
        if bad:
            raise AssertionError(f"batched kernels disagree at B={b} {shape}: "
                                 f"{bad} cells")
        geo_s = tb.plan_bitsliced(tuple(planes.shape))
        geo_g = tb.vmem_batch_launch_geometry(b, *shape)
        winner = "vmem-grid" if grid_us < sliced_us else "bitsliced"
        ratio = max(grid_us, sliced_us) / min(grid_us, sliced_us)
        cells_per_step = b * shape[0] * shape[1]
        side_by_side.append({"boards": b, "shape": list(shape),
                             "vmem_grid_us_per_step": grid_us,
                             "bitsliced_us_per_step": sliced_us,
                             "vmem_grid_geometry": list(geo_g.args()),
                             "winner": winner})
        log(f"  batched B={b} {shape[0]}x{shape[1]}: vmem-grid "
            f"{grid_us:.4f} us/step "
            f"({cells_per_step / grid_us / 1e3:.1f} Gcups; {geo_g.args()}), "
            f"bitsliced {sliced_us:.4f} us/step "
            f"({cells_per_step / sliced_us / 1e3:.1f} Gcups; {geo_s.args()}); "
            f"{winner} faster by {ratio:.3f}x, boards equal [{card}]")
        del cells, packed, planes, grid_board, sliced_board
    torch.cuda.empty_cache()
    log(f"phase 6 timings: {time.perf_counter() - t0:.2f} s")
    # Phase 28's host work, in a process of its own from here on, after
    # the host-clock figures of phases 2-6 (phase 28 logs the phases it
    # ran beside).
    native_io = start_native_io()

    # ------------------------------------- 7. stencil kernel against plain
    t0 = time.perf_counter()

    def padded_steps(spec, board, n, step):
        """``n`` torus steps of ``board`` (a stack, or one multi-channel
        board) through ``step`` on wrap-padded blocks."""
        for _ in range(n):
            board = step(spec, se.torus_pad(board, spec.radius))
        return board

    def stencil_board(spec, shape, seed, count=None):
        """``spec.init`` boards from ``seed`` (a stack of ``count``), on
        the card."""
        rng = np.random.default_rng(seed)
        if count is None:
            return torch.from_numpy(spec.init(rng, shape)).cuda()
        return torch.from_numpy(np.stack(
            [spec.init(rng, shape) for _ in range(count)])).cuda()

    def stencil_err(spec, got, want, what):
        """Max abs difference; raises unless integer specs are equal and
        float specs within parity_tol_for("offset")."""
        g, w = got.cpu().numpy(), want.cpu().numpy()
        err = float(np.abs(g.astype(np.float64) - w).max()) if g.size else 0.0
        if not se.parity_ok(spec, g, w, **se.parity_tol_for("offset")):
            raise AssertionError(f"{what}: max abs error {err}")
        return err

    def stencil_exact(spec, got, want, what):
        """The kernel's max abs error against the plain version, logged;
        raises unless the two agree bit for bit."""
        err = stencil_err(spec, got, want, what)
        same = (torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                if spec.is_float else torch.equal(got, want))
        if err != 0.0 or not same:
            raise AssertionError(f"{what}: max abs error {err}, not equal "
                                 "bit for bit")
        log(f"  stencil {what}: max abs error {err}")
        return err

    def radius_variant(base, r):
        """``base``'s rule (update, pre, dtype, channels, init) over radius
        ``r``: all-ones integer weights, or make_lenia(r)'s table."""
        side = 2 * r + 1
        weights = (stencils.make_lenia(r).weights if base.is_float else
                   tuple(tuple(int((i, j) != (r, r)) for j in range(side))
                         for i in range(side)))
        return dataclasses.replace(base, name=f"{base.name}_r{r}", radius=r,
                                   weights=weights, oracle_step=None)

    stencil_err_max = 0.0
    stencil_cases = 0
    stencil_specs = [stencils.get(n) for n in stencils.names()]
    stencil_specs.append(stencils.make_lenia(3))
    for spec in stencil_specs:
        r = spec.radius
        lenia = ns.kernel_rule(spec).rule == 4
        small = (max(1, r - 3), max(2, r - 2))
        lay = ns.layout(spec)
        # Interior widths around a strip and a tile: the last strip of a
        # row, and the last tile, run past the interior's right edge.
        widths = sorted({1, lay["strip"] - 1, lay["strip"] + 1,
                         lay["tile_w"] - 1, lay["tile_w"] + 1})
        shapes = [(500, 500), (37, 45), (17, 23), small]
        shapes += [(37, wd) for wd in widths]
        for shape in shapes:
            count = None if spec.channels > 1 else 3
            board = stencil_board(spec, shape, seed, count)
            seed += 1
            steps = (1, 8) if lenia else (1, 8, 100)
            for n in steps if shape in shapes[:4] else (1,):
                got = padded_steps(spec, board, n, ns.stencil_step_padded)
                want = padded_steps(spec, board, n, se.step_padded)
                err = stencil_exact(spec, got, want,
                                    f"{spec.name} {tuple(board.shape)} n={n}")
                stencil_err_max = max(stencil_err_max, err)
                stencil_cases += 1
        # A stack whose base lies one board past a torus_pad result's: an
        # odd byte offset for uint8 (39 x 47 cells a plane at r = 1).
        stack = stencil_board(spec, (37, 45), seed,
                              2 if spec.channels > 1 else 4)
        seed += 1
        padded = se.torus_pad(stack, r)[1:].contiguous()
        if not spec.is_float and padded.data_ptr() % 2 == 0:
            raise AssertionError("the offset stack starts on an even byte")
        err = stencil_exact(
            spec, ns.stencil_step_padded(spec, padded),
            ns.step_padded_plain(spec, padded),
            f"{spec.name} {tuple(padded.shape)} one board past a torus_pad "
            f"result (base at byte {padded.data_ptr() % 16} of 16)")
        stencil_err_max = max(stencil_err_max, err)
        stencil_cases += 1
    # Life and wireworld at r = 1 launch one wave of blocks that each step
    # several boards, staging the next into a second buffer meanwhile: a
    # 64-board stack at 500^2 (128 blocks a board) needs more blocks than
    # all SMs could hold at once (2048 threads each), so that path runs.
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in ("life", "wireworld"):
        spec = stencils.get(name)
        lay = ns.layout(spec)
        blocks = -(-ny // ns.TILE_ROWS) * -(-nx // lay["tile_w"])
        if 64 * blocks <= n_sms * 2048 // 256:
            raise AssertionError(f"{name}: 64 boards fit one wave")
        board = stencil_board(spec, (ny, nx), seed, 64)
        seed += 1
        for n in (1, 8):
            got = padded_steps(spec, board, n, ns.stencil_step_padded)
            want = padded_steps(spec, board, n, se.step_padded)
            err = stencil_exact(spec, got, want,
                                f"{spec.name} {tuple(board.shape)} n={n}, "
                                "several boards a block")
            stencil_err_max = max(stencil_err_max, err)
            stencil_cases += 1
        del board, got, want
    # Every kernel the build holds: each rule at its registered radius
    # above, the generic kernels of the rules registered at 1 at r = 2 and
    # 8 and of lenia at 1, and lenia at the largest radius that fits a
    # block's shared memory.
    variants = [stencils.make_lenia(1), stencils.make_lenia(stencil_r_max)]
    variants += [radius_variant(stencils.get(n), r)
                 for n in ("life", "heat", "gray_scott", "wireworld")
                 for r in (2, 8)]
    for spec in variants:
        shape = (40, 70) if spec.radius == stencil_r_max else (37, 45)
        board = stencil_board(spec, shape, seed,
                              None if spec.channels > 1 else 2)
        seed += 1
        for n in (1, 8) if spec.radius < stencil_r_max else (1,):
            got = padded_steps(spec, board, n, ns.stencil_step_padded)
            want = padded_steps(spec, board, n, se.step_padded)
            err = stencil_exact(spec, got, want,
                                f"{spec.name} {tuple(board.shape)} n={n}")
            stencil_err_max = max(stencil_err_max, err)
            stencil_cases += 1
    log(f"  {stencil_cases} stencil cases, each bit for bit")
    torch.cuda.synchronize()
    log(f"phase 7 stencil kernel vs plain: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # ---------------------------------------------- 8. stencil main paths
    t0 = time.perf_counter()
    nb = 64
    stencil_launches = {}
    for name, steps in (("wireworld", 10000), ("heat", 10000),
                        ("lenia", 1000)):
        spec = stencils.get(name)
        stack = stencil_board(spec, (ny, nx), 46, nb)
        check_at = 8 if name == "lenia" else STENCIL_ORACLE_STEPS

        def main_path():
            early = se.run_padded_native_batch(spec, stack, check_at)
            return early, se.run_padded_native_batch(
                spec, early, steps - check_at)

        (early, final), counts = run_counted(wrappers, main_path)
        stencil_launches[name] = counts["stencil"]
        log(f"  main path {name} {nb} x {ny}x{nx}, {steps} steps through "
            f"run_padded_native_batch: launches={counts}")
        if counts["stencil"] < steps:
            raise AssertionError(f"{name} did not run through stencil_padded")
        oracle_early = se.oracle_run(spec, stack[0].cpu().numpy(), check_at)
        err = stencil_err(spec, early[0], torch.from_numpy(oracle_early),
                          f"{name} board 0 at {check_at} steps vs the oracle")
        log(f"  {name} board 0 at {check_at} steps vs the NumPy oracle: "
            f"max abs error {err}")
        if name == "lenia":
            roll = se.run_roll_batch(spec, stack, check_at)
            err = stencil_err(spec, early, roll, "lenia vs run_roll_batch")
            host = final.cpu().numpy()
            if (not spec.valid_board(host) or host.min() < 0
                    or host.max() > 1):
                raise AssertionError("lenia left [0, 1] or went non-finite")
            log(f"  lenia all boards at 8 steps vs run_roll_batch: max abs "
                f"error {err}; at {steps} steps finite, in "
                f"[{host.min():.6f}, {host.max():.6f}]")
        else:
            roll = se.run_roll_batch(spec, stack, steps)
            err = stencil_err(spec, final, roll,
                              f"{name} vs run_roll_batch at {steps} steps")
            log(f"  {name} all {nb} boards at {steps} steps vs "
                f"run_roll_batch on the card: max abs error {err}")
        del stack, early, final, roll

    heat_cfg = LifeConfig(steps=STENCIL_ORACLE_STEPS, save_steps=0, nx=nx,
                          ny=ny, cells=np.zeros((0, 2), np.int64))
    hsim = LifeSim(heat_cfg, layout="serial", workload="heat")
    heat_start = hsim.collect()
    hfinal = hsim.run()
    hsim.debug_check()
    err = stencil_err(stencils.get("heat"), torch.from_numpy(hfinal),
                      torch.from_numpy(se.oracle_run(
                          stencils.get("heat"), heat_start,
                          STENCIL_ORACLE_STEPS)),
                      "LifeSim(workload='heat') vs the oracle")
    log(f"  LifeSim(workload='heat') {ny}x{nx}, impl={hsim.impl}, "
        f"{hsim.step_count} steps vs the NumPy oracle: max abs error {err}")

    rng = np.random.default_rng(71)
    mixed = []
    for i in range(24):
        name = ("life", "heat", "wireworld", "gray_scott")[i % 4]
        mixed.append((stencils.get(name).init(rng, (ny, nx)),
                      20 if i % 3 else 30, name))
    batcher = ShapeBucketBatcher(max_batch=8)
    for board, steps, name in mixed:
        batcher.submit(board, steps, workload=name)
    served, launches_mixed = run_counted(wrappers, batcher.flush)
    log(f"  batcher, mixed workloads: 24 requests, dispatches "
        f"{[(s.steps, s.requests, s.padded_batch, s.path) for s in batcher.last_flush_stats]}, "
        f"launches={launches_mixed}")
    for i, ((board, steps, name), got) in enumerate(zip(mixed, served)):
        spec = stencils.get(name)
        stencil_err(spec, torch.from_numpy(got),
                    torch.from_numpy(se.oracle_run(spec, board, steps)),
                    f"batcher request {i} ({name})")
    log("  every mixed batcher result matches the NumPy oracle")

    sparse_board = np.zeros((2048, 2048), np.uint8)
    glider = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.uint8)
    for k, (y, x) in enumerate([(126, 126), (700, 1300), (1500, 400),
                                (1023, 1023)]):
        sparse_board[y:y + 3, x:x + 3] = glider if k % 2 else glider[::-1]
    sparse_board[300:303, 1800] = 1  # a blinker
    tiles = stencils.ActiveTileEngine(stencils.get("life"), sparse_board,
                                      tile=128)
    sparse_final = tiles.step(100)
    sparse_oracle = life_oracle(sparse_board, 100)
    if not np.array_equal(sparse_final, sparse_oracle):
        raise AssertionError(
            f"ActiveTileEngine: {int((sparse_final != sparse_oracle).sum())} "
            "cells differ from the oracle")
    log(f"  ActiveTileEngine 2048^2 life, 100 steps: matches the compiled "
        f"oracle; {tiles.engine_stamp} {tiles.counters()}")
    del mixed, served, sparse_board, sparse_final, sparse_oracle
    torch.cuda.empty_cache()
    log(f"phase 8 stencil main paths: ok ({time.perf_counter() - t0:.2f} s)")

    # -------------------------------------------------- 9. stencil timings
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    stencil_rec = {}
    for name in stencils.names():
        spec = stencils.get(name)
        rule = ns.kernel_rule(spec).rule
        r = spec.radius
        count = None if spec.channels > 1 else nb
        stack = stencil_board(spec, (ny, nx), 46, count)
        padded = se.torus_pad(stack, r)
        ns.stencil_step_padded(spec, padded)  # warm-ups
        se.step_padded(spec, padded)
        k_ms = cuda_ms(lambda: ns.stencil_step_padded(spec, padded), reps=20)
        k_dev = device_ms(lambda: ns.stencil_step_padded(spec, padded), 20,
                          "stencil_padded")
        p_ms = cuda_ms(lambda: se.step_padded(spec, padded), reps=3)
        lo, hi = (20, 120) if name == "lenia" else (200, 1200)
        se.run_padded_native_batch(spec, stack, 2)  # warm-up
        ns.stencil_step_padded.launches = 0
        t_a = cuda_ms(lambda: se.run_padded_native_batch(spec, stack, lo))
        t_b = cuda_ms(lambda: se.run_padded_native_batch(spec, stack, hi))
        per_step = ns.stencil_step_padded.launches / (lo + hi)
        us_step = (t_b - t_a) / (hi - lo) * 1e3
        gather_ms = cuda_ms(lambda: se.torus_pad(stack, r), reps=20)
        offs = se.offsets(spec)
        cells = stack.numel() // spec.channels
        bound, by = stencil_bound_ms(
            spec, rule, offs, cells, padded.numel() * padded.element_size(),
            stack.numel() * stack.element_size())
        # The float rules' FP32 issue bound: each multiply and add one
        # instruction (no FMA), at 132 x 128 lanes x 1.98 GHz.
        issue = (stencil_ops(spec, rule, offs, cells) / FP32_ISSUE_PER_S
                 * 1e3 if spec.is_float else None)
        lib_ms = None
        if name in ("heat", "lenia"):
            wt = torch.tensor(spec.weights, dtype=torch.float32,
                              device="cuda")[None, None]
            x = padded[:, None]
            torch.nn.functional.conv2d(x, wt)  # warm-up
            lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x, wt),
                             reps=20)
            agg = torch.nn.functional.conv2d(x, wt)[:, 0]
            want = se.aggregate_roll(spec, stack)
            if not torch.allclose(agg, want, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"conv2d aggregate disagrees for {name}")
        stencil_rec[name] = {
            "shape": "x".join(str(d) for d in padded.shape),
            "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "fp32_issue_bound_ms": issue,
            "library_ms": lib_ms,
            "us_per_step": us_step, "gather_ms": gather_ms,
            "kernel_launches_per_step": per_step}
        log(f"  stencil {name} padded {tuple(padded.shape)}: kernel "
            f"{k_ms:.4f} ms per launch (device time {k_dev:.4f} ms; before "
            f"the redesign, CUDA events, from PERF.md: "
            f"{STENCIL_BEFORE_MS[name]} ms), bound {bound:.4f} ms ({by}, "
            f"{bound / k_ms * 100:.1f} %)"
            + (f", FP32 issue bound {issue:.4f} ms (no FMA; "
               f"{issue / k_dev * 100:.1f} % of the device time)"
               if issue is not None else "")
            + f", plain {p_ms:.4f} ms; runner "
            f"{us_step:.4f} us/step differenced {hi}-{lo} steps "
            f"({per_step:.3f} kernel launches per step, halo gather "
            f"{gather_ms:.4f} ms)"
            + (f"; library, aggregate only (conv2d, TF32 off): "
               f"{lib_ms:.4f} ms" if lib_ms is not None else "")
            + f" [{card}]")
        del stack, padded
    # Device launches per runner step, from a profiler trace of 10 steps.
    from torch.profiler import ProfilerActivity, profile

    # Device launches and busy time per runner step, from a profiler trace
    # of 10 steps; the idle share is 1 - busy / wall.
    for name in ("heat", "lenia", "gray_scott"):
        spec = stencils.get(name)
        stack = stencil_board(spec, (ny, nx), 46,
                              None if spec.channels > 1 else nb)
        se.run_padded_native_batch(spec, stack, 2)  # warm-up
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t_wall = time.perf_counter()
                se.run_padded_native_batch(spec, stack, 10)
                torch.cuda.synchronize()
                t_wall = time.perf_counter() - t_wall
        except RuntimeError as e:
            log(f"  profiler unavailable ({e}); device launches not measured")
            break
        busy: dict[str, float] = {}
        count = 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                count += 1
                busy[ev.name] = (busy.get(ev.name, 0.0)
                                 + ev.time_range.elapsed_us())
        if not count:
            log(f"  stencil {name} runner: the profiler saw no device "
                "kernels; device launches not measured")
            continue
        stencil_rec[name]["device_launches_per_step"] = count / 10
        busy_us = sum(busy.values()) / 10
        log(f"  stencil {name} runner, profiler over 10 steps: {count / 10} "
            f"device kernels per step, device busy {busy_us:.2f} us per step "
            f"({', '.join(f'{k[:60]} {v / 10:.2f} us' for k, v in busy.items())}), "
            f"wall {t_wall / 10 * 1e6:.2f} us per step, idle share "
            f"{1 - busy_us / (t_wall / 10 * 1e6):.3f} [{card}]")
        del stack
    log(f"phase 9 stencil timings: {time.perf_counter() - t0:.2f} s")

    # ---------------------------------- 10. attention kernels against plain
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    attn_gen = torch.Generator(device="cuda").manual_seed(400)

    def randn(shape, dtype):
        return torch.randn(shape, generator=attn_gen, device="cuda").to(dtype)

    flash_err = {"flash_fwd": 0.0, "flash_hop_dq": 0.0, "flash_hop_dkv": 0.0}
    for h, n, d in [(2, 640, 64), (8, 1000, 128), (4, 2048, 128)]:
        for hkv in (h, max(1, h // 4)):
            for dtype in (torch.float32, torch.bfloat16):
                for causal in (False, True):
                    q = randn((h, n, d), dtype)
                    k, v = randn((hkv, n, d), dtype), randn((hkv, n, d), dtype)
                    do = randn((h, n, d), dtype)
                    o, L = nf.flash_fwd(q, k, v, causal)
                    po, pL = nf.flash_fwd_plain(q, k, v, causal)
                    D = (do.float() * po.float()).sum(-1)
                    got = fhb.hop_block_grads(q, do, pL, D, k, v,
                                             causal=causal)
                    want = fhb.hop_block_grads_plain(q, do, pL, D, k, v,
                                                    causal=causal)
                    case = (f"({h}, {n}, {d}) kv {hkv} {str(dtype)[6:]} "
                            f"causal={causal}")
                    errs = []
                    for kernel, what, a, b, tol in (
                            ("flash_fwd", "o", o, po, 2e-4),
                            ("flash_fwd", "L", L, pL, 2e-4),
                            ("flash_hop_dq", "dq", got[0], want[0], 5e-4),
                            ("flash_hop_dkv", "dk", got[1], want[1], 5e-4),
                            ("flash_hop_dkv", "dv", got[2], want[2], 5e-4)):
                        err, share = attention_err(a, b, tol,
                                                   f"{kernel} {what} {case}")
                        flash_err[kernel] = max(flash_err[kernel], err)
                        errs.append(f"{what} {err:.3g} ({share:.3g})")
                    log(f"  attention {case}: max abs error (share of the "
                        "limit) " + ", ".join(errs))
    del q, k, v, do, o, L, po, pL, D, got, want
    # A bf16 view one element past 16 bytes: refused before any launch,
    # where the kernel's 16-byte loads would fault. Zeros, so that the
    # later phases draw the same operands from attn_gen.
    base = torch.zeros(2 * 640 * 64 + 8, dtype=torch.bfloat16, device="cuda")
    q = base[1:1 + 2 * 640 * 64].view(2, 640, 64)
    try:
        nf.flash_fwd(q, q, q, True)
    except ValueError as e:
        log(f"  attention misaligned bf16 view refused: {e}")
    else:
        raise AssertionError("flash_fwd took a bf16 view that does not "
                             "start on 16 bytes")
    del base, q
    # Each kernel has launched: what the CUDA runtime reports of it. Its
    # shared memory (static + the dynamic size its launches set) goes into
    # the kernels line, and the dynamic size must be the wrappers'
    # smem_bytes, the layout the modules document.
    for label, (lib_name, kernel, d, dtype) in flash_keys.items():
        lib, attrs = _build.load(lib_name), (ctypes.c_int * 4)()
        code = nf.DTYPE_CODES[dtype]
        if lib_name == "flash_fwd":
            rc = lib.flash_fwd_attributes(d, code, attrs)
            documented = nf.smem_bytes(d, dtype)
        else:
            dkv = "dkv" in kernel
            rc = lib.flash_hop_attributes(int(dkv), d, code, attrs)
            documented = fhb.smem_bytes(d, dtype)["dkv" if dkv else "dq"]
        _build.check(lib, lib_name, rc)
        regs, local, static, dynamic = attrs
        flash_build[label]["smem_bytes"] = static + dynamic
        log(f"  {lib_name} {label} (CUDA runtime): {regs} registers, "
            f"{local} local bytes, {static} + {dynamic} bytes shared memory "
            f"(static + dynamic)")
        if dynamic != documented:
            raise AssertionError(f"{label}: {dynamic} bytes of dynamic "
                                 f"shared memory, smem_bytes says "
                                 f"{documented}")
    torch.cuda.synchronize()
    log(f"phase 10 attention kernels vs plain: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # ------------------------------------------- 11. attention main paths
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=ROOT)
    cli = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.attention",
         "--variant", "flash", "--seq", "8192", "--heads", "8", "--head-dim",
         "128", "--causal", "--dtype", "bfloat16", "--grad"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if cli.returncode != 0:
        raise AssertionError(f"attention CLI failed: {cli.stderr[-2000:]}")
    err_lines = cli.stderr.strip().splitlines()
    cli_counts = {kv.split("=")[0]: int(kv.split("=")[1])
                  for kv in err_lines[-1].split()[1:]}
    if (not any(x.startswith("parity ok") for x in err_lines)
            or "engine=cuda:flash_fwd" not in err_lines[-2]
            or cli_counts != {"flash_fwd": 3, "flash_hop_dq": 2,
                              "flash_hop_dkv": 2}):
        raise AssertionError(f"attention CLI output: {cli.stdout!r} "
                             f"{cli.stderr!r}")
    log(f"  CLI attention 8 x 8192 x 128 causal bf16 --grad: "
        f"{float(cli.stdout):.6f} s elapsed line; "
        + "; ".join(err_lines[-3:]))
    attn_launches = dict(cli_counts)

    n32, d32 = 32768, 128
    for hkv in (8, 2):
        q = randn((8, n32, d32), torch.bfloat16)
        k, v = (randn((hkv, n32, d32), torch.bfloat16) for _ in range(2))

        def forward_and_grad(engine):
            with torch.no_grad():
                o = cx.flash_attention(q, k, v, causal=True, engine=engine)
            qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = cx.flash_attention(*qkv, causal=True, engine=engine)
            grads = torch.autograd.grad((out.float() ** 2).sum(), qkv)
            torch.cuda.synchronize()
            return o, grads

        (o, grads), counts = run_counted(
            wrappers, lambda: forward_and_grad("auto"))
        label = f"8 x {n32} x {d32} kv {hkv} causal bf16"
        log(f"  main path flash_attention {label}, forward + grad step: "
            f"engine {cx.flash_engine_for(q, k, v)}, launches={counts}")
        if (counts["flash_fwd"], counts["flash_hop_dq"],
                counts["flash_hop_dkv"]) != (2, 1, 1):
            raise AssertionError(f"{label}: not one flash_fwd launch per "
                                 "forward and two backward launches per "
                                 "grad step")
        for name in attn_launches:
            attn_launches[name] += counts[name]
        po, pgrads = forward_and_grad("plain")
        errs = {"o": attention_err(o, po, 2e-4, f"{label} o")}
        for what, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
            errs[what] = attention_err(a, b, 5e-4, f"{label} {what}")
        _, L = nf.flash_fwd(q, k, v, True)
        _, pL = nf.flash_fwd_plain(q, k, v, True)
        errs["L"] = attention_err(L, pL, 2e-4, f"{label} L")
        # The hop kernels alone at 32k, float32 gradients of random do.
        do = randn((8, n32, d32), torch.bfloat16)
        D = (do.float() * po.float()).sum(-1)
        del o, grads, po, pgrads
        got = fhb.hop_block_grads(q, do, pL, D, k, v, causal=True)
        want = fhb.hop_block_grads_plain(q, do, pL, D, k, v, causal=True)
        for what, a, b in zip(("hop dq", "hop dk", "hop dv"), got, want):
            errs[what] = attention_err(a, b, 5e-4, f"{label} {what}")
        for kernel, whats in (("flash_fwd", ("o", "L")),
                              ("flash_hop_dq", ("dq", "hop dq")),
                              ("flash_hop_dkv",
                               ("dk", "dv", "hop dk", "hop dv"))):
            flash_err[kernel] = max(flash_err[kernel],
                                    *(errs[w][0] for w in whats))
        log(f"  {label} against the plain chunked engine on the card, max "
            "abs error (share of the limit): " + ", ".join(
                f"{w} {e:.4g} ({x:.3g})" for w, (e, x) in errs.items()))
        del q, k, v, do, D, L, pL, got, want
        torch.cuda.empty_cache()

    (gate_ok, gate_engine, gate_notes), counts = run_counted(
        wrappers, lambda: cx.gated_parity_check(for_seq=n32))
    log(f"  gated_parity_check(for_seq={n32}): ok={gate_ok} engine="
        f"{gate_engine} notes={gate_notes} launches={counts}")
    if (not gate_ok or gate_notes or gate_engine != "cuda:flash_fwd:b64"
            or counts["flash_hop_dkv"] < 1):
        raise AssertionError("the parity gate did not pass on the kernels")
    for name in attn_launches:
        attn_launches[name] += counts[name]
    log(f"phase 11 attention main paths: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # --------------------------------------------- 12. attention at 32k
    t0 = time.perf_counter()
    flops = 2 * 8 * n32 * n32 * d32  # the bench's causal count

    def best_of_3(fn) -> float:
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    attn_line = {}
    for hkv, tag in ((8, ""), (2, "_gqa")):
        q = randn((8, n32, d32), torch.bfloat16)
        k, v = (randn((hkv, n32, d32), torch.bfloat16) for _ in range(2))

        def chain(r):
            with torch.no_grad():
                c = q
                for _ in range(r):
                    c = cx.flash_attention(c, k, v, causal=True)
            return c

        def grad_chain(r):
            qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
            c = qkv[0]
            for _ in range(r):
                c = cx.flash_attention(c, qkv[1], qkv[2], causal=True)
            return torch.autograd.grad((c.float() ** 2).sum(), qkv)

        chain(1)
        grad_chain(1)  # warm-ups
        t_1, t_9 = best_of_3(lambda: chain(1)), best_of_3(lambda: chain(9))
        g_1, g_3 = (best_of_3(lambda: grad_chain(1)),
                    best_of_3(lambda: grad_chain(3)))
        if not (t_9 > t_1 and g_3 > g_1):
            raise AssertionError(
                f"attention chains did not grow: forward r=1 {t_1} s, r=9 "
                f"{t_9} s; grad r=1 {g_1} s, r=3 {g_3} s")
        fwd_sec = (t_9 - t_1) / 8
        grad_sec = (g_3 - g_1) / 2
        attn_line.update({
            f"attention_32k{tag}_causal_sec": fwd_sec,
            f"attention_32k{tag}_causal_tflops": flops / fwd_sec / 1e12,
            f"attention_32k{tag}_grad_sec": grad_sec,
            f"attention_32k{tag}_grad_tflops": 3.5 * flops / grad_sec / 1e12})
        if not tag:
            # The card's tracer can lose a kernel's record (see device_ms;
            # three traces in a row once lost the forward's): trace again,
            # up to six times, until the step's three attention kernels all
            # show; the check below is unchanged.
            for attempt in range(1, 7):
                step_kernels = grad_step_kernels(lambda: grad_chain(1))
                if sum("flash_" in name for name in step_kernels) >= 3:
                    break
                log(f"  profiler: trace {attempt} of the grad step kept "
                    f"{sorted(n for n in step_kernels if 'flash_' in n)}")
        del q, k, v
    log("  attention " + json.dumps(attn_line) + f" [{card}]")
    log("  profiler, one 32k grad step, kv 8, device ms by kernel: "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in step_kernels.items()))
    flash_ran = [name for name in step_kernels if "flash_" in name]
    if sorted(flash_ran) != ["flash_fwd_tc<128>", "flash_hop_dkv_tc<128>",
                             "flash_hop_dq_tc<128>"]:
        raise AssertionError("the 32k bf16 grad step did not run the "
                             f"tensor-core kernels alone: {flash_ran}")

    # Each kernel per launch at 32k, equal heads and GQA, beside its plain
    # version, its bound and the library's call.
    attn_rec = {}
    for hkv in (8, 2):
        q = randn((8, n32, d32), torch.bfloat16)
        k, v = (randn((hkv, n32, d32), torch.bfloat16) for _ in range(2))
        do = randn((8, n32, d32), torch.bfloat16)
        o, L = nf.flash_fwd(q, k, v, True)  # warm-up
        D = (do.float() * o.float()).sum(-1)
        fhb.flash_hop_dq(q, do, L, D, k, v, causal=True)
        fhb.flash_hop_dkv(q, do, L, D, k, v, causal=True)
        rec = {
            "flash_fwd": cuda_ms(lambda: nf.flash_fwd(q, k, v, True), reps=3),
            "flash_hop_dq": cuda_ms(
                lambda: fhb.flash_hop_dq(q, do, L, D, k, v, causal=True),
                reps=3),
            "flash_hop_dkv": cuda_ms(
                lambda: fhb.flash_hop_dkv(q, do, L, D, k, v, causal=True),
                reps=3)}
        nf.flash_fwd_plain(q, k, v, True)  # warm-up
        rec["plain_fwd"] = cuda_ms(lambda: nf.flash_fwd_plain(q, k, v, True))
        rec["plain_bwd"] = cuda_ms(lambda: fhb.hop_block_grads_plain(
            q, do, L, D, k, v, causal=True))
        dq = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        dk = torch.empty(k.shape, dtype=torch.float32, device="cuda")
        rec["bound_fwd"] = attention_bound_ms(2, 8, n32, d32,
                                              nbytes(q, k, v, o, L))
        rec["bound_dq"] = attention_bound_ms(
            3, 8, n32, d32, nbytes(q, k, v, do, L, D, dq))
        rec["bound_dkv"] = attention_bound_ms(
            4, 8, n32, d32, nbytes(q, k, v, do, L, D, dk, dk))
        # The library's yardstick: SDPA (bf16, causal), forward, backward
        # and both, on the same operands, K/V un-expanded under GQA
        # (enable_gqa); never on the port's path.
        sdpa = torch.nn.functional.scaled_dot_product_attention
        gqa = {"enable_gqa": True} if hkv != 8 else {}
        qs, ks, vs = (x[None].detach().requires_grad_(True)
                      for x in (q, k, v))
        lib_o = sdpa(qs, ks, vs, is_causal=True, **gqa)
        # The yardstick computes the same function: it rounds p to bfloat16
        # before its second product, so it is held only to 2e-2 plus one
        # bfloat16 spacing of the value.
        sdpa_diff = (lib_o[0].float() - o.float()).abs()
        if bool((sdpa_diff > 2e-2 + BF16_SPACING * o.float().abs()).any()):
            raise AssertionError(
                f"SDPA o kv {hkv}: max abs error {float(sdpa_diff.max())}")
        del sdpa_diff

        def lib_fwd():
            with torch.no_grad():
                return sdpa(qs, ks, vs, is_causal=True, **gqa)

        def lib_bwd():
            return torch.autograd.grad(lib_o, (qs, ks, vs), do[None],
                                       retain_graph=True)

        def lib_both():
            return torch.autograd.grad(
                sdpa(qs, ks, vs, is_causal=True, **gqa), (qs, ks, vs),
                do[None])

        for name, fn in (("sdpa_fwd", lib_fwd), ("sdpa_bwd", lib_bwd),
                         ("sdpa_fwd_bwd", lib_both)):
            fn()  # warm-up: the first call picks and builds a kernel
            rec[name] = cuda_ms(fn, reps=10)
        lib = (f"SDPA forward {rec['sdpa_fwd']:.3f}, backward "
               f"{rec['sdpa_bwd']:.3f}, both {rec['sdpa_fwd_bwd']:.3f}")
        del qs, ks, vs, lib_o
        # Rates on each function's own products (h n^2 d FLOP each, causal:
        # 2 for the forward, 3 for dq, 4 for dk/dv) and the share of the
        # bound reached.
        for name, products, bound in (("flash_fwd", 2, rec["bound_fwd"]),
                                      ("flash_hop_dq", 3, rec["bound_dq"]),
                                      ("flash_hop_dkv", 4,
                                       rec["bound_dkv"])):
            rec[f"{name}_tflops"] = (products * 8 * n32 * n32 * d32
                                     / rec[name] / 1e9)
            rec[f"{name}_bound_share"] = bound[0] / rec[name]
        attn_rec[hkv] = rec
        log(f"  attention kernels 8 x {n32} x {d32} kv {hkv} causal bf16, ms "
            f"per launch: flash_fwd {rec['flash_fwd']:.3f} (bound "
            f"{rec['bound_fwd'][0]:.4f} {rec['bound_fwd'][1]}, "
            f"{rec['flash_fwd_tflops']:.1f} TFLOP/s, "
            f"{rec['flash_fwd_bound_share']:.3f} of the bound, plain "
            f"{rec['plain_fwd']:.2f}); flash_hop_dq {rec['flash_hop_dq']:.3f}"
            f" (bound {rec['bound_dq'][0]:.4f}, "
            f"{rec['flash_hop_dq_tflops']:.1f} TFLOP/s, "
            f"{rec['flash_hop_dq_bound_share']:.3f} of the bound); "
            f"flash_hop_dkv {rec['flash_hop_dkv']:.3f} (bound "
            f"{rec['bound_dkv'][0]:.4f}, "
            f"{rec['flash_hop_dkv_tflops']:.1f} TFLOP/s, "
            f"{rec['flash_hop_dkv_bound_share']:.3f} of the bound); "
            f"plain backward {rec['plain_bwd']:.2f}; {lib} [{card}]")
        del q, k, v, do, o, L, D, dq, dk
        torch.cuda.empty_cache()
    log(f"phase 12 attention timings: {time.perf_counter() - t0:.2f} s")

    # ----------------------- 13. sharded kernels against their plain versions
    t0 = time.perf_counter()
    gun_board = cfg.board()

    def sharded_sim(layout, mesh_shape, impl, board=gun_board, steps=None,
                    **kw):
        """A LifeSim on a mesh of virtual shards of the card."""
        ny_, nx_ = board.shape
        c = LifeConfig(steps=cfg.steps if steps is None else steps,
                       save_steps=0, nx=nx_, ny=ny_,
                       cells=np.zeros((0, 2), np.int64))
        mesh = (pm.make_mesh_2d(*mesh_shape) if layout == "cart" else
                pm.make_mesh_1d(mesh_shape[0],
                                axis="x" if layout == "col" else "y"))
        return LifeSim(c, layout=layout, impl=impl, mesh=mesh,
                       initial_board=board, **kw)

    # The shard windows of phase 14's bitfused runs (p46gun_big on row 8,
    # col 8 and cart 4x2, and the overlap split's interior and edges), then
    # the further windows of WINDOW_EDGE_CASES, for k in {1, 7, k_max},
    # each under the geometry window_launch_geometry chooses. At the main
    # paths' windows the chosen geometry must spread a window over more
    # than one block (a strip each).
    win_cases = window_shapes(tb)
    window_err = 0
    window_cases = 0
    gen = torch.Generator(device="cuda").manual_seed(500)
    for what, shards, nw_w, W_w, h_w, hx_w in win_cases + WINDOW_EDGE_CASES:
        ext = torch.randint(-2 ** 31, 2 ** 31 - 1,
                            (shards, nw_w + 2 * h_w, W_w + 2 * hx_w),
                            generator=gen, device="cuda", dtype=torch.int32)
        k_max = tb.window_max_steps(h_w, hx_w)
        for k in sorted({1, min(7, k_max), k_max}):
            geo = tb.window_launch_geometry(shards, *ext.shape[-2:], k)
            got = tb.window_steps(ext, k, h_w, hx_w)
            want = tb._window_steps_plain(ext, k, h_w, hx_w)
            torch.cuda.synchronize()
            bad = diff_count(got, want)
            window_err = max(window_err, min(bad, 1))
            window_cases += 1
            log(f"  window {what}: {tuple(ext.shape)} h={h_w} hx={hx_w} "
                f"k={k} (strips, cluster, g, rt, tau) = {geo.args()}: "
                f"differing words {bad}")
            if bad:
                raise AssertionError(f"bitlife_window disagrees: {what} k={k}")
            if (what, shards, nw_w, W_w, h_w, hx_w) in win_cases and (
                    k == k_max and geo.strips < 2):
                raise AssertionError(f"bitlife_window {what}: one block a "
                                     f"window ({geo})")
    # An illegal geometry (rows per thread with no compiled kernel) must
    # raise, not fall back.
    bad_geo = dataclasses.replace(geo, rows_per_thread=3)
    try:
        tb.window_steps(ext, 1, h_w, hx_w, geometry=bad_geo)
    except RuntimeError as e:
        log(f"  illegal geometry refused: {e}")
    else:
        raise AssertionError("bitlife_window took an illegal geometry")
    life_padded_err = 0
    for shape, dtype in (((8, 127, 252), torch.uint8),
                         ((4, 127, 502), torch.uint8),
                         ((8, 3, 252), torch.uint8),
                         ((8, 127, 252), torch.int32),
                         ((8, 37, 45), torch.uint8)):
        block = soup(shape, 600 + shape[-1]).to(dtype)
        got = nl.life_step_padded_native(block)
        want = life_ops.life_step_padded(block)
        torch.cuda.synchronize()
        bad = diff_count(got, want) + int(got.dtype != dtype)
        life_padded_err = max(life_padded_err, min(bad, 1))
        log(f"  life_step_padded_native {shape} {dtype}: differing cells "
            f"{bad}")
        if bad:
            raise AssertionError(f"stencil_padded's life rule disagrees at "
                                 f"{shape} {dtype}")
    log(f"phase 13 sharded kernels vs plain: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # ------------------------------------------------ 14. sharded main paths
    t0 = time.perf_counter()
    sharded_launches = {}
    deferred_boards = {}

    def check_board(what, got, want):
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} cells differ")

    for layout, mshape in (("row", (8,)), ("col", (8,)), ("cart", (4, 2))):
        ssim = sharded_sim(layout, mshape, "auto")
        sfinal, counts = run_counted(wrappers, ssim.run)
        name = f"bitfused {layout} {'x'.join(map(str, mshape))}"
        sharded_launches[name] = counts
        pop = int(sfinal.sum())
        log(f"  main path p46gun_big {name}: impl={ssim.impl} "
            f"plan={ssim.plan_note} steps={ssim.step_count} population "
            f"{pop} launches={counts}")
        if (ssim.impl != "bitfused" or counts["window"] < 1
                or counts["vmem"] != 0):
            raise AssertionError(f"{name} did not run through bitlife_window")
        if pop != 7288:
            raise AssertionError(f"{name}: population {pop}, not 7288")
        check_board(f"{name} vs the serial bitlife_vmem board", sfinal,
                    gun_serial)
    log("  bitfused row 8, col 8 and cart 4x2: population 7288, boards equal "
        "to the serial bitlife_vmem run")

    for layout, mshape in (("row", (4,)), ("cart", (4, 2))):
        nsim = sharded_sim(layout, mshape, "native")
        nfinal, counts = run_counted(wrappers, nsim.run)
        name = f"native {layout} {'x'.join(map(str, mshape))}"
        sharded_launches[name] = counts
        pop = int(nfinal.sum())
        log(f"  main path p46gun_big {name}: plan={nsim.plan_note} "
            f"population {pop} launches={counts}")
        if counts["life_padded"] < 1:
            raise AssertionError(f"{name} did not launch stencil_padded")
        check_board(f"{name} vs the serial bitlife_vmem board", nfinal,
                    gun_serial)
        deferred_boards[name] = nfinal  # phase 17's overlap:deferred board

    oracle_1k = gun_board
    for _ in range(1000):
        oracle_1k = life_ops.life_step_numpy(oracle_1k)
    for impl in ("halo", "roll"):
        hsim_ = sharded_sim("cart", (4, 2), impl, steps=1000)
        hfinal_, counts = run_counted(wrappers, hsim_.run)
        sharded_launches[f"{impl} cart 4x2"] = counts
        check_board(f"{impl} cart 4x2 at 1000 steps vs the oracle", hfinal_,
                    oracle_1k)
        deferred_boards[f"{impl} cart 4x2"] = hfinal_
        log(f"  {impl} cart 4x2, 1000 steps: matches the NumPy oracle "
            f"(plan={hsim_.plan_note}, launches={counts})")

    ovl_board = soup((1024, 1024), 77).cpu().numpy()
    osim = sharded_sim("row", (2,), "bitfused", board=ovl_board, steps=1000)
    ofinal, counts = run_counted(wrappers, osim.run)
    sharded_launches["bitfused row 2 1024^2"] = counts
    log(f"  1024^2 soup row 2: plan={osim.plan_note} launches={counts}")
    if osim.plan_note != "window+overlap:packed" or counts["window"] < 3:
        raise AssertionError("1024^2 row 2 did not take the packed overlap")
    serial_1k = nl.life_run_vmem(torch.from_numpy(ovl_board).cuda(),
                                 1000).cpu().numpy()
    check_board("1024^2 row 2 overlap vs the serial kernel", ofinal,
                serial_1k)
    log("  1024^2 row 2 overlap:packed matches the serial fused kernel")

    tsim = sharded_sim("cart", (2, 2), "bitfused", board=soup_10k, steps=300)
    tfinal, counts = run_counted(wrappers, tsim.run)
    sharded_launches["bitfused cart 2x2 10000^2"] = counts
    log(f"  10000^2 soup cart 2x2: plan={tsim.plan_note} "
        f"tile {tsim._plan.tr}x{tsim._plan.cx} hx={tsim._plan.hx} "
        f"launches={counts}")
    if tsim.plan_note != "tiled" or counts["fused"] < 1 or counts["window"]:
        raise AssertionError("10000^2 cart 2x2 did not run tiled shards")
    check_board("10000^2 cart 2x2 vs the serial frame board", tfinal,
                serial_10k)
    log("  10000^2 cart 2x2 matches phase 3's serial frame board")
    del tsim, tfinal, soup_10k, serial_10k
    torch.cuda.empty_cache()

    cli_run("--layout", "cart", "--mesh", "4,2", "--virtual-devices", "8",
            population=7288)
    log(f"phase 14 sharded main paths: ok ({time.perf_counter() - t0:.2f} s)")

    # ---------------------------------------------- 15. sharded timings
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile

    def window_record(what, shards, nw_w, W_w, h_w, hx_w):
        ext = torch.randint(-2 ** 31, 2 ** 31 - 1,
                            (shards, nw_w + 2 * h_w, W_w + 2 * hx_w),
                            generator=gen, device="cuda", dtype=torch.int32)
        k = tb.window_max_steps(h_w, hx_w)
        geo = tb.window_launch_geometry(shards, *ext.shape[-2:], k)

        def kernel():
            return tb.window_steps(ext, k, h_w, hx_w)

        def plain():
            return tb._window_steps_plain(ext, k, h_w, hx_w)

        kernel(), plain()  # warm-up
        k_ms = device_ms(kernel, 50, "bitlife_window")
        p_ms = device_ms(plain, 1)
        k_events, p_events = cuda_ms(kernel, reps=50), cuda_ms(plain)
        # The work is the interior's: each output word, k steps (as phase
        # 6 bounds the fused kernel). The ghost columns a strip recomputes
        # are the design's redundancy, not work the function needs. The
        # second bound is for the SMs the launch's blocks occupy (one
        # block an SM at most).
        out_words = shards * nw_w * W_w
        ops = OPS_PER_WORD_STEP * out_words * k
        bound, by = bound_ms(ops, 4 * (ext.numel() + out_words))
        sms = min(N_SMS, shards * geo.strips)
        sm_bound = ops / (INT32_OPS_PER_S * sms / N_SMS) * 1e3
        log(f"  window {what} {tuple(ext.shape)} k={k}: device time per "
            f"launch {k_ms:.4f} ms, plain {p_ms:.3f} ms (CUDA events around "
            f"back-to-back calls: {k_events:.4f}, plain {p_events:.3f}); "
            f"bound {bound:.6f} ms ({by}, the card) / {sm_bound:.5f} ms (the "
            f"{sms} SMs of its {shards * geo.strips} blocks); (strips, "
            f"cluster, g, rt, tau) = {geo.args()} [{card}]")
        return {"what": what, "shape": "x".join(map(str, ext.shape)),
                "k": k, "ms": k_ms, "plain_ms": p_ms, "events_ms": k_events,
                "plain_events_ms": p_events, "bound_ms": bound,
                "bound_by": by, "bound_ms_occupied_sms": sm_bound,
                "blocks": shards * geo.strips,
                "geometry": dataclasses.asdict(geo)}

    window_rec = [window_record(*c) for c in win_cases]

    # The Life rule of stencil_padded at the native main path's shard
    # blocks (cart 4x2: eight 125 x 250 shards, 1-padded), beside conv2d
    # computing the aggregate alone as the library's yardstick.
    # Kernel, plain version and library each timed both ways: device time
    # from a profiler trace (the figures in the kernels line) and CUDA
    # events around back-to-back calls.
    lp_block = soup((8, 127, 252), 610)
    life_spec = stencils.get("life")
    wt = torch.tensor(life_spec.weights, dtype=torch.float32,
                      device="cuda")[None, None]
    x_f = lp_block.float()[:, None]
    lp_fns = {"kernel": lambda: nl.life_step_padded_native(lp_block),
              "plain": lambda: life_ops.life_step_padded(lp_block),
              "library": lambda: torch.nn.functional.conv2d(x_f, wt)}
    for fn in lp_fns.values():
        fn()  # warm-up
    lp_dev = {name: device_ms(fn, 50,
                              "stencil_padded" if name == "kernel" else None)
              for name, fn in lp_fns.items()}
    lp_events = {name: cuda_ms(fn, reps=50) for name, fn in lp_fns.items()}
    lp_ms, lp_plain, lp_lib = (lp_dev["kernel"], lp_dev["plain"],
                               lp_dev["library"])
    lp_bound, lp_by = stencil_bound_ms(
        life_spec, 0, se.offsets(life_spec), 8 * 125 * 250,
        lp_block.numel(), 8 * 125 * 250)
    log(f"  life_step_padded_native (8, 127, 252): device time per call: "
        f"kernel {lp_ms:.4f} ms, plain {lp_plain:.4f} ms, library "
        f"(aggregate only: conv2d, float32, TF32 off) {lp_lib:.4f} ms; "
        f"CUDA events around back-to-back calls: kernel "
        f"{lp_events['kernel']:.4f}, plain {lp_events['plain']:.4f}, "
        f"library {lp_events['library']:.4f} ms; bound {lp_bound:.5f} ms "
        f"({lp_by}); the kernel before the redesign, device time, from "
        f"PERF.md: {LIFE_SHARDS_BEFORE_MS} ms [{card}]")

    # The sharded runners: us/step from the difference of two step counts,
    # then a profiler trace of one advance for the device time by kernel
    # (the window or padded kernel against the ghost exchange's copies).
    def runner_record(name, sim_, lo, hi, kernel_name):
        def advance(n):
            return sim_._advance(sim_.board, n)

        advance(lo)  # warm-up
        t_a = cuda_ms(lambda: advance(lo))
        t_b = cuda_ms(lambda: advance(hi))
        us_step = (t_b - t_a) / (hi - lo) * 1e3
        rec = {"us_per_step": us_step}
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t_wall = time.perf_counter()
                advance(lo)
                torch.cuda.synchronize()
                t_wall = time.perf_counter() - t_wall
        except RuntimeError as e:
            log(f"  profiler unavailable ({e}); split not measured")
            return rec
        kern = other = 0.0
        count = 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                count += 1
                if kernel_name in ev.name:
                    kern += ev.time_range.elapsed_us()
                else:
                    other += ev.time_range.elapsed_us()
        if count:
            wall_us = t_wall * 1e6
            rec.update(kernel_us_per_step=kern / lo,
                       exchange_us_per_step=other / lo,
                       device_kernels_per_step=count / lo,
                       idle_share=1 - (kern + other) / wall_us)
            log(f"  runner {name}: {us_step:.4f} us/step differenced "
                f"{hi}-{lo}; profiler over {lo} steps: kernel "
                f"{kern / lo:.4f} us/step, ghost exchange and packing "
                f"{other / lo:.4f} us/step, {count / lo:.3f} device kernels "
                f"per step, idle share {rec['idle_share']:.3f} [{card}]")
        else:
            log(f"  runner {name}: {us_step:.4f} us/step differenced; the "
                "profiler saw no device kernels, split not measured")
        return rec

    runner_rec = {}
    for layout, mshape in (("row", (8,)), ("col", (8,)), ("cart", (4, 2))):
        runner_rec[f"bitfused {layout}"] = runner_record(
            f"bitfused {layout} p46gun_big",
            sharded_sim(layout, mshape, "bitfused"), 2000, 12000,
            "bitlife_window")
    runner_rec["native cart 4x2"] = runner_record(
        "native cart 4x2 p46gun_big", sharded_sim("cart", (4, 2), "native"),
        200, 1200, "stencil_padded")
    runner_rec["bitfused row 2 1024^2"] = runner_record(
        "bitfused row 2 1024^2 (overlap)",
        sharded_sim("row", (2,), "bitfused", board=ovl_board), 256, 1280,
        "bitlife_window")
    # Each geometry that takes the overlap split, against the same sim built
    # under MOMP_HALO_OVERLAP=0, in the order overlap, sequential,
    # sequential, overlap. Both schedules run on the one stream, so the
    # split's extra launches show here.
    def with_env(name, value, build):
        """``build()`` with the environment variable ``name`` set to
        ``value`` (plans read their flags when they are made)."""
        with env_set(name, value):
            return build()

    def without_overlap(build):
        return with_env("MOMP_HALO_OVERLAP", "0", build)

    def us_per_step(sim_, lo, hi):
        sim_._advance(sim_.board, lo)  # warm-up
        t_a = cuda_ms(lambda: sim_._advance(sim_.board, lo))
        t_b = cuda_ms(lambda: sim_._advance(sim_.board, hi))
        return (t_b - t_a) / (hi - lo) * 1e3

    overlap_rec = {}
    for name, args, kw, lo, hi in (
            ("native row 4", ("row", (4,), "native"), {}, 200, 1200),
            ("native cart 4x2", ("cart", (4, 2), "native"), {}, 200, 1200),
            ("halo cart 4x2", ("cart", (4, 2), "halo"), {}, 200, 1200),
            ("bitfused row 2 1024^2", ("row", (2,), "bitfused"),
             {"board": ovl_board}, 256, 1280)):
        sims = {"overlap": sharded_sim(*args, **kw),
                "sequential": without_overlap(
                    lambda: sharded_sim(*args, **kw))}
        notes = {m: s.plan_note for m, s in sims.items()}
        if ("overlap" not in notes["overlap"]
                or "seq" not in notes["sequential"]):
            raise AssertionError(f"{name}: schedules {notes}")
        outs = [s._advance(s.board, lo) for s in sims.values()]
        if not torch.equal(*outs):
            raise AssertionError(f"{name}: overlap and sequential differ")
        times = {m: [] for m in sims}
        for m in ("overlap", "sequential", "sequential", "overlap"):
            times[m].append(us_per_step(sims[m], lo, hi))
        overlap_rec[name] = {"plan_note": notes, "us_per_step": times}
        log(f"  {name}: {notes['overlap']} "
            f"{', '.join(f'{t:.4f}' for t in times['overlap'])} us/step, "
            f"{notes['sequential']} "
            f"{', '.join(f'{t:.4f}' for t in times['sequential'])} us/step "
            f"(differenced {hi}-{lo}; run in the order overlap, sequential, "
            f"sequential, overlap; boards equal) [{card}]")
    log(f"  serial bitlife_vmem on p46gun_big: {vmem_us_step:.4f} us/step "
        f"(phase 6) [{card}]")
    log(f"phase 15 sharded timings: {time.perf_counter() - t0:.2f} s")

    # ------------------------------------------------ the RDMA rung (16-18)
    def rung_exchanges(plan):
        """``(frame, edge pair)`` launches one round of ``plan`` makes on
        the rung: one edge pair per sub-round of a partitioned boundary,
        else one frame (both rings and the corners in one launch)."""
        if not plan.engine.startswith("overlap:rdma"):
            return 0, 0
        if plan.boundary_steps != plan.fuse_steps:
            return 0, plan.fuse_steps // plan.boundary_steps
        return 1, 0

    def record_transport(fn):
        """``fn()``, returning what the rung hands its transport: the
        (shape, strides, dtype, axis) of every edge pair and the (shape,
        strides, dtype, depth, layout) of every frame."""
        pairs, frames = {}, {}
        pair, frame = hp._rdma_edge_pair, hp._rdma_frame

        def pair_recorder(fwd, bwd, axis_name, p, *, collective_id):
            pairs[(tuple(fwd.shape), fwd.stride(), bwd.stride(), fwd.dtype,
                   axis_name)] = None
            return pair(fwd, bwd, axis_name, p, collective_id=collective_id)

        def frame_recorder(block, plan, *, collective_ids):
            frames[(tuple(block.shape), block.stride(), block.dtype,
                    plan.depth, plan.layout)] = None
            return frame(block, plan, collective_ids=collective_ids)

        hp._rdma_edge_pair, hp._rdma_frame = pair_recorder, frame_recorder
        try:
            fn()
        finally:
            hp._rdma_edge_pair, hp._rdma_frame = pair, frame
        return list(pairs), list(frames)

    def rung_sim(*args, **kw):
        return with_env("MOMP_HALO_RDMA", "1",
                        lambda: sharded_sim(*args, **kw))

    # The rung's float stencil runs: run_sharded on a 500^2 board, cart 4x2,
    # fuse_steps 2, coupled and with boundary_steps 1.
    rung_mesh = pm.make_mesh_2d(4, 2)
    rung_stencils = {"heat": 100, "lenia": 8}
    rung_boards = {w: stencils.get(w).init(np.random.default_rng(46),
                                           (500, 500))
                   for w in rung_stencils}

    def rung_stencil_run(workload, n, boundary, rdma):
        return with_env("MOMP_HALO_RDMA", "1" if rdma else "0",
                        lambda: se.run_sharded(
                            stencils.get(workload), rung_boards[workload], n,
                            mesh=rung_mesh, layout="cart", fuse_steps=2,
                            boundary_steps=boundary))

    # ------------- 16. halo_edge_pair and halo_frame against their plain versions
    t0 = time.perf_counter()
    edge_err = 0
    edge_checks = 0
    frame_err = 0
    frame_checks = 0
    gen_e = torch.Generator(device="cuda").manual_seed(700)

    def edge_case(fwd, bwd, axis, what):
        nonlocal edge_err, edge_checks
        got = nh.edge_pair(fwd, bwd, axis)
        want = nh.edge_pair_plain(fwd, bwd, axis)
        torch.cuda.synchronize()
        bad = sum(diff_count(a, b) for a, b in zip(got, want))
        bad += sum(int(not a.is_contiguous()) for a in got)
        edge_checks += 1
        if bad:
            edge_err = 1
            raise AssertionError(f"halo_edge_pair disagrees: {what}: {bad}")

    def frame_case(block, depth, layout, what):
        """The frame kernel against its plain version, compared as raw
        bytes (random bytes may hold NaN patterns)."""
        nonlocal frame_err, frame_checks
        got = nh.halo_frame(block, depth, layout)
        want = nh.halo_frame_plain(block, depth, layout).contiguous()
        torch.cuda.synchronize()
        bad = int(got.shape != want.shape or not got.is_contiguous())
        if not bad:
            bad = diff_count(got.view(torch.uint8), want.view(torch.uint8))
        frame_checks += 1
        if bad:
            frame_err = 1
            raise AssertionError(f"halo_frame disagrees: {what}: {bad}")

    def random_block(shape, dtype):
        if dtype.is_floating_point:
            return torch.rand(shape, generator=gen_e, device="cuda",
                              dtype=dtype)
        return torch.randint(0, 256, shape, generator=gen_e, device="cuda",
                             dtype=torch.int32).to(dtype)

    for dtype, channels in ((torch.uint8, 1), (torch.int32, 1),
                            (torch.float32, 1), (torch.float32, 2)):
        for axis, sizes in (("y", [(p, q) for p in (1, 2, 4, 8)
                                   for q in (1, 2)]),
                            ("x", [(q, p) for p in (1, 2, 4, 8)
                                   for q in (1, 2)])):
            for py, px in sizes:
                lead = (py, px) + ((channels,) if channels > 1 else ())
                block = random_block(lead + (72, 68), dtype)
                for depth in (1, 3, 32):
                    for edge in ("y", "x"):
                        if edge == "y":
                            f, b = block[..., -depth:, :], block[..., :depth, :]
                        else:
                            f, b = block[..., -depth:], block[..., :depth]
                        edge_case(f, b, axis, f"{dtype} C={channels} "
                                  f"{py}x{px} axis {axis} {edge} edges "
                                  f"depth {depth}")
    log(f"  halo_edge_pair: {edge_checks} grid cases bit-equal to the plain "
        "version (uint8, int32, float32, 2-channel float32; y and x edges; "
        "axis sizes 1, 2, 4, 8; depths 1, 3, 32)")
    # The frame over the same dtypes, the three layouts on four meshes of 8
    # shards, depths 1, 3 and a shard's extent (past it: refused).
    for dtype, channels in ((torch.uint8, 1), (torch.int32, 1),
                            (torch.float32, 1), (torch.float32, 2)):
        for layout in ("row", "col", "cart"):
            for py, px in ((8, 1), (1, 8), (4, 2), (2, 4)):
                lead = (py, px) + ((channels,) if channels > 1 else ())
                block = random_block(lead + (24, 40), dtype)
                for depth in (1, 3, 24):
                    frame_case(block, depth, layout, f"{dtype} C={channels} "
                               f"{layout} {py}x{px} depth {depth}")
                try:
                    nh.halo_frame(block, 25, layout)
                except ValueError:
                    pass
                else:
                    raise AssertionError("halo_frame took a depth past the "
                                         "shard's extent")
    grid_frames = frame_checks

    def strided_block(dtype, shape, *, pitch, gap, offset, col_step=1):
        """Random bytes viewed as a (py, px, *C, h, w) block with rows
        ``w * col_step + pitch`` elements apart, ``gap`` elements between
        channel planes and between shards, ``offset`` elements into the
        buffer: the runs start at every alignment."""
        py, px, *chans, h, w = shape
        strides = [0] * len(shape)
        strides[-1], strides[-2] = col_step, w * col_step + pitch
        inner = h * strides[-2] + gap
        for i in range(len(chans) - 1, -1, -1):
            strides[2 + i] = inner
            inner *= chans[i]
        inner += gap
        strides[0], strides[1] = inner * px, inner
        span = offset + inner * py * px + 8
        elem = torch.empty((), dtype=dtype).element_size()
        buf = torch.randint(0, 256, (span * elem,), generator=gen_e,
                            device="cuda", dtype=torch.int32).to(torch.uint8)
        return buf.view(dtype).as_strided(shape, strides, offset)

    for dtype in (torch.uint8, torch.int16, torch.int32, torch.float32,
                  torch.float64):
        for layout, mesh_shape in (("row", (4, 1)), ("col", (1, 4)),
                                   ("cart", (4, 2))):
            for offset in range(4):
                block = strided_block(dtype, (*mesh_shape, 2, 3, 9, 137),
                                      pitch=offset + 1, gap=5, offset=offset)
                for depth in (1, 3, 5):
                    frame_case(block, depth, layout,
                               f"{dtype} {layout} strided, offset {offset}, "
                               f"depth {depth}")
            block = strided_block(dtype, (*mesh_shape, 2, 6, 10), pitch=1,
                                  gap=3, offset=3, col_step=2)
            frame_case(block, 2, layout, f"{dtype} {layout} column-strided")
    log(f"  halo_frame: {grid_frames} grid cases (uint8, int32, float32, "
        "2-channel float32; row, col, cart on 8x1, 1x8, 4x2, 2x4; depths 1, "
        f"3, 24; 25 refused) and {frame_checks - grid_frames} strided cases "
        "(1-, 2-, 4- and 8-byte elements; merged channel axes, padded rows, "
        "offsets 0-3; column-strided) bit-equal to the plain version")
    # What the rung's runs below hand their transport: one round of each,
    # recorded.
    rung_runs = [("native row 4", ("row", (4,), "native"), {}),
                 ("native cart 4x2", ("cart", (4, 2), "native"), {}),
                 ("halo cart 4x2", ("cart", (4, 2), "halo"), {})]
    main_pairs, main_frames = {}, {}
    for name, args, kw in rung_runs:
        probe = rung_sim(*args, **kw)
        main_pairs[name], main_frames[name] = record_transport(
            lambda: probe._advance(probe.board, 1))
    for workload in rung_stencils:
        for boundary in (None, 1):
            name = f"{workload} cart 4x2 b={boundary}"
            main_pairs[name], main_frames[name] = record_transport(
                lambda: rung_stencil_run(workload, 2, boundary, True))

    def strided_pair(shape, f_stride, b_stride, dtype):
        """Random forward and backward edges of ``shape`` with the given
        strides, views of one buffer as the rung's edges are of a block."""
        span = 1 + sum((n - 1) * st for n, st in zip(shape, f_stride))
        span_b = 1 + sum((n - 1) * st for n, st in zip(shape, b_stride))
        buf = random_block((span + span_b,), dtype)
        return (buf.as_strided(shape, f_stride, 0),
                buf.as_strided(shape, b_stride, span))

    def rung_block(shape, stride, dtype):
        """A random block of ``shape`` with the given strides."""
        span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
        return random_block((span,), dtype).as_strided(shape, stride, 0)

    for name, edges in main_pairs.items():
        for shape, f_stride, b_stride, dtype, axis in edges:
            f, b = strided_pair(shape, f_stride, b_stride, dtype)
            edge_case(f, b, axis, f"{name}: {shape} strides {f_stride}")
            log(f"  halo_edge_pair at {name}'s edges {shape} {dtype} axis "
                f"{axis}, strides {f_stride} / {b_stride}: bit-equal")
    for name, frames in main_frames.items():
        for shape, stride, dtype, depth, layout in frames:
            frame_case(rung_block(shape, stride, dtype), depth, layout,
                       f"{name}: {shape} strides {stride}")
            log(f"  halo_frame at {name}'s block {shape} {dtype} {layout} "
                f"depth {depth}, strides {stride}: bit-equal")
    log(f"phase 16 halo_edge_pair and halo_frame vs plain: ok, "
        f"{edge_checks} and {frame_checks} cases "
        f"({time.perf_counter() - t0:.2f} s)")

    # ----------------------------------- 17. the RDMA rung on the main path
    t0 = time.perf_counter()
    rung_launches = {}

    def expect_launches(what, plan_of, steps, k, counts):
        """The frame and edge-pair launches of a run against the rounds
        times what a round of its plan makes."""
        rounds, rem = divmod(steps, k)
        want = [rounds * n for n in rung_exchanges(plan_of(k))]
        if rem:
            want = [a + b for a, b in zip(want, rung_exchanges(plan_of(rem)))]
        got = [counts["halo_frame"], counts["edge_pair"]]
        if got != want:
            raise AssertionError(f"{what}: {got} (halo_frame, edge_pair) "
                                 f"launches, the plan implies {want}")

    for name, args, kw in rung_runs:
        rsim = rung_sim(*args, steps=(1000 if args[2] == "halo" else None),
                        **kw)
        rfinal, counts = run_counted(wrappers, rsim.run)
        rung_launches[name] = counts
        if rsim.plan_note != "overlap:rdma":
            raise AssertionError(f"{name}: stamped {rsim.plan_note}")
        want = gun_serial if args[2] == "native" else oracle_1k
        check_board(f"rdma {name} vs the oracle", rfinal, want)
        check_board(f"rdma {name} vs its overlap:deferred board", rfinal,
                    deferred_boards[name])
        with_env("MOMP_HALO_RDMA", "1", lambda: expect_launches(
            f"rdma {name}", rsim._halo_plan, rsim.step_count,
            rsim.fuse_steps, counts))
        log(f"  rdma {name}: plan={rsim.plan_note} steps={rsim.step_count} "
            f"launches={counts}; board equal to the oracle, phase 5's "
            "serial board and phase 14's overlap:deferred board")

    for workload, n in rung_stencils.items():
        spec = stencils.get(workload)
        oracle_f = stencils.oracle_run(spec, rung_boards[workload], n)
        for boundary in (None, 1):
            name = f"{workload} cart 4x2 500^2 b={boundary}"
            got, counts = run_counted(
                wrappers,
                lambda: rung_stencil_run(workload, n, boundary, True))
            rplan = se.run_sharded.last_plan
            rung_launches[name] = counts
            deferred = rung_stencil_run(workload, n, boundary, False)
            dplan = se.run_sharded.last_plan
            want_stamp = "overlap:rdma" + (":pb1" if boundary else "")
            if rplan.engine != want_stamp or not dplan.engine.startswith(
                    "overlap:deferred"):
                raise AssertionError(f"{name}: stamped {rplan.engine} and "
                                     f"{dplan.engine}")
            if not torch.equal(got, deferred):
                raise AssertionError(f"{name}: the rung's board differs from "
                                     "the deferred schedule's")
            if not stencils.parity_ok(spec, got.cpu().numpy(), oracle_f,
                                      **stencils.parity_tol_for("offset")):
                raise AssertionError(f"{name}: outside parity_tol_for "
                                     "of the oracle")
            expect_launches(name, lambda k: rplan, n, 2, counts)
            err = float(np.abs(got.cpu().numpy() - oracle_f).max())
            log(f"  rdma {name}, {n} steps: plan={rplan.engine} "
                f"launches={counts}; bit-equal to {dplan.engine}, max abs "
                f"error against the oracle {err:.3g}")
    rung_totals = {k: sum(c[k] for c in rung_launches.values())
                   for k in ("halo_frame", "edge_pair")}
    if rung_totals != RUNG_LAUNCHES:
        raise AssertionError(f"the rung's runs launched {rung_totals}, not "
                             f"{RUNG_LAUNCHES}")
    log(f"  the rung's runs: {rung_totals['halo_frame']} halo_frame and "
        f"{rung_totals['edge_pair']} halo_edge_pair launches")

    psim = rung_sim("row", (2,), "bitfused", board=ovl_board, steps=1000)
    pfinal, counts = run_counted(wrappers, psim.run)
    rung_launches["bitfused row 2 1024^2 (flag set)"] = counts
    if (psim.plan_note != "window+overlap:packed" or counts["edge_pair"]
            or counts["halo_frame"]):
        raise AssertionError(f"packed plan under the flag: {psim.plan_note}, "
                             f"{counts['edge_pair']} edge_pair and "
                             f"{counts['halo_frame']} halo_frame launches")
    check_board("1024^2 row 2 under the flag vs the serial kernel", pfinal,
                serial_1k)
    log(f"  bitfused 1024^2 row 2 under MOMP_HALO_RDMA=1: plan="
        f"{psim.plan_note}, launches={counts}; board equal to the serial "
        "kernel's")
    log(f"phase 17 rdma rung main paths: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # ----------------------------------------------- 18. the rung's times
    t0 = time.perf_counter()

    def transport_record(what, kernel_name, kernel, plain, nbytes_moved,
                         **extra):
        """Device ms a call of ``kernel`` (by its kernel records) and of
        ``plain`` (all its device time) from profiler traces of 50 calls,
        CUDA events around 50 back-to-back calls beside them, and the
        byte bound."""
        kernel(), plain()  # warm-up
        k_ms = device_ms(kernel, 50, kernel_name)
        p_ms = device_ms(plain, 50)
        k_events, p_events = cuda_ms(kernel, reps=50), cuda_ms(plain, reps=50)
        bound, by = bound_ms(0, nbytes_moved)
        log(f"  {kernel_name} {what}: device time per launch {k_ms:.5f} ms, "
            f"plain {p_ms:.5f} ms (CUDA events around back-to-back calls: "
            f"{k_events:.5f}, plain {p_events:.5f}); bound {bound:.6f} ms "
            f"({by}), {bound / k_ms:.3f} of it reached [{card}]")
        return {"what": what, **extra, "ms": k_ms, "plain_ms": p_ms,
                "events_ms": k_events, "plain_events_ms": p_events,
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / k_ms}

    def edge_record(what, fwd, bwd, axis):
        # Each edge element read once and written once, both directions.
        return transport_record(
            f"{what} {tuple(fwd.shape)} {fwd.dtype} axis {axis}",
            "halo_edge_pair", lambda: nh.edge_pair(fwd, bwd, axis),
            lambda: nh.edge_pair_plain(fwd, bwd, axis),
            2 * 2 * fwd.numel() * fwd.element_size(),
            shape="x".join(map(str, fwd.shape)),
            dtype=str(fwd.dtype).replace("torch.", ""), axis=axis)

    def frame_record(what, block, depth, layout):
        # Each block element read once and each frame element written once.
        frame_bytes = (block.numel() // (block.shape[-2] * block.shape[-1])
                       * (block.shape[-2] + 2 * depth)
                       * (block.shape[-1] + 2 * depth) * block.element_size())
        return transport_record(
            f"{what} {tuple(block.shape)} {block.dtype} {layout} depth "
            f"{depth}", "halo_frame",
            lambda: nh.halo_frame(block, depth, layout),
            lambda: nh.halo_frame_plain(block, depth, layout),
            nbytes(block) + frame_bytes,
            shape="x".join(map(str, block.shape)),
            dtype=str(block.dtype).replace("torch.", ""), layout=layout,
            depth=depth)

    frame_rec = []
    for name in ("native cart 4x2", "native row 4", "heat cart 4x2 b=None",
                 "lenia cart 4x2 b=None"):
        for shape, stride, dtype, depth, layout in main_frames[name]:
            frame_rec.append(frame_record(
                name, rung_block(shape, stride, dtype), depth, layout))
    big = torch.rand((4, 2, 4096, 8192), generator=gen_e, device="cuda")
    frame_rec.append(frame_record("float32 stack", big, 32, "cart"))
    edge_rec = []
    for name in ("heat cart 4x2 b=1", "lenia cart 4x2 b=1"):
        for shape, f_stride, b_stride, dtype, axis in main_pairs[name]:
            edge_rec.append(edge_record(
                name, *strided_pair(shape, f_stride, b_stride, dtype), axis))
    for axis, (f, b) in (("y", (big[..., -32:, :], big[..., :32, :])),
                         ("x", (big[..., -32:], big[..., :32]))):
        edge_rec.append(edge_record("float32 (4, 2, 4096, 8192) depth 32",
                                    f, b, axis))
    del big
    torch.cuda.empty_cache()

    def rung_record(name, sim_, lo):
        """A profiler trace of ``lo`` steps: the frame and edge-pair
        kernels, the Life rule kernel and the rest (the rolls, slices and
        concatenations of the exchange) per step, device kernels per step
        and the idle share. A trace that kept no record (see
        :func:`device_ms`) is taken again, up to six."""
        rec = {"plan_note": sim_.plan_note}
        for attempt in range(1, 7):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t_wall = time.perf_counter()
                sim_._advance(sim_.board, lo)
                torch.cuda.synchronize()
                t_wall = time.perf_counter() - t_wall
            split = {"halo_frame": 0.0, "halo_edge_pair": 0.0,
                     "stencil_padded": 0.0, "other": 0.0}
            count = 0
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    count += 1
                    key = next((k for k in split if k in ev.name), "other")
                    split[key] += ev.time_range.elapsed_us()
            if count:
                break
            log(f"  {name}: trace {attempt} kept no device record")
        else:
            raise RuntimeError(f"{name}: the profiler saw no device kernel "
                               "in 6 traces")
        busy = sum(split.values())
        exchange = (split["halo_frame"] + split["halo_edge_pair"]
                    + split["other"])
        rec.update(frame_us_per_step=split["halo_frame"] / lo,
                   edge_pair_us_per_step=split["halo_edge_pair"] / lo,
                   rule_us_per_step=split["stencil_padded"] / lo,
                   other_us_per_step=split["other"] / lo,
                   exchange_us_per_step=exchange / lo,
                   device_kernels_per_step=count / lo,
                   idle_share=1 - busy / (t_wall * 1e6))
        return rec

    rung_rec = {}
    for name, args, kw in rung_runs:
        sims = {"rdma": rung_sim(*args, **kw),
                "deferred": sharded_sim(*args, **kw),
                "seq": without_overlap(lambda: sharded_sim(*args, **kw))}
        notes = {m: s.plan_note for m, s in sims.items()}
        if (notes["rdma"] != "overlap:rdma"
                or notes["deferred"] != "overlap:deferred"
                or notes["seq"] != "seq:halo"):
            raise AssertionError(f"{name}: schedules {notes}")
        outs = [s._advance(s.board, 200) for s in sims.values()]
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"{name}: rdma, deferred and seq differ")
        times = {m: [] for m in sims}
        for m in ("rdma", "deferred", "seq", "seq", "deferred", "rdma"):
            times[m].append(us_per_step(sims[m], 200, 1200))
        traces = {m: rung_record(f"{name} {m}", s, 200)
                  for m, s in sims.items()}
        rung_rec[name] = {"plan_note": notes, "us_per_step": times,
                          "trace": traces}
        log(f"  {name}: us/step (differenced 1200-200; run in the order "
            f"rdma, deferred, seq, seq, deferred, rdma; boards equal): "
            + "; ".join(f"{notes[m]} "
                        + ", ".join(f"{t:.4f}" for t in times[m])
                        for m in sims) + f" [{card}]")
        for m, tr in traces.items():
            log(f"    {notes[m]} profiler over 200 steps: frame "
                f"{tr['frame_us_per_step']:.4f} us/step, edge pair "
                f"{tr['edge_pair_us_per_step']:.4f}, Life rule "
                f"{tr['rule_us_per_step']:.4f}, other copies "
                f"{tr['other_us_per_step']:.4f} (exchange "
                f"{tr['exchange_us_per_step']:.4f}), "
                f"{tr['device_kernels_per_step']:.3f} device kernels per "
                f"step, idle share {tr['idle_share']:.3f} [{card}]")
    log(f"phase 18 rdma rung timings: {time.perf_counter() - t0:.2f} s")

    # ------------------------- 19. checkpoints, resume and preemption
    t0 = time.perf_counter()
    import shutil
    import signal

    from mpi_and_open_mp_tpu_torch.robust import chaos, guards, preempt
    from mpi_and_open_mp_tpu_torch.utils import checkpoint as ckl

    if guards.recovery_log() or chaos.active_plan() is not None:
        raise AssertionError(f"phases 1-18 ran with a chaos plan or recorded "
                             f"recoveries: {guards.recovery_log()}")
    ck_root = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
    shutil.rmtree(ck_root, ignore_errors=True)
    ckpt_launches = {}
    gun_cfg = load_config(GUN_BIG)

    # The CLI's preemption and resume, two processes one after the other,
    # beside this phase's in-process runs (a thread waits for them).
    cli_dir = os.path.join(ck_root, "cli")
    cli_env = dict(os.environ, PYTHONPATH=ROOT,
                   MOMP_CHAOS="preempt=5000;noguard")
    cli_cmd = [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.life",
               GUN_BIG, "--layout", "serial", "--checkpoint-dir", cli_dir,
               "--checkpoint-every", "2500", "--print-final-population"]
    cli_runs = {}

    def cli_preempt_and_resume():
        for key, extra in (("first", []), ("again", ["--resume"])):
            cli_runs[key] = subprocess.run(
                cli_cmd + extra, cwd=ROOT, env=cli_env, capture_output=True,
                text=True, timeout=300)

    import threading

    cli_thread = threading.Thread(target=cli_preempt_and_resume)
    cli_thread.start()

    def files_of(d):
        return sorted(os.listdir(d))

    def names(*steps):
        return [ckl.checkpoint_name(n) for n in steps]

    def expect_launched(what, counts, *kernels_):
        ckpt_launches[what] = counts
        idle = [k for k in kernels_ if counts[k] < 1]
        if idle:
            raise AssertionError(f"{what}: no launch of {idle} ({counts})")

    gun_dir = os.path.join(ck_root, "gun")
    csim = LifeSim(gun_cfg, layout="serial", impl="native",
                   checkpoint_dir=gun_dir, checkpoint_every=2500)
    csim.warmup()
    cfinal, counts = run_counted(wrappers, csim.run)
    what = "p46gun_big serial native, checkpoint_every 2500"
    expect_launched(what, counts, "vmem")
    if counts["vmem"] != 4 or files_of(gun_dir) != names(0, 2500, 5000,
                                                           7500):
        raise AssertionError(f"{what}: {counts['vmem']} bitlife_vmem "
                             f"launches, files {files_of(gun_dir)}")
    check_board(f"{what} vs phase 5's serial board", cfinal, gun_serial)
    half_cfg = LifeConfig(steps=5000, save_steps=0, nx=gun_cfg.nx,
                          ny=gun_cfg.ny, cells=gun_cfg.cells)
    half = LifeSim(half_cfg, layout="serial", impl="native").run()
    at_5000 = os.path.join(gun_dir, ckl.checkpoint_name(5000))
    board_5000, step_5000 = ckl.restore(at_5000)
    if step_5000 != 5000:
        raise AssertionError(f"{at_5000} holds step {step_5000}")
    check_board("the step 5000 checkpoint vs a straight 5000-step run",
                board_5000, half)
    log(f"  {what}: launches={counts}, files {files_of(gun_dir)}; board "
        "equal to phase 5's, step 5000 file equal to a straight run")

    for label, make in (
            ("bitfused cart 4x2", lambda: LifeSim.from_checkpoint(
                at_5000, gun_cfg, layout="cart", impl="bitfused",
                mesh=pm.make_mesh_2d(4, 2))),
            ("native row 4 rdma", lambda: with_env(
                "MOMP_HALO_RDMA", "1", lambda: LifeSim.from_checkpoint(
                    at_5000, gun_cfg, layout="row", impl="native",
                    mesh=pm.make_mesh_1d(4))))):
        rsim = make()
        rfinal, counts = run_counted(wrappers, rsim.run)
        what = f"step 5000 resumed on {label}"
        if label.startswith("bitfused"):
            expect_launched(what, counts, "window")
        else:
            expect_launched(what, counts, "halo_frame", "life_padded")
            if rsim.plan_note != "overlap:rdma":
                raise AssertionError(f"{what}: stamped {rsim.plan_note}")
        check_board(f"{what} vs phase 5's serial board", rfinal, gun_serial)
        log(f"  {what}: plan={rsim.plan_note} steps {rsim._initial_step}-"
            f"{rsim.step_count} launches={counts}; board equal to phase 5's")
    del csim, rsim

    soup_big = soup((10000, 10000), 7).cpu().numpy()
    big_cfg = LifeConfig(steps=1280, save_steps=0, nx=10000, ny=10000,
                         cells=np.zeros((0, 2), np.int64))
    frame_dir = os.path.join(ck_root, "frame")
    fsim = LifeSim(big_cfg, layout="serial", impl="auto",
                   initial_board=soup_big, checkpoint_dir=frame_dir,
                   checkpoint_every=256)
    inner_step, segments = fsim.step, []

    def step_then_sigterm(n=1):
        inner_step(n)
        segments.append(n)
        if len(segments) == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    def until_preempted(sim_):
        try:
            sim_.run()
        except preempt.Preempted as e:
            return e
        raise AssertionError("the run ended without its preemption")

    fsim.step = step_then_sigterm
    # A late SIGTERM must meet a no-op, not the default (process death).
    prev_term = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        stop, counts = run_counted(wrappers, lambda: until_preempted(fsim))
    finally:
        signal.signal(signal.SIGTERM, prev_term)
    what = "10000^2 frame path, checkpoint_every 256, SIGTERM"
    expect_launched(what, counts, "fused")
    if (fsim.native_path != "frame" or stop.signum != signal.SIGTERM
            or stop.step != 768 or files_of(frame_dir) != names(256, 512, 768)
            or stop.checkpoint != os.path.join(frame_dir,
                                               ckl.checkpoint_name(768))):
        raise AssertionError(f"{what}: path {fsim.native_path}, {stop!r}, "
                             f"signum {stop.signum}, files "
                             f"{files_of(frame_dir)}")
    rsim = LifeSim.from_checkpoint(stop.checkpoint, big_cfg,
                                   layout="serial", impl="auto")
    rfinal, counts2 = run_counted(wrappers, rsim.run)
    expect_launched("10000^2 frame path resumed at step 768", counts2,
                    "fused")
    straight = LifeSim(big_cfg, layout="serial", impl="auto",
                       initial_board=soup_big).run()
    check_board("the 10000^2 resume vs a straight 1280-step run", rfinal,
                straight)
    log(f"  {what}: {stop}; segments {segments}, launches={counts}, then "
        f"{counts2} resumed; files {files_of(frame_dir)}; the resume equals "
        "a straight run")
    del fsim, rsim, rfinal, straight

    cli_thread.join()
    first, again = cli_runs["first"], cli_runs["again"]
    first_err = first.stderr.strip().splitlines() or [""]
    again_err = again.stderr.strip().splitlines() or [""]
    resumed = [ln for ln in again_err if ln.startswith('{"resumed"')]
    if (first.returncode != 75 or first.stdout.strip()
            or not first_err[-1].startswith("preempted at step 5000 by chaos "
                                            "plan")
            or again.returncode != 0 or again_err[-1] != "7288"
            or resumed != ['{"resumed": "step_005000.state", "step": 5000, '
                           '"plan_source": "heuristic"}']):
        raise AssertionError(f"CLI preempt and resume: rc {first.returncode}"
                             f" {first.stderr[-1500:]!r}, then rc "
                             f"{again.returncode} {again.stderr[-1500:]!r}")
    log(f"  CLI under MOMP_CHAOS=preempt=5000;noguard: exit 75, "
        f"{first_err[-1]!r}; --resume: exit 0, {resumed[0]}, "
        f"population 7288, files {files_of(cli_dir)}")
    if guards.recovery_log():
        raise AssertionError(f"recoveries with no plan active: "
                             f"{guards.recovery_log()}")

    def rung_chaos_run(spec, guard="0"):
        """Native cart 4x2 on the rung for 1000 steps under ``spec``."""
        def run():
            chaos.reset()
            try:
                sim_ = rung_sim("cart", (4, 2), "native", steps=1000)
                out, counts_ = run_counted(wrappers, sim_.run)
            finally:
                chaos.reset()
            return sim_, out, counts_

        if not spec:
            return with_env("MOMP_GUARD", guard, run)
        return with_env("MOMP_CHAOS", spec,
                        lambda: with_env("MOMP_GUARD", guard, run))

    gsim, gfinal, counts = rung_chaos_run("", guard="1")
    what = "native cart 4x2 rung, MOMP_GUARD=1, no plan"
    expect_launched(what, counts, "halo_frame", "life_padded")
    check_board(f"{what} vs the oracle", gfinal, oracle_1k)
    if gsim.recoveries or guards.recovery_log():
        raise AssertionError(f"{what}: recovered {gsim.recoveries} with no "
                             "fault")
    log(f"  {what}: launches={counts}; no recovery, the oracle's board")
    csim, cfinal, counts = rung_chaos_run("halo=corrupt")
    what = "native cart 4x2 rung under halo=corrupt"
    expect_launched(what, counts, "halo_frame", "life_padded")
    check_board(f"{what} vs the oracle", cfinal, oracle_1k)
    stamps = guards.recovery_log()
    if (csim.plan_note != "overlap:rdma"
            or stamps != ["life_step:native:recovered"]
            or not csim.recoveries[0].startswith(stamps[0])):
        raise AssertionError(f"{what}: plan {csim.plan_note}, log {stamps}, "
                             f"recoveries {csim.recoveries}")
    log(f"  {what}: launches={counts}; {csim.recoveries[0]}; the oracle's "
        "board")
    guards.reset_recovery_log()
    dsim, dfinal, counts = rung_chaos_run("halo=drop;noguard")
    what = "native cart 4x2 rung under halo=drop;noguard"
    expect_launched(what, counts, "halo_frame", "life_padded")
    dropped = int((dfinal != oracle_1k).sum())
    if not dropped or dsim.recoveries or guards.recovery_log():
        raise AssertionError(f"{what}: {dropped} cells off the oracle, "
                             f"recoveries {dsim.recoveries}")
    log(f"  {what}: launches={counts}; {dropped} cells differ from the "
        "oracle (the fault reached the frame), no recovery")
    del gsim, csim, dsim

    for label, board in (("500^2", gun_serial), ("10000^2", soup_big)):
        path = os.path.join(ck_root, f"times_{label}.state")
        on_card = torch.from_numpy(board).cuda()
        save_s, restore_s = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ckl.save(path, on_card, 1)
            save_s.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            back = torch.from_numpy(ckl.restore(path)[0]).cuda()
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t1)
        if not torch.equal(back, on_card):
            raise AssertionError(f"{label}: the restored board differs")
        mb = board.nbytes / 1e6
        log(f"  checkpoint {label} ({mb:.2f} MB board, "
            f"{os.path.getsize(path)} file bytes): save "
            f"{', '.join(f'{t * 1e3:.3f}' for t in save_s)} ms (card to "
            f"file, fsynced), restore "
            f"{', '.join(f'{t * 1e3:.3f}' for t in restore_s)} ms (file to "
            f"card) [{card}]")
    del soup_big, on_card, back
    shutil.rmtree(ck_root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 19 checkpoints, resume and preemption: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # ------------------------------- 20. C1-C4: hello, quadrature, ping-pong
    quadrature_row = phase_c1c4(card, wrappers, cuobjdump)

    # ---------------------- 21. ring and Ulysses attention on virtual shards
    sharded_attn = phase_sharded_attention(card, wrappers)

    # ------------ 22. the sparse sharded engine on stencil_padded
    sparse = phase_sparse_sharded(card, wrappers)

    # ----------------------------------- 23. obs: traces, metrics, report
    obs_rec = phase_obs(card, wrappers)

    # ------------------------ 24. tune: plans, launch records, --plans
    tune_rec = phase_tune(card, wrappers)

    # ------------- 25. serving: the daemon's ticket path on the kernels
    serve_rec = phase_serve(card, wrappers, gun_serial, tune_rec)

    # ------------------- 26. the resident-session pool on its kernels
    pool_rec = phase_pool(card, wrappers, gun_serial)

    # ------------ 27. the serving fleet: router, workers, load, processes
    fleet_rec = phase_fleet(card, wrappers)

    # ------------------------------------------- 28. native IO: parser, VTK
    vtk_rec = phase_native_io(card, native_io, gun_serial)
    # ------------------------------------------------- 29. the graft entry
    graft_rec = phase_graft_entry(card, wrappers)
    # ------------------------------------- 30. across two processes (gloo)
    dist_rec = phase_processes(card, wrappers)
    # ------------------- 31. obs.profile and obs.ledger on the flagship
    profile_rec = phase_profile(card, gun_packed, ny, nx, n_main,
                                vmem_us_step, vmem_bound)

    kernels = [
        {"name": "bitlife_vmem", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_vmem.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:236",
         "launches": launches_gun["vmem"], "max_abs_err": float(vmem_err),
         "ms": vmem_ms, "plain_ms": plain_vmem_ms, "bound_ms": vmem_bound,
         "bound_by": vmem_by, "library_ms": None,
         "shape": "p46gun_big 500x500, 10000 steps per call",
         "us_per_step": vmem_us_step, "device_ms": vmem_dev,
         "geometry": dataclasses.asdict(gun_geo),
         "bound_ms_occupied": vmem_bound_occupied,
         "note": ("ms: CUDA events around 3 calls; device_ms: a "
                  "torch.profiler trace of 5; bound_ms_occupied: the bound "
                  "for the SMs of the launch's blocks; build: registers and "
                  "spills of each kernel from ptxas, and for p46gun_big and "
                  "a tall board the chosen geometry with the CUDA runtime's "
                  "registers, local bytes, static and dynamic shared bytes "
                  "and max active clusters"),
         "exact_cases": vmem_cases,
         "build": {"ptxas": vmem_build, "cuda_runtime": vmem_geo}},
        {"name": "bitlife_fused", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_fused.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:333",
         "launches": launches_big["fused"] + sum(
             c["fused"] for c in sharded_launches.values()),
         "max_abs_err": float(fused_err),
         "ms": fused_rec[0], "plain_ms": fused_rec[1],
         "bound_ms": fused_rec[2], "bound_by": fused_rec[3],
         "library_ms": None,
         "shape": "10000x10000 padded frame, 128 steps per launch",
         "note": ("ms: device time per launch from a torch.profiler trace "
                  "of 10 (the mean of the kernel records kept); plain_ms: "
                  "CUDA events around one call; launches: the 10000^2 "
                  "frame run of phase 5 and the sharded runs of phase 14; "
                  "build: registers and spills of each kernel from ptxas, "
                  "and for each frame of phase 3 the chosen geometry with "
                  "the CUDA runtime's registers, local bytes, static and "
                  "dynamic shared bytes and max active clusters"),
         "launches_by_run": {"frame 10000^2": launches_big["fused"],
                             **{k: c["fused"]
                                for k, c in sharded_launches.items()}},
         "us_per_step": rates, "per_shape": fused_per_shape,
         "exact_cases": fused_cases,
         "build": {"ptxas": fused_build, "cuda_runtime": fused_geo}},
        {"name": "bitlife_vmem_batch", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_vmem_batch.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:1084",
         "launches": launches_grid["vmem_batch"],
         "max_abs_err": float(batch_err["vmem_batch"]),
         "ms": vb_rec[4]["ms"], "plain_ms": vb_rec[4]["plain_ms"],
         "bound_ms": vb_rec[4]["bound_ms"], "bound_by": vb_rec[4]["bound_by"],
         "library_ms": None, "shape": vb_rec[4]["shape"],
         "us_per_step": vb_rec[4]["us_per_step"],
         "device_ms": vb_rec[4]["device_ms"],
         "geometry": vb_rec[4]["geometry"],
         "bound_ms_occupied": vb_rec[4]["bound_ms_occupied"],
         "stack_64x500x500": vb_rec[nb],
         "note": ("the main path's 4 x 500^2 stack; ms: CUDA events around "
                  "3 calls; device_ms: a torch.profiler trace of 5; "
                  "bound_ms_occupied: the bound for the SMs of the launch's "
                  "blocks; side_by_side: us a step of this kernel and "
                  "bitlife_bitsliced on the same stacks (phase 6); build: "
                  "registers and spills of each kernel from ptxas, and for 4 "
                  "and 64 boards of 500^2 the chosen geometry with the CUDA "
                  "runtime's registers, local bytes, static and dynamic "
                  "shared bytes and max active clusters"),
         "side_by_side": side_by_side,
         "exact_cases": vmem_batch_cases,
         "build": {"ptxas": vmem_batch_build, "cuda_runtime": vmem_batch_geo}},
        {"name": "bitlife_bitsliced", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_bitsliced.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:1383",
         "launches": launches_sliced["bitsliced"],
         "max_abs_err": float(batch_err["bitsliced"]),
         "ms": bs_ms, "plain_ms": plain_bs_ms, "bound_ms": bs_bound,
         "bound_by": bs_by, "library_ms": None,
         "shape": (f"{nb} x 500x500 (2 planes), 10000 steps per call in "
                   f"{rounds} launches of {plan.bands} bands x "
                   f"{plan.strips} strips a plane"),
         "us_per_step": bs_us_step, "device_ms": bs_dev,
         "geometry": dataclasses.asdict(plan),
         "bound_ms_occupied": bs_bound_occupied,
         "stepped_over_useful": bs_stepped / bs_words,
         "note": ("ms: CUDA events around 3 calls; device_ms: the union "
                  "of the kernel records' intervals in a torch.profiler "
                  "trace of 3 calls (launches overlap), over 3; "
                  "bound_ms_occupied: the bound for "
                  "the SMs of the launch's blocks; build: registers and "
                  "spills of each kernel from ptxas, and for 64 and 512 "
                  "boards of 500^2 the chosen geometry with the CUDA "
                  "runtime's registers, local bytes, static and dynamic "
                  "shared bytes and max active clusters"),
         "exact_cases": sliced_cases,
         "build": {"ptxas": sliced_build, "cuda_runtime": sliced_geo}},
        {"name": "stencil_padded", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/stencil_padded.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/pallas_life.py:373",
         "launches": (sum(stencil_launches.values())
                      + sum(sparse["launches_by_run"].values())),
         "max_abs_err": stencil_err_max,
         "ms": stencil_rec["heat"]["ms"],
         "plain_ms": stencil_rec["heat"]["plain_ms"],
         "bound_ms": stencil_rec["heat"]["bound_ms"],
         "bound_by": stencil_rec["heat"]["bound_by"],
         "library_ms": stencil_rec["heat"]["library_ms"],
         "shape": (f"heat {stencil_rec['heat']['shape']} padded stack, one "
                   "step per launch; library_ms is conv2d computing the "
                   "aggregate alone"),
         "launches_by_workload": stencil_launches,
         "launches_sparse_sharded": sparse["launches_by_run"],
         "sparse_sharded": {k: sparse[k] for k in (
             "runs", "timings", "exact_cases")},
         "per_spec": stencil_rec,
         "note": ("ms: CUDA events around 20 back-to-back launches; "
                  "device_ms: the same launches' device time from a "
                  "torch.profiler trace; fp32_issue_bound_ms: each "
                  "multiply and add one FP32 instruction (no FMA)"),
         "exact_cases": stencil_cases,
         "build": {"ptxas": stencil_build, "cuda_runtime": stencil_attrs}},
    ]
    kernels += [
        {"name": "bitlife_window", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_window.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:596",
         "launches": sum(c["window"] for c in sharded_launches.values()),
         "max_abs_err": float(window_err), "ms": window_rec[0]["ms"],
         "plain_ms": window_rec[0]["plain_ms"],
         "bound_ms": window_rec[0]["bound_ms"],
         "bound_by": window_rec[0]["bound_by"], "library_ms": None,
         "shape": (f"{window_rec[0]['what']}: {window_rec[0]['shape']} "
                   f"windows, k={window_rec[0]['k']} per launch"),
         "note": ("ms and plain_ms: device time per call from a "
                  "torch.profiler trace; bound_ms counts the interior's "
                  "words; build: registers and spills of each "
                  "bitlife_window_kernel<RT> from ptxas, and for each "
                  "main-path window the chosen geometry with the CUDA "
                  "runtime's registers, local bytes, static and dynamic "
                  "shared bytes and max active clusters"),
         "exact_cases": window_cases,
         "build": {"ptxas": window_build, "cuda_runtime": window_geo},
         "launches_by_run": {k: c["window"]
                             for k, c in sharded_launches.items()},
         "per_shape": window_rec, "runners": runner_rec,
         "overlap_vs_sequential": overlap_rec},
        {"name": "stencil_padded:life", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/stencil_padded.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/pallas_life.py:345",
         "launches": sum(c["life_padded"]
                         for c in sharded_launches.values()),
         "max_abs_err": float(life_padded_err), "ms": lp_ms,
         "plain_ms": lp_plain, "bound_ms": lp_bound, "bound_by": lp_by,
         "library_ms": lp_lib,
         "shape": ("8 x 127 x 252 uint8 (cart 4x2 shards of p46gun_big, "
                   "1-padded), one step per launch; library_ms is conv2d "
                   "computing the aggregate alone"),
         "note": ("ms, plain_ms and library_ms: device time per call from "
                  "a torch.profiler trace of 50 calls"),
         "events_ms": lp_events,
         "launches_by_run": {k: c["life_padded"]
                             for k, c in sharded_launches.items()}},
    ]
    rec = attn_rec[8]
    for name, source, replaces, bound, plain, lib in (
            ("flash_fwd", "flash_fwd.cu", "parallel/context.py:1830",
             rec["bound_fwd"], rec["plain_fwd"], rec["sdpa_fwd"]),
            ("flash_hop_dq", "flash_hop_bwd.cu", "ops/flash_hop_bwd.py:101",
             rec["bound_dq"], rec["plain_bwd"], rec["sdpa_bwd"]),
            ("flash_hop_dkv", "flash_hop_bwd.cu", "ops/flash_hop_bwd.py:125",
             rec["bound_dkv"], rec["plain_bwd"], rec["sdpa_bwd"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpi_and_open_mp_tpu_torch/csrc/{source}",
            "replaces": f"mpi_and_open_mp_tpu/{replaces}",
            "launches": attn_launches[name] + sum(
                c[name] for c in sharded_attn["launches_by_run"].values()),
            "launches_by_run": {
                "phase 11: CLI, 32k main path, gate": attn_launches[name],
                **{run: c[name] for run, c in
                   sharded_attn["launches_by_run"].items()}},
            "max_abs_err": flash_err[name], "ms": rec[name],
            "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib,
            "shape": "8 x 32768 x 128 causal bf16, equal heads",
            "gqa_8q_2kv_ms": attn_rec[2][name],
            "gqa_8q_2kv_library_ms": attn_rec[2][
                "sdpa_fwd" if name == "flash_fwd" else "sdpa_bwd"]})
        kernels[-1].update(
            tflops=rec[f"{name}_tflops"],
            bound_share=rec[f"{name}_bound_share"],
            gqa_8q_2kv_tflops=attn_rec[2][f"{name}_tflops"],
            build={label: props for label, props in flash_build.items()
                   if label.startswith(name + "_")})
    build_note = ("build: registers and spills from ptxas -v, hgmma from "
                  "cuobjdump -sass, smem_bytes (static + dynamic) from "
                  "cudaFuncGetAttributes after the kernel's launches")
    kernels[-3]["note"] = ("library_ms: scaled_dot_product_attention "
                           "forward (bf16, causal); " + build_note)
    for row in kernels[-2:]:
        row["note"] = ("plain_ms: the plain backward computing dq, dk and "
                       "dv together; library_ms: scaled_dot_product_"
                       "attention's backward, dq, dk and dv together; "
                       + build_note)
    kernels[-3]["sharded_attention_ms"] = sharded_attn["ms"]
    kernels[-3]["sharded_attention_engines"] = sharded_attn["engines"]
    kernels[-3]["sharded_attention_o_share_of_one_rounding_rule"] = (
        sharded_attn["o_share_of_one_rounding_rule"])
    kernels[-3]["ring_contiguous_device_ms_by_kernel"] = sharded_attn[
        "ring_contiguous_device_ms_by_kernel"]
    kernels[-1]["attention_32k"] = attn_line
    kernels[-1]["grad_step_kernels_ms"] = step_kernels
    main_frame = frame_rec[0]
    kernels.append({
        "name": "halo_frame", "route": "cuda",
        "source": "mpi_and_open_mp_tpu_torch/csrc/halo_frame.cu",
        "replaces": "mpi_and_open_mp_tpu/parallel/haloplan.py:286",
        "launches": rung_totals["halo_frame"],
        "max_abs_err": float(frame_err), "ms": main_frame["ms"],
        "plain_ms": main_frame["plain_ms"],
        "bound_ms": main_frame["bound_ms"],
        "bound_by": main_frame["bound_by"], "library_ms": None,
        "shape": (f"{main_frame['what']}: {main_frame['shape']} "
                  f"{main_frame['dtype']} block, {main_frame['layout']} "
                  f"frame of depth {main_frame['depth']}, one launch a "
                  "coupled round"),
        "note": ("ms and plain_ms: device time per call from a "
                 "torch.profiler trace of 50 calls; bound_ms: the block read "
                 "once and the frame written once; no single PyTorch call "
                 "computes the frame"),
        "exact_cases": frame_checks,
        "launches_by_run": {k: c["halo_frame"]
                            for k, c in rung_launches.items()},
        "per_shape": frame_rec, "rung_vs_deferred_vs_seq": rung_rec})
    main_edge = edge_rec[0]
    kernels.append({
        "name": "halo_edge_pair", "route": "cuda",
        "source": "mpi_and_open_mp_tpu_torch/csrc/halo_edge_pair.cu",
        "replaces": "mpi_and_open_mp_tpu/parallel/haloplan.py:286",
        "launches": rung_totals["edge_pair"],
        "max_abs_err": float(edge_err), "ms": main_edge["ms"],
        "plain_ms": main_edge["plain_ms"], "bound_ms": main_edge["bound_ms"],
        "bound_by": main_edge["bound_by"], "library_ms": None,
        "shape": (f"{main_edge['what']}: both directions per launch, one "
                  "launch a partitioned sub-round"),
        "note": ("ms and plain_ms: device time per call from a "
                 "torch.profiler trace of 50 calls; no single PyTorch call "
                 "computes the pair"),
        "exact_cases": edge_checks,
        "launches_by_run": {k: c["edge_pair"]
                            for k, c in rung_launches.items()},
        "per_shape": edge_rec})
    # Phase 19's runs of each kernel of its paths, beside the main path's.
    phase19_keys = {"bitlife_vmem": "vmem", "bitlife_fused": "fused",
                    "bitlife_window": "window",
                    "stencil_padded:life": "life_padded",
                    "halo_frame": "halo_frame"}
    for row in kernels:
        key = phase19_keys.get(row["name"])
        if key:
            row["launches_checkpoint_runs"] = {
                run: c[key] for run, c in ckpt_launches.items() if c[key]}
    # Phase 24's tuning passes, beside the main path's launches.
    tune_keys = {"bitlife_vmem_batch": "vmem_batch",
                 "bitlife_bitsliced": "bitsliced", "bitlife_fused": "fused",
                 "stencil_padded": "stencil"}
    for row in kernels:
        key = tune_keys.get(row["name"])
        if key:
            row["launches_tune"] = tune_rec["launches"][key]
            row["launches"] += tune_rec["launches"][key]
    # Phase 25's serving runs, beside the main path's launches.
    serve_keys = {"bitlife_vmem_batch": "vmem_batch",
                  "bitlife_bitsliced": "bitsliced",
                  "stencil_padded": "stencil"}
    for row in kernels:
        key = serve_keys.get(row["name"])
        if key:
            row["launches_serve"] = {run: c[key] for run, c in
                                     serve_rec["launches"].items()}
            row["launches"] += serve_rec["totals"][key]
    # Phase 26's pool runs: row 5's launches in them, and the pool's rows.
    for row in kernels:
        if row["name"] == "bitlife_bitsliced":
            row["launches_pool"] = {run: c["bitsliced"] for run, c in
                                    pool_rec["launches"].items()}
            row["launches"] += pool_rec["totals"]["bitsliced"]
    kernels.append(quadrature_row)
    # Row 12: the pool's masked step, the tail mode of row 5's kernel (its
    # launches are row 5's, counted there too), and the lane kernels.
    pt = pool_rec["times"]
    step_t = pt[500][f"pool_step {POOL_TIME_STEPS[0]}"]
    kernels.append({
        "name": "pool_step", "route": "cuda",
        "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_bitsliced.cu",
        "replaces": "mpi_and_open_mp_tpu/serve/pool.py:170",
        "launches": pool_rec["totals"]["pool_step"], "max_abs_err": 0.0,
        "ms": step_t["ms"], "plain_ms": step_t["plain_ms"],
        "bound_ms": step_t["bound_ms"], "bound_by": step_t["bound_by"],
        "library_ms": None,
        "shape": (f"{step_t['shape']}: bitlife_bitsliced_pool, row 5's "
                  "launches, the last in the tail mode; no Pallas kernel in "
                  "the JAX package (an XLA program)"),
        "note": ("ms: the tail mode's marginal device time, a dispatch's "
                 "(the union of its profiler records, the change word's "
                 "memset too) minus bitsliced_steps(slab, s)'s in the same "
                 "call, in turns; bound_ms: what the tail adds, the first "
                 "input read once more and 3 operations a word; plain_ms: "
                 "the whole plain dispatch, CUDA events; launches: row 5's "
                 "kernel's, in the bitlife_bitsliced row too; no single "
                 "PyTorch call computes the function"),
        "by_steps": {edge: {k: v for k, v in pt[edge].items()
                            if k.startswith("pool_step")}
                     for edge in (500, 48)},
        "dispatches": pool_rec["totals"]["dispatches"],
        "exact_cases": pool_rec["checks"]["pool_step"],
        "traces": pool_rec["checks"]["traces"],
        "launches_by_run": {run: c["pool_step"] for run, c in
                            pool_rec["launches"].items()}})
    for name, line in (("pool_lane_write", 191), ("pool_lane_read", 203)):
        main_t, small_t = pt[500][name], pt[48][name]
        way = "h2d" if name == "pool_lane_write" else "d2h"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mpi_and_open_mp_tpu_torch/csrc/pool_lanes.cu",
            "replaces": f"mpi_and_open_mp_tpu/serve/pool.py:{line}",
            "launches": pool_rec["totals"][name], "max_abs_err": 0.0,
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "host_ms": main_t["host_ms"],
            "share": main_t["share"], "bound_term": main_t["bound_term"],
            "kernel_ms": main_t["kernel_ms"],
            "link_bytes_per_s": pt["link"][f"{way}_bytes_per_s"],
            "pcie": pt["link"]["pcie"],
            "shape": (f"{main_t['shape']}, one launch an op, the board read "
                      "or written in page-locked host memory across PCIe; "
                      "no Pallas kernel in the JAX package (an XLA program)"),
            "at_48": small_t,
            "note": ("ms: the whole op's device time as the pool runs it "
                     "(serve.pool._lane_write of a pageable numpy board, "
                     "_lane_read, through a lane ring): the union of its "
                     "profiler records over 50 calls, a traced call one "
                     "kernel record and no copy; host_ms: host clock over "
                     f"{POOL_LANE_HOST_CALLS} calls, synced; kernel_ms: the "
                     "kernel's own records on a page-locked board; "
                     "bound_ms: the larger of the board (1 B a cell) over "
                     "the link at the larger of 63 GB/s and link_bytes_per_s "
                     "(a 64 MiB page-locked copy that way, CUDA events) and "
                     "the plane's HBM bytes (8 B a cell for the write, 4 for "
                     "the read) at 3.35 TB/s, bound_term the larger; "
                     "plain_ms: the plain op (the board to the card and the "
                     "plain version, or the plain version and the board "
                     "back), CUDA events over 20 calls; the parent's op: "
                     "pool_times.py; no single PyTorch call computes the "
                     "function"),
            "exact_cases": pool_rec["checks"][name],
            "launches_by_run": {run: c[name] for run, c in
                                pool_rec["launches"].items()}})
    # Phase 27's in-process fleet drills, beside the main path's launches
    # (the worker processes of its CLI drill count their own).
    fleet_keys = {"bitlife_vmem_batch": "vmem_batch",
                  "bitlife_bitsliced": "bitsliced",
                  "pool_step": "pool_step",
                  "pool_lane_write": "pool_lane_write",
                  "pool_lane_read": "pool_lane_read"}
    for row in kernels:
        key = fleet_keys.get(row["name"])
        if key:
            row["launches_fleet"] = {run: c[key] for run, c in
                                     fleet_rec["launches"].items()}
            row["launches"] += fleet_rec["totals"][key]
    # Phase 29's in-process runs (graft entry, dry run) beside the main
    # path's launches; phase 30's ranks count their own (rank 0's here).
    graft_keys = {"bitlife_vmem": "vmem", "bitlife_fused": "fused",
                  "bitlife_window": "window",
                  "stencil_padded:life": "life_padded",
                  "flash_fwd": "flash_fwd", "flash_hop_dq": "flash_hop_dq",
                  "flash_hop_dkv": "flash_hop_dkv",
                  "quadrature": "quadrature"}
    for row in kernels:
        key = graft_keys.get(row["name"])
        if key:
            row["launches_graft"] = {
                "entry": graft_rec["entry_launches"] if key == "vmem" else 0,
                "dryrun_multichip(8)": graft_rec["dryrun_launches"].get(
                    key, 0)}
            row["launches"] += sum(row["launches_graft"].values())
            row["launches_processes_rank0"] = {
                run: r["launches_rank0"].get(key, 0)
                for run, r in dist_rec["runs"].items()
                if "launches_rank0" in r}
    # Phase 30's rung across the processes: rank 0's launches in each run,
    # and the frame's times through the window beside one process's.
    for row in kernels:
        key = {"halo_frame": "halo_frame",
               "halo_edge_pair": "edge_pair"}.get(row["name"])
        if key:
            row["launches_processes_rank0"] = {
                run: r["launches_rank0"].get(key, 0)
                for run, r in dist_rec["runs"].items()
                if "launches_rank0" in r}
        if key == "halo_frame":
            row["rung_across_processes"] = dist_rec["rung_times"]
    log(f"native IO, host ms a snapshot: {json.dumps(vtk_rec)}")
    log(f"processes: {json.dumps(dist_rec['runs'])}; pingpong "
        f"{json.dumps(dist_rec['pingpong_fit'])}")
    log(f"obs, untraced against traced seconds: "
        f"{json.dumps(obs_rec['untraced_vs_traced_s'])}")
    log(f"tune: {json.dumps({k: {'tuned': v['tuned']['path'], 'vs_heuristic': v['vs_heuristic']} for k, v in tune_rec['passes'].items()})}; "
        f"CLI {json.dumps(tune_rec['cli'])}")
    log(f"serve: {json.dumps(serve_rec['runs'])}")
    log(f"pool: {json.dumps(pool_rec['runs'])}")
    log(f"fleet: {json.dumps(fleet_rec['runs'])}")
    log(f"profile: {json.dumps(profile_rec)}")
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s")
    print(json.dumps({"phase_seconds": phase_seconds(t_start),
                      "total_s": round(total, 2)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
