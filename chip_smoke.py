#!/usr/bin/env python3
'''Smoke run of the PyTorch / CUDA port (newtonnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (the run stops at the first failure,
with a non-zero exit code and no result line):

1. env      the card, its power limit (nvidia-smi), torch / CUDA versions;
            TF32 off for matmuls and cuDNN.
2. build    nvcc builds every kernel source of the package (sm_90a), K1-K8's
            once per width of BUILD_WIDTHS, all at once; ptxas registers,
            spills and shared memory per library and kernel.
3. kernels  K1/K2 against their plain PyTorch versions on the card, at the
            batched serving shape (B=100, N=21, F=128, R=20), at one
            calculator request (B=1, N=24), at (B=2, N=70, F=64, R=16) and
            ragged at (B=3, N=37, F=32, R=12), with and without weight
            cotangents; bar: max|kernel - plain| <= 1e-4 * max|plain| per
            output (K1 and K2 on the tensor cores in 3xTF32 hold the same
            bar); three K2 launches and three K1 launches at the serving
            shape give equal bits.
   dual     K3/K4 against theirs at the training shape (B=10, N=24, F=128,
            R=20), at one molecule (B=1, N=24), at (B=2, N=70, F=64,
            R=16) and ragged at (B=3, N=37, F=32, R=12), both variants;
            fp32 mode (3xTF32 tensor cores) at the same 1e-4 bar, bf16
            mode (bf16 tensor cores) at DUAL_BF16_BAR (see there); three
            K4 launches at the training shape give equal bits, both modes
            and variants.
   klist    K5-K8 (K6 with and without weight cotangents) against theirs,
            both variants, at the large box's shape (B=1, N=4096, K=88,
            F=128, R=20, bf16 edges), at (B=100, N=21, K=20) and at (B=2,
            N=70, K=37, F=64, R=16) in fp32, and ragged at (B=3, N=61,
            K=39, F=32, R=12) in bf16; bar 1e-4 of each output's largest
            magnitude, plus one bf16 ulp for bf16-stored outputs (K5-K8
            on the tensor cores in 3xTF32 hold the same bar); three K5
            launches, three K7 launches and three K6 launches (with and
            without weight cotangents) at the box shape give equal bits.
3e. gather  K9 (row_gather) against the plain row gather, bitwise, at the
            box's inv_gather shapes (bf16, fp32; 4F, F and positions), its
            scatter-chunk shape, the aspirin shapes and odd widths; K12
            (K9 at B=1) at tools/exp_pallas_gather.py's shape; K10 bitwise
            and K11 within 1e-6 of the largest magnitude plus one ulp of
            the output dtype, at tools/bench_window.py's shape on the
            cell-sorted box (the full list, the smallest passing W);
            three K11 launches there give equal bits; the transposition
            identity in float64; the window ops' entry point (gather, and
            its backward through autograd: K11).
4. serve    the trained MD17-aspirin checkpoint serves all 500 test frames
            in batches of 100 through the kernels; energy and force errors
            against the labels must reproduce the JAX package's (energy MAE
            0.007094 +- 5e-4 eV, force MAE 0.022353 +- 5e-5 eV/A); the same
            batches through the plain path on the card must agree (energy
            atol 2e-2 eV: one float32 ulp at -17,600 eV is 0.002 eV; forces
            atol 1e-4 eV/A).
5. requests 20 single-molecule calculator calls (energy, forces, stress,
            virial), 10 aperiodic and 10 in a 30 A periodic box; they must
            match phase 4 at the same tolerances.
   tf32     one request with both TF32 flags switched on gives the bits
            of one with them off (the calculator pins fp32 products); the
            same for one XLA box request in 5c.
   profile  one batch and one request under torch.profiler: device busy
            time, idle share, the fused kernels' share, the top kernels.
4b. serve-nlist  the same 500 frames through the checkpoint in
            neighbour-list mode (K5/K6, fp32 edges, K=20): the JAX MAE bars,
            phase 4's dense numbers at the same tolerances, no overflow.
5b. box     calculator requests (energy, forces, stress) on the
            4096-atom periodic box of tools/bench_train_large.py (k_max 88,
            bf16 edges, box_weights): against the plain path on the card,
            and on the 512-atom box against the JAX package's numbers, at
            bars of BOX_SPREAD_FACTOR times the bf16-to-fp32-edge spread;
            three requests give forces of equal bits (gather_nodes'
            fixed-order backward); request latency; then one request under
            torch.profiler with the gather backward's device time beside
            the 13.2 ms of the atomic scatter-add it replaced.
7. train    fine-tuning from the checkpoint with scripts/config_md17_pallas.yml
            (F=128, R=20, 3 interactions, energy + 50 x force mse, Adam
            1e-3, clip 1.0, plateau, batch 10, bf16 duals):
            a. the first 10 steps, loss and gradient norm against the JAX
               package's (JAX_STEP_LOSS / JAX_STEP_GRAD_NORM);
            b. the first step through the plain path on the card: the same
               gradients within DUAL_BF16_BAR;
            c. one whole epoch through the training CLI's entry point (95
               steps, val, test, final re-evaluation): log.csv has the JAX
               package's columns with finite values, best_model.msgpack
               reloads and reproduces the logged test metrics, and every
               K1-K4 variant ran, K2 never with weight cotangents.
   profile  one training step under torch.profiler: its host-clock
            median, device busy time and idle share, split into K1, K2,
            K3 and K4 (each with its reductions and weight preparation)
            and the rest.
7d. train-nlist  the same fine-tuning in neighbour-list mode (K5-K8):
            a. 10 steps against the JAX package's (JAX_NLIST_STEP_*), PR 2's
               bars; b. step 1's gradient against the dense port path with
               fp32 duals (the same function); c. one epoch of 10 steps
               (train_size 100) through train_from_settings.
7e. box-train  three fastgrad steps with Adam on the box, step 1 against
            the plain path on the card (2e-3 relative norm); three
            gradients from one start with equal bits; one step under
            torch.profiler, split into K8, K7 (with its weight
            preparation), K6, K5, the gather backward and the rest.
4c. serve-xla  the trained kernel='xla' checkpoint (artifacts/md17_model)
            on the 500 frames, dense and over inverse lists (k_max 48,
            host_symmetric_nlist; K9): the JAX package's MAE bars, the
            dense path at E_ATOL / F_ATOL, the plain row gather bitwise;
            20 calculator requests over inverse lists against the batches.
5c. box-xla calculator requests on the 4096-atom box over inverse lists
            (k_max 88, bf16 stack, box_weights): the plain row gather
            bitwise, three requests repeating their bits, its float32
            request against the K-list path of 5b, its bf16 request
            against its float32 one (BOX_BF16_VS_FP32, with a control
            that must fail it); the bf16 stack on the C11 boxes (256 and
            512 atoms) against the JAX package's bf16 program (C11_BARS,
            in units of that program's own bf16-to-fp32 shift, the
            float32 model as a control that must fail them), both shifts
            printed; the 512-atom float32 request against the JAX package;
            latency, host list build (the C++ slot coloring of
            csrc/host/symslots.cpp, beside the 1050 ms the numpy loop
            took on this request), model evaluation, and a profile with
            K9's share and launches beside the K-list request's time.
7f. train-xla  fine-tuning the kernel='xla' checkpoint with its own
            config, artifacts/md17_model/config.yml (F=128, R=20, 3
            interactions, energy + 50 x force mse, Adam 1e-3, clip 1.0,
            batch 10): a. the first 10 steps by the standard step
            (reverse over reverse: fast_grad 'auto', as the JAX Trainer
            resolves it) and b. by fastgrad (reverse over forward,
            fast_grad True), each against the JAX package's
            (JAX_XLA_STEP_*) at phase 7a's bars, step 1's gradients of
            the two at 1e-4 relative norm; c. one epoch through the CLI's entry
            point (95 steps, val, test, re-evaluation) with the JAX
            columns and a best model that reproduces its test metrics;
            then one step under torch.profiler.
7g. train-xla-nlist  the same with graph_mode neighborlist, k_max 48:
            10 standard steps against JAX_XLA_NLIST_STEP_*, step 1's
            gradient against 7f's dense one, K9 launched (gather_nodes'
            fixed-order backward in every derivative order), three step-1
            gradients with equal bits.
7h. box-train-xla  the standard step on the 4096-atom box (bf16 stack,
            box_weights) with an energy + force + stress loss
            (BOX_XLA_LOSS), three steps over plain lists and three over
            inverse lists (K9 in every derivative order): step 1 against
            the plain row gather (equal bits) and against plain lists
            (2e-3), three gradients with equal bits, fastgrad against its
            plain row gather (equal bits) and the standard step (energy +
            force, 2e-3), and at 512 atoms step 1's loss and gradient norm
            against the JAX package's (JAX_XLA_BOX_STEP_*; bf16 at
            C11_STEP_SHIFTS times the JAX package's bf16-to-fp32 shift
            plus the float32 bar, float32 at 1e-4); one step per
            list layout under torch.profiler (K9, the gather backward,
            the rest).
8a. newton3-serve  the trained newton3 checkpoint (artifacts/
            lj_liquid_newton3: F=48, 2 interactions, k_max 16) on a
            64-atom LJ box built with numpy (lj_box) against the JAX
            package's calculator (JAX_LJ_N3_*); the 4096-atom box with
            newton3 (half-list capacity 48) in float32 against 5c's
            float32 inverse-list request, the plain row gather bitwise,
            requests repeating their bits; K9 launches per request and in
            the forward alone (the mirror sums).
8b. newton3-train  LJ_CONFIG (prefetch 0) on numpy LJ frames through
            data.precompute_nlist mode newton3: 10 fine-tuning steps of
            the checkpoint against the JAX package's (JAX_LJ_STEP_*),
            step 1's gradient against full inverse lists (1e-4), one
            epoch through the CLI's entry point.
8c. revlist-cellgrid  the 4096-atom box over reverse lists and over the
            cell grid (float32) against 5c's float32 request; the grid's
            list against neighbor_list's as an edge set; both builders'
            times.
8d. staircase  the 4096-atom box with newton3_compact over staircase
            chunks against 8a's newton3 request; a compact checkpoint
            through the calculator (swapped to newton3) equal to 8a's
            request bit for bit; the staircase's host build and slot rows.
8e. c11     the bf16 numbers of 5c and 7h in units of the JAX shift.
9a. widths  K1-K8 at F = 16, 20, 48, 96 and 256 (WIDTHS_9A; their
            libraries built with the others, BUILD_WIDTHS) against their plain
            versions at small ragged shapes, both variants, K2/K6 with and
            without weight cotangents, K3/K4 in both dot modes, fp32 and
            bf16 edges; phase 3's bars; second launches repeat their bits.
9b. lj-pallas  the LJ checkpoint overridden to kernel='pallas' (LJ_PALLAS)
            at its width F=48 through the calculator, dense (K1/K2) and
            over plain K-lists (K5/K6), against the JAX package's numbers
            (JAX_LJ_PALLAS_*) and its own XLA newton3 request (8a's), at
            1e-5 of the energy and 1e-4 of the largest force.
9c. lj-pallas-train  LJ_CONFIG's fine-tuning of it, 10 steps dense (K1-K4,
            bf16 duals) and over plain precomputed lists (K5-K8) against
            the JAX package's (JAX_LJ_PALLAS_STEP_*; step 1's gradient
            norm at 2e-3 with bf16 duals), the K-list step 1 against the
            dense one with fp32 duals (1e-4), one K-list CLI epoch.
9d. widths timing  K1-K8 at F = 48, 64 and 256 (WIDTHS_9D): K1-K4 at
            LJ_CONFIG's training shape (B=12, N=64, R=16), K5-K8 at the
            box shape; bounds on the work at the true width; each timed
            call's outputs against its plain version's at phase 3's bars
            (at F=256 the box shape walks several atom tiles per block).
6. timing   each kernel variant's launches on its main path, its time and
            its plain version's (CUDA events, median of 7 reps), and the
            least time the card could take: K1/K2 at the batched serving
            shape (fp32 bound and 3xTF32 tensor-core bound, and their
            time, device time, bounds and launches at the training shape
            B=10, N=24), K3/K4 at the training shape in bf16 mode
            (the training path's; bf16 tensor-core bound) and in fp32 mode
            (fp32 bound, and the 3xTF32 tensor-core bound);
            K5-K8 at the box shape (bf16 edges, fp32 bound, klist_work, and
            their 3xTF32 tensor-core bound; K5 and K6 their launches in
            the list-mode training epoch);
            K9 (box inv_gather and scatter-chunk shapes), K12, K10 and K11
            with one PyTorch call's time beside them (index_select,
            index_add_), bound by bytes; K9 and K12 also with their
            launches on the XLA training paths (7g, 7h).

10. bf16  the Pallas pair kernels' bf16 mode (pallas_dot_dtype bfloat16)
            in K1/K2 and K5/K6 (their bf16 libraries, BF16_WIDTHS, built
            with the others), TF32 off:
            a. K1/K2 and K5/K6 in bf16 mode against their plain bf16
               versions at F = 20, 48, 128, 256, full and first layer,
               K2/K6 with and without weight cotangents: K1/K2 at phase
               3's ragged shape and the aspirin serving shape, K5/K6 at
               phase 3's ragged shape, the serving shape and the box's,
               with fp32 and bf16 edges; each output within DUAL_BF16_BAR
               of its largest magnitude and its median element error
               within BF16_MEDIAN_BAR of it; second launches repeat their
               bits.
            b. the aspirin checkpoint with pallas_dot_dtype bfloat16: the
               first 50 test frames against the JAX package's bf16 numbers
               (JAX_BF16_ASPIRIN_*) at BF16_SPREAD_FACTOR times its own
               bf16-to-fp32 spread; all 500 frames (every K1/K2 bf16
               variant launched, nothing else) with their MAEs beside the
               fp32 model's; one batch timed beside the fp32 model's.
            c. the LJ checkpoint as a kernel='pallas' bf16 model (F=48)
               through the calculator, dense and over K-lists with fp32
               and bf16 edges, against JAX_BF16_LJ_* at the same factor.
            d. the 4096-atom box request over K-lists in bf16 (bf16
               edges, box_weights, F=128) against the port's plain bf16
               model on the card at 10a's bars, timed beside the fp32-dot
               request.
            e. K1/K2 at the serving shape and K5/K6 at the box shape in
               bf16 mode beside fp32 mode, with their plain bf16 versions'
               times, bounds at the bf16 peak and phase 10's launches (the
               `kernels` line's bf16 rows).

11. bf16-train  the K-list duals K7/K8 in bf16 mode and fine-tuning
            kernel='pallas', pallas_dot_dtype bfloat16 models (TF32 off):
            a. K7/K8 in bf16 mode against their plain bf16 versions at
               F = 20, 48, 128, 256 (BF16_WIDTHS), full and first layer,
               at phase 3's ragged shape, the aspirin K-list training
               shape (B=10, N=24, K=48) and the box's, fp32 and bf16
               edges: 10a's bars (the float64 floor of the median bar for
               the weight cotangents alone; K8's other outputs held and
               printed apart, at BF16_MEDIAN_BAR); second launches repeat
               their bits.
            b. the aspirin checkpoint fine-tuned by
               scripts/config_md17_pallas.yml with pallas_dot_dtype
               bfloat16: 10 steps dense and 10 over K-lists (k_max 48)
               against the JAX package's bf16 steps
               (JAX_BF16_ASPIRIN_STEP_*; check_bf16_steps: each quantity
               within BF16_SPREAD_FACTOR times the JAX package's own
               bf16-to-fp32 shift, PR 2's fp32 bars the floor); the
               K-list step 1 gradient within BF16_KLIST_VS_DENSE of the
               dense one; one dense CLI epoch.
            c. the LJ checkpoint as a kernel='pallas' bf16 model (F=48):
               10 steps of LJ_CONFIG dense and over K-lists with fp32 and
               bf16 edges against JAX_BF16_LJ_STEP_*; the K-list step 1
               gradients within BF16_LJ_KLIST_FACTOR times the JAX
               package's own distance from the dense one, a control (the
               fp32-product dense step) failing that bar; one K-list CLI
               epoch.
            d. three box steps in bf16 (bf16 edges, box_weights, F=128):
               step 1 against the plain bf16 step at 2e-3, three
               gradients with equal bits, the step timed beside the
               fp32-product step with device busy time and K8's share.
            e. K7/K8 in bf16 mode beside fp32 mode at the box shape (and
               F=48), their plain bf16 versions' times, bounds at the
               bf16 peak, phase 11's launches (the kernels line's
               klist_dual_*_bf16 rows, K7 bf16 and K8 bf16).

12. data  the data pipeline on the repo's heterogeneous config,
            artifacts/lj_hetero_model's config_lj_hetero.yml (F=64, 3
            interactions, cutoff 7, bucketed batches of 20 LJ clusters of
            6-38 atoms, an XLA model), over a copy of data/lj_hetero:
            a. the bucket sequence of the first 10 batches against the JAX
               loader's (JAX_LJ_HETERO_N_PAD); 10 training steps of the
               checkpoint that config trained against the JAX package's
               (JAX_LJ_HETERO_STEP_*, PR 2's bars).
            b. K1-K4 against their plain versions at every bucket's shape
               (B=20, N = 8..40, F=64, R=20); the checkpoint with a
               kernel='pallas' override trained by fastgrad over the whole
               epoch: K1-K4 launched at every bucket size, step 1's
               gradient within 2e-3 of 12a's.
            c. one CLI epoch with the kernel='pallas' override,
               in_memory 'sharded' (shards of 64 frames): locality_block
               'auto' with prefetch 2 and 0, and 0 with prefetch 2; the
               epoch seconds, steps/s and shard_loads; the sharded,
               prefetched epoch's batches equal to the in-memory one's.

13. charge  charge heads (kernel='xla'), the latent Ewald energy and Born
            effective charges (BEC), each charge head from charge_head_tree
            (numpy, CHARGE_SEED), held to the JAX package's numbers in
            CHARGE_REF:
            a. the trained aspirin checkpoint (XLA_CKPT) with a charge head
               and BEC (ewald_mode 'auto') serves the 500 test frames in
               batches of 100; the first 8 frames' energies (E_ATOL),
               forces, charges (CHARGE_BAR) and BEC (CHARGE_BAR of its
               largest magnitude) against the JAX package's; 20
               calculator requests resolved 'auto -> aperiodic' against
               the batches; the device time of the Ewald term and of the
               BEC's reverse passes as shares of a batch's.
            b. the box model (box_weights, F=128) with a charge head over
               newton3 half lists (BOX_N3_K_MAX) through the calculator,
               'auto -> periodic': at BOX_REF_ATOMS energy, forces,
               stress and charges against the JAX calculator's (phase
               8a's bars); at BOX_ATOMS with bec, K9 and K12 launched,
               the plain row gather giving the same bits, every output
               finite, the acoustic sum rule sum_i Z*_i = (sum_i q_i) I
               at SUM_RULE_BAR with a control that fails it, and the
               request times with and without bec.
            c. the newton3 LJ checkpoint (F=48) with a charge head: 4
               frames' BEC and charges against the JAX package's; 10
               standard fine-tuning steps of the charged checkpoint (the
               port writes it) over LJ_CONFIG's newton3 lists against
               the JAX package's (JAX_LJ_CHARGE_STEP_*, phase 8b's bars),
               the Trainer printing 'ewald_mode: auto -> periodic (from
               the first training batch)'; fast_grad's step 1 against the
               standard one at FASTGRAD_CHARGE_BAR, and fastgrad without
               E_lr as a control that misses it.

14. hessian  the Hessian head (forward over reverse, hessian_block
            lanes folded into K9's batch), the direct-force head and
            calculator ensembles (kernel='xla'), held to the JAX package's
            numbers in HESSIAN_REF:
            a. the aspirin checkpoint (XLA_CKPT) through the calculator
               with HESSIAN_PROPS: the first HESSIAN_FRAMES test frames'
               Hessians against the JAX calculator's float32 ones at
               hessian_bar (HESSIAN_SPREAD_FACTOR times the JAX package's
               own float32-to-float64 spread), their symmetry at that bar,
               frame 0's mass-weighted eigenvalues against the JAX float64
               ones (Weyl: HESSIAN_SPREAD_FACTOR times the spectral norm
               of the JAX float32 error); hessian_block=16 (63 lanes, the
               last block ragged) against the unblocked Hessian.
            b. the newton3 LJ checkpoint (F=48) on lj_box(LJ_HESSIAN_ATOMS)
               through the calculator with hessian_block in
               LJ_HESSIAN_BLOCKS: 9 columns (atoms LJ_HESSIAN_ATOMS_PICKED)
               against the JAX package's HVPs at 14a's kind of bar; the
               plain row gather giving the same bits; K9's folded launches
               per request growing with the blocks (twice the blocks, twice
               the launches); the translational sum rule sum_j H[i,a,j,b]
               = 0 at HESSIAN_SUM_BAR of max |H|, with a control (one
               block's lanes shifted by one, a slicing fault) that fails
               it; request time and peak memory per block size, and
               unblocked where the blocked peaks say it fits; one
               request (and one of 14a's) under torch.profiler.
            c. the aspirin checkpoint with direct_force_tree's head
               (DIRECT_SEED): the first DIRECT_FRAMES frames' direct forces
               against the JAX package's at CHARGE_BAR; 10 standard
               fine-tuning steps (energy + gradient_force + direct_force
               losses, DIRECT_LOSS) against JAX_DIRECT_STEP_* (phase 13c's
               bars); fast_grad True refused as the JAX Trainer refuses it.
            d. the ensemble ENSEMBLE_CKPTS through the calculator:
               ENSEMBLE_REQUESTS requests' energies and forces against the
               JAX ensemble calculator's (E_ATOL / F_ATOL); the ensemble's
               energy and force MAE over the first ENSEMBLE_MAE_FRAMES
               test frames against the JAX ensemble's, at those bars.

15. md  molecular dynamics (md/driver.py, md/simulate.py), each trajectory
            on the card from first step to last:
            a. (in a process of its own, `python3 chip_smoke.py
               md-aspirin`, beside 15b and 15c) XLA_CKPT's MD_REPLICAS
               replicas of the record MD_LOG's run (frame 0 at rest, 300 K,
               0.5 fs, friction 1/(500 fs)) for MD_ASPIRIN_STEPS steps
               through run_langevin_on_device: mean
               T and Epot over MD_WINDOW within MD_T_BAR / MD_EPOT_BAR of
               the record's 2-10 ps means, both standard errors printed,
               the 0-0.5 ps control failing the T bar; host syncs per
               step (torch.cuda.set_sync_debug_mode); `python -m
               newtonnet_tpu_torch.md.simulate --on-device` writing an
               md.log in the record's format.
            b. CKPT (K1/K2) through run_nhc_on_device, 8 replicas, 1000
               steps at 300 K: the conserved quantity's drift within
               MD_DRIFT_BAR, a 2 fs control missing it; K1/K2 launches
               per step; peak memory after 1000 steps equal to that after
               10; 20 friction-0 steps on the card within MD_TRAJ_BAR of
               the same run with the model on the CPU (plain versions).
            c. LJ_CKPT on lj_box(512) (lj_md_start): MD_LJ's 20 NVE steps
               over newton3 host rebuilds (K9/K12), the staircase (host
               rebuilds with re-sorts) and a kernel='pallas' K-list model
               (K5/K6, on-device cell-grid rebuilds), each within
               MD_LJ_BAR of the JAX package's newton3 run (MD_LJ_REF),
               both counters 0, launches per step.
            d. tools/demo_large_md.py's 4096-atom box (F=128, bf16 stack)
               over newton3 and staircase half lists: steps/s, host
               rebuild ms, the device's busy share over one chunk, K9/K12
               launches and host syncs per step, both counters 0.
16. export  serving artifacts (utils/export.py) captured on the card and
            replayed in a fresh process (`chip_smoke.py replay`) that
            imports no model module: a. the aspirin pallas checkpoint
            dense (batch 100 and 1; K1/K2), b. over K-lists (K5/K6), both
            within phase 4's MAE bars and E_ATOL / F_ATOL of the eager
            batches, launches per call equal to the eager batch's; c. the
            XLA checkpoint as a newton3 model and the LJ newton3
            checkpoint through the plain list (K9/K12), periodic requests
            against the eager newton3 calculator at 1e-5 / 1e-4, no host
            sync per call; d. the aspirin Hessian over the plain list
            against the eager calculator's and JAX's at 14a's bar; a JAX
            artifact and a request past n_pad refused; request latency
            beside the eager path's; the plain-list transpose's overflow
            path (ROADMAP.md C17): its transient bytes per call of each
            list artifact, and b's artifact against one exported without
            it, replayed alternately (the same bits, ms and peak memory
            per call). `python3 chip_smoke.py export` runs it alone.

17. parallel  ranks as processes on this card, started by
            newtonnet_tpu_torch/parallel/launch.py (gloo: ranks that share
            a card cannot use NCCL, so their collectives cross through
            host memory; NCCL, NVLink and scaling across cards are not
            exercised here, and no time of this phase is a scaling
            result). `python3 chip_smoke.py parallel` runs it alone.
            a. CKPT fine-tuned over PAR_STEPS global batches of 10 (5 per
               rank, 2 ranks, training.parallel {data: 2}), dense (K1-K4
               on each rank) and over K-lists (K5-K8), against this
               process's one-rank run on the same batches, with SGD and
               with the CLI's Adam (PAR_OPTIMIZERS): step 1's loss within
               one float32 ulp of every energy (phase 7a's bar); every
               step bit for bit the ranks' arithmetic run in this process
               (par_halves); with SGD, step 1's gradient within
               PAR_GRAD_BAR (relative norm) and steps 2-10 within
               PAR_LOSS_BAR, and a rank's gradient without the all-reduce
               (the control) must miss the gradient bar; with Adam, the
               ranks' and the halves' drift from the whole batch
               reported; every K1-K8 kernel launched on every rank. One
               CLI epoch (SGD) at
               PAR_CLI_DATA's sizes, data 2 against data 1: log.csv within
               PAR_LOG_REL, one training_1 directory. Steps/s, step ms,
               launches, collectives and host syncs per rank per step.
            b. XLA_CKPT graph-parallel at (data, graph) = (1, 2)
               (parallel/graph_parallel.py): the 500 aspirin frames within
               phase 5's MAE bars; a CLUSTER_ATOMS-atom aperiodic cluster
               (cluster_frame, seeded weights) whose one-process request
               peaks above CLUSTER_PEAK_GIB, at (1, 2) and at (2, 2) with a
               second cluster, against the one-process requests at
               CLUSTER_E_REL of the energy and CLUSTER_F_REL of the largest
               force; peak memory per rank beside the one process's.

18. halo   halo-exchange graph parallelism (parallel/halo.py): ranks as
            processes on this card, started by parallel/launch.py (gloo,
            as phase 17's: NCCL, NVLink and scaling across cards are not
            exercised here, and no time of this phase is a scaling
            result); the large box (box_system, 0.1 atoms per cubic A;
            F=128, R=20, 3 interactions, cutoff 5 A, k_max 88,
            box_weights) in x-sorted slabs. `python3 chip_smoke.py halo`
            runs it alone.
            a. 4096 atoms at (data, graph) = (1, 2) and (1, 4), n_halo
               HALO_N: energy, forces and stress against the one-process
               request at HALO_E_REL / HALO_F_REL / HALO_S_REL; the charge
               head (ewald_mode 'periodic', the sharded Ewald sum) against
               the one-process charged request; K9 launches per rank per
               request, every exchange 2 n_halo rows (collectives.STATS),
               ms per request (median of HALO_REPS), and the ms inside
               the exchanges and collectives (host-staged, the peers'
               waits included).
            b. HALO_BIG_ATOMS atoms at (1, 4) (HALO_SMALL_ATOMS when the
               ranks' memory, reckoned before the launch from the
               one-process request's peak, would not fit): each rank's
               peak memory beside the one-process request's, the same
               bars.
            c. HALO_STEPS steps with the CLI's Adam at (1, 2) on a
               4096-atom frame, energy + force and energy + force + stress
               losses, against the one-process standard steps: step 1's
               loss (HALO_LOSS_REL) and gradient (HALO_GRAD_REL), steps
               2-3 (HALO_STEPS_REL); one CLI epoch with training.parallel
               {data: 1, graph: 2}, training.halo and data.spatial_sort
               over write_box_dataset's frames against the same epoch in
               one process (log.csv within HALO_CLI_REL).
            d. run_md_halo on md_box's system (weights x 0.1) at (1, 2),
               n_halo HALO_MD_N: NVE, HALO_MD_STEPS steps re-sorted every
               HALO_MD_EVERY, against the host loop's velocity Verlet
               (md/integrators.py) over the calculator (positions within
               HALO_MD_POS_ATOL, energies HALO_MD_EPOT_PER_ATOM per atom);
               a Langevin chunk; skin_violations; an undersized n_halo
               raises.

Then the card's nvidia-smi line, the `kernels` JSON line (K1-K8 rows with
their times, bounds and errors at the 9d widths, 9a's errors and their
9b/9c launches, K1-K4's phase 12 launches, K9/K12's phase 13 and 14
launches and K9 at phase 14's folded Hessian shape; K1/K2, K5/K6 and
K9/K12 with their launches per MD step of phase 15 and per replayed
call of phase 16; K1-K8 with their launches per rank per
data-parallel step of phase 17a; K9/K12 with their launches per rank of
phase 18; the bf16 rows of K1/K2 and K5-K8) and,
last,
{"ok": true, "device": {...}}.
'''
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, 'artifacts', 'md17_model_pallas',
                    'best_model.msgpack')
XYZ = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
                   'aspirin_ccsd-test.xyz')
XYZ_TRAIN = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_train', 'raw',
                         'aspirin_ccsd-train.xyz')
JAX_ENERGY_MAE, JAX_FORCE_MAE = 0.007094, 0.022353  # JAX package, CPU
E_ATOL, F_ATOL = 2e-2, 1e-4
KERNEL_BAR = 1e-4
# K3/K4 in bf16 mode against their plain versions: both round the same
# operands to bf16 and sum in fp32, but a one-ulp fp32 difference of a sum
# can flip the bf16 rounding of a later operand (2^-8 relative), which
# moves an output by a few 1e-4 of its largest magnitude (the dual phase
# prints the measured worst case); held at 2e-3, ten times tighter than
# the JAX package's own bf16 bar of 2e-2 relative norm
# (tests/test_pallas_stack.py:240).
DUAL_BF16_BAR = 2e-3
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, bf16 and tf32
# tensor cores (dense), HBM3 rate
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_TF32_FLOPS = 67e12, 989e12, 495e12
PEAK_BYTES_PER_S = 3.35e12
SOURCES = {'pair': 'newtonnet_tpu_torch/csrc/fused_dense.cu',
           'dual': 'newtonnet_tpu_torch/csrc/fused_dual.cu',
           'klist': 'newtonnet_tpu_torch/csrc/fused_klist.cu',
           'gather': 'newtonnet_tpu_torch/csrc/row_gather.cu',
           'window': 'newtonnet_tpu_torch/csrc/window.cu'}
REPLACES = {'pair_fwd': 'newtonnet_tpu/ops/pallas_dense.py:78',
            'pair_fwd_first': 'newtonnet_tpu/ops/pallas_dense.py:78',
            'pair_bwd': 'newtonnet_tpu/ops/pallas_dense.py:102',
            'pair_bwd_first': 'newtonnet_tpu/ops/pallas_dense.py:102',
            'dual_fwd': 'newtonnet_tpu/ops/pallas_dense.py:299',
            'dual_fwd_first': 'newtonnet_tpu/ops/pallas_dense.py:299',
            'dual_bwd': 'newtonnet_tpu/ops/pallas_dense.py:334',
            'dual_bwd_first': 'newtonnet_tpu/ops/pallas_dense.py:334',
            'klist_fwd': 'newtonnet_tpu/ops/pallas_klist.py:131',
            'klist_fwd_first': 'newtonnet_tpu/ops/pallas_klist.py:131',
            'klist_bwd': 'newtonnet_tpu/ops/pallas_klist.py:155',
            'klist_bwd_first': 'newtonnet_tpu/ops/pallas_klist.py:155',
            'klist_dual_fwd': 'newtonnet_tpu/ops/pallas_klist.py:253',
            'klist_dual_fwd_first': 'newtonnet_tpu/ops/pallas_klist.py:253',
            'klist_dual_bwd': 'newtonnet_tpu/ops/pallas_klist.py:288',
            'klist_dual_bwd_first': 'newtonnet_tpu/ops/pallas_klist.py:288',
            'row_gather': 'newtonnet_tpu/ops/pallas_gather.py:106',
            'row_gather_chunk': 'newtonnet_tpu/ops/pallas_gather.py:106',
            'window_gather': 'newtonnet_tpu/ops/pallas_window.py:125',
            'window_scatter_sum': 'newtonnet_tpu/ops/pallas_window.py:136',
            'exp_row_gather': 'tools/exp_pallas_gather.py:30'}

MD17_CONFIG = os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')
BOX_ATOMS, BOX_K_MAX, BOX_REF_ATOMS = 4096, 88, 512
# The JAX package's first 10 fine-tuning steps of that configuration (loss,
# global gradient norm before the clip), on the CPU with Pallas in
# interpret mode at default matmul precision and bf16 duals:
#   train_gen, _, _, stats = parse_train_test(train_root=<ccsd_train>,
#       test_root=<ccsd_test>, train_size=950, train_batch_size=10,
#       val_batch_size=50, test_batch_size=500, seed=0)
#   model, params = load_model(<checkpoint>)
#   params = set_scalers(params, model.output_properties, stats,
#                        {'energy': {'fit_scale': True, 'fit_shift': True}})
#   tx = get_optimizer_by_string('adam', clip_grad=1.0, lr=1e-3)
#   then jit(fastgrad.value_and_grad) + tx.update over the loader's first
#   10 batches.
JAX_STEP_LOSS = [7.431698, 1.915496, 1.701782, 2.004409, 0.8471781,
                 0.4329701, 0.4297071, 0.2887689, 0.4286618, 0.4786679]
JAX_STEP_GRAD_NORM = [442.05, 157.16, 170.20, 223.88, 102.84, 32.152,
                      25.714, 12.341, 39.999, 37.467]
# the JAX CLI on the CPU, same configuration, bf16 duals: test force MAE
# after epoch 0 (reported beside the port's, with no bar: a whole epoch
# of bf16 gradient noise moves it by 20% between dual dtypes)
JAX_EPOCH0_TEST_FORCE_MAE = 0.04655
# The same fine-tuning in neighbour-list mode (graph_mode neighborlist, k_max
# 48, fp32 edges; the K-list duals compute in float32): the JAX package's
# first 10 steps, from `python tests/test_torch_klist_reference.py steps`
# (CPU, Pallas in interpret mode).
JAX_NLIST_STEP_LOSS = [7.431698, 1.917212, 1.701129, 2.000114, 0.8446221,
                       0.4311443, 0.4295923, 0.2881154, 0.4282749, 0.4789315]
JAX_NLIST_STEP_GRAD_NORM = [441.98, 157.24, 170.4, 222.99, 102.69, 31.998,
                            25.624, 12.321, 40.37, 36.709]
# One request on box_system(BOX_REF_ATOMS) with box_model's weights: the
# JAX package's energy (eV) and the forces of the first 8 atoms (eV/A),
# with bf16 edges and with fp32 edges, from `python
# tests/test_torch_klist_reference.py box` (CPU, Pallas in interpret mode;
# the machine with the card has no flax, and 512 atoms keep that CPU run
# small). Rounding the edge tensors to bf16 moves the numbers far more than
# float32 rounding does, so the box phase's bars are BOX_SPREAD_FACTOR times
# that spread (bf16 against fp32 edges, within one package).
JAX_BOX_ENERGY = -43.9780387878418
JAX_BOX_FORCES_8 = [
    [-0.059481725096702576, -0.04440084844827652, 0.2644277513027191],
    [0.15478065609931946, 0.1095714345574379, 0.10916266590356827],
    [0.015232101082801819, 0.5800017714500427, 0.3384057581424713],
    [-0.23470914363861084, -0.09447100013494492, 0.04846468195319176],
    [-0.07883767038583755, -0.24986504018306732, 0.03565562516450882],
    [-0.21956074237823486, -0.05005502700805664, -0.06566018611192703],
    [0.015504099428653717, -0.006339889019727707, -0.17289698123931885],
    [-0.08519262820482254, 0.1517954021692276, 0.016054946929216385],
]
JAX_BOX_FP32_EDGES_ENERGY = -43.98573303222656
JAX_BOX_FP32_EDGES_FORCES_8 = [
    [-0.059608928859233856, -0.04478030651807785, 0.2650977671146393],
    [0.15508434176445007, 0.10977096110582352, 0.10862404108047485],
    [0.01531795784831047, 0.5810218453407288, 0.33905816078186035],
    [-0.23467105627059937, -0.09398595243692398, 0.04832283779978752],
    [-0.07897371798753738, -0.2502093017101288, 0.03517238050699234],
    [-0.21945680677890778, -0.049925073981285095, -0.06610751152038574],
    [0.015352100133895874, -0.006744787096977234, -0.1734355390071869],
    [-0.08451390266418457, 0.1513175517320633, 0.01589856669306755],
]
BOX_SPREAD_FACTOR = 4.0
# C11: the XLA bf16 stack against the JAX package's bf16 program (compiled
# without excess precision). Both round the same values to bf16; their
# float32 arithmetic differs in order (a matmul's accumulation: XLA's CPU
# dot, torch's CPU or cuBLAS gemm) and in the last bits of the edge
# features (XLA fuses the cutoff polynomial with multiply-adds), which
# flips a few bf16 roundings that grow through the layers. So the bars are
# pooled over the C11_BOXES (box_system(atoms, seed)) and taken in units of
# the JAX program's own bf16-to-fp32 shift, each as a root mean square:
# of the total energies, of the per-atom energies and of the force
# components. The JAX numbers are in C11_REF (`python
# tests/test_torch_xla_reference.py bf16-boxes`, CPU). On the CPU the port
# measures 0.22, 0.40 and 0.47 (the same recipe); the port's float32
# request, which is what the bf16 stack was before C11, measures 1.00 in
# all three, and must fail every bar (c11_box_stats).
C11_BOXES = ((256, 0), (512, 0), (256, 1), (512, 1),
             (512, 2), (512, 3), (256, 2), (256, 3))
C11_REF = os.path.join(ROOT, 'tests', 'reference', 'jax_xla_bf16_boxes.npz')
C11_BARS = {'energy': 0.5, 'atom_energy': 0.6, 'forces': 0.75}
C11_STEP_SHIFTS = 2.0
# The 4096-atom bf16 request against its own float32 request (phase 5c):
# the per-atom energies and the force components as root mean squares in
# units of the JAX program's pooled bf16-to-fp32 shifts of C11_REF (the
# same weights and density; per atom, so the atom count drops out). A
# control request, the same bf16 stack with every layer's message_nodepart
# rows rounded through float8_e4m3fn (3 mantissa bits for bf16's 7), must
# exceed it. On the C11 boxes (CPU, `bf16-boxes`) the bf16 stack measures
# 1.06 (per-atom energies) and 0.67 (forces), the control 5.04 and 3.91.
BOX_BF16_VS_FP32 = 1.5
# The trained kernel='xla' checkpoint (its config has no kernel key) on the
# 500 aspirin test frames in batches of 100: the JAX package's energy and
# force MAE, dense and in inverse-list mode (graph_mode neighborlist,
# inverse_lists, k_max 48, lists from its host_symmetric_nlist), from
# `python tests/test_torch_xla_reference.py mae` (CPU, float32).
XLA_CKPT = os.path.join(ROOT, 'artifacts', 'md17_model',
                        'best_model.msgpack')
JAX_XLA_ENERGY_MAE, JAX_XLA_FORCE_MAE = 0.00616796875, 0.022559619799136444
JAX_XLA_INV_ENERGY_MAE, JAX_XLA_INV_FORCE_MAE = (0.00616796875,
                                                 0.022559623331373183)
INV_K_MAX = 48
# One request on box_system(BOX_REF_ATOMS) with box_weights' weights in
# inverse-list mode (k_max BOX_K_MAX), float32: the JAX package's energy and
# the first 8 atoms' forces, from `python tests/test_torch_xla_reference.py
# box` (CPU).
JAX_XLA_BOX_FP32_ENERGY = -43.98573303222656
JAX_XLA_BOX_FP32_FORCES_8 = [
    [-0.05960889905691147, -0.044780369848012924, 0.2650974988937378],
    [0.15508432686328888, 0.1097710058093071, 0.10862377285957336],
    [0.01531803235411644, 0.5810221433639526, 0.3390587270259857],
    [-0.23467063903808594, -0.09398631751537323, 0.048322614282369614],
    [-0.07897380739450455, -0.25020939111709595, 0.03517230600118637],
    [-0.2194567173719406, -0.04992446303367615, -0.06610745191574097],
    [0.015352045185863972, -0.006744819693267345, -0.17343561351299286],
    [-0.08451394736766815, 0.15131747722625732, 0.015898654237389565],
]
# Fine-tuning the XLA checkpoint with its own config (phase 7f: energy + 50
# x force mse, Adam 1e-3, clip 1.0, batch 10, scalers refit; the JAX
# package's default step for it is the standard, reverse-over-reverse one):
# the JAX package's first 10 steps (loss, global gradient norm before the
# clip), dense and with graph_mode neighborlist, k_max 48 (phase 7g), from
# `python tests/test_torch_xla_reference.py steps` (CPU, float32, matmul
# precision 'highest' as the config asks).
XLA_CONFIG = os.path.join(ROOT, 'artifacts', 'md17_model', 'config.yml')
JAX_XLA_STEP_LOSS = [7.462329, 1.820544, 1.754462, 1.822755, 0.7851596,
                     0.4112062, 0.3771977, 0.2621882, 0.3426366, 0.2904399]
JAX_XLA_STEP_GRAD_NORM = [470.11, 166.22, 152.34, 221.74, 114.48, 48.389,
                          40.471, 36.628, 21.758, 31.631]
JAX_XLA_NLIST_STEP_LOSS = [7.462329, 1.820544, 1.754462, 1.822755,
                           0.7851592, 0.4112058, 0.3771978, 0.2621885,
                           0.3426363, 0.2904404]
JAX_XLA_NLIST_STEP_GRAD_NORM = [470.11, 166.22, 152.34, 221.74, 114.48,
                                48.389, 40.471, 36.628, 21.758, 31.631]
# Phase 7h's loss on the box: energy + force + stress mse, the labels from
# box_system and box_stress (numpy seeds). At BOX_REF_ATOMS, over inverse
# lists with box_weights' weights, the JAX package's standard step 1 (loss,
# global gradient norm) with a bf16 stack and in float32, from `python
# tests/test_torch_xla_reference.py box-steps` (CPU; compiled without
# excess precision).
BOX_XLA_LOSS = {'energy': {'weight': 1.0},
                'gradient_force': {'weight': 50.0},
                'stress': {'weight': 100.0}}
JAX_XLA_BOX_STEP_LOSS = {'bfloat16': 2047.775146484375,
                         'float32': 2048.697021484375}
JAX_XLA_BOX_STEP_GRAD_NORM = {'bfloat16': 103630.796875,
                              'float32': 103555.421875}
# The trained newton3 checkpoint (F=48, R=16, 2 interactions, k_max 16) and
# its config; lj_box's 64-atom LJ box served by the JAX package's
# calculator (energy, first 8 atoms' forces), and its first 10 fine-tuning
# steps of that config (loss, global gradient norm before the clip) on
# write_lj_dataset's frames over precompute_nlist mode newton3, from
# `python tests/test_torch_xla_reference.py lj|lj-steps` (CPU, float32).
LJ_DIR = os.path.join(ROOT, 'artifacts', 'lj_liquid_newton3', 'training_1')
LJ_CKPT = os.path.join(LJ_DIR, 'models', 'best_model.msgpack')
LJ_CONFIG = os.path.join(LJ_DIR, 'run_scripts', 'lj_n3_cfg.yml')
LJ_FRAMES = 150
# the 4096-atom box's half-list capacity with newton3 (its full list is
# built at 2 * BOX_N3_K_MAX + 8 = 104 > the box's largest degree)
BOX_N3_K_MAX = 48
# phase 8b's step-1 loss bar, relative to the float64 loss
LJ_STEP1_REL = 1e-5
JAX_LJ_N3_ENERGY = -0.8382080793380737
JAX_LJ_N3_FORCES_8 = [
    [-0.06270407140254974, 0.007688228040933609, 0.009886199608445168],
    [-0.0018866043537855148, -0.09109240025281906, 0.058984044939279556],
    [-0.041957028210163116, 0.1762581765651703, 0.11202788352966309],
    [0.023618699982762337, 0.09030535817146301, 0.045221783220767975],
    [-0.15615397691726685, 0.1090630441904068, -0.16298463940620422],
    [-0.044347070157527924, -0.09446987509727478, 0.06551916152238846],
    [0.28402113914489746, -0.05271579697728157, 0.04702087491750717],
    [-0.18937335908412933, -0.21798810362815857, -0.07471662014722824],
]
JAX_LJ_STEP_LOSS = [11.21076, 7.211863, 5.258116, 2.762722, 1.232769,
                    0.6052042, 0.4521829, 0.4364477, 0.6743013, 1163.501]
JAX_LJ_STEP_GRAD_NORM = [152.23, 317.9, 210.82, 81.833, 51.404, 33.548,
                         19.597, 66.983, 21.964, 14627.0]
# Phase 9: the LJ checkpoint as a kernel='pallas' model at its own width
# F=48 (the override a caller gives the newton3 checkpoint's config: no
# newton3, plain full lists of its k_max 16 over K-lists), dense (K1-K4) and
# over K-lists (K5-K8). The JAX package's calculator on lj_box's box
# (energy, first 8 atoms' forces) and its first 10 fine-tuning steps of
# LJ_CONFIG over lj_pallas_data_settings' batches (loss, global gradient
# norm before the clip; the dense duals in the config's default bf16, the
# K-list ones in float32), from `python tests/test_torch_widths.py
# lj-pallas` (CPU, interpret-mode Pallas, float32).
LJ_PALLAS = {'kernel': 'pallas', 'newton3': False}
JAX_LJ_PALLAS_ENERGY = {
    'dense': -0.8382089734077454,
    'neighborlist': -0.8382088541984558,
}
JAX_LJ_PALLAS_FORCES_8 = {
    'dense': [
        [-0.06270399689674377, 0.007688185200095177, 0.009886199608445168],
        [-0.0018863184377551079, -0.09109245985746384, 0.05898401141166687],
        [-0.041956957429647446, 0.17625832557678223, 0.1120276004076004],
        [0.023618856444954872, 0.09030559659004211, 0.045221537351608276],
        [-0.1561538726091385, 0.1090630367398262, -0.16298460960388184],
        [-0.04434707760810852, -0.09446988999843597, 0.06551916897296906],
        [0.284021258354187, -0.05271607264876366, 0.04702077805995941],
        [-0.18937328457832336, -0.21798792481422424, -0.0747164934873581],
    ],
    'neighborlist': [
        [-0.06270408630371094, 0.007688267156481743, 0.009886205196380615],
        [-0.001886129379272461, -0.09109237790107727, 0.058984022587537766],
        [-0.041957054287195206, 0.17625823616981506, 0.11202755570411682],
        [0.0236189141869545, 0.09030560404062271, 0.04522160068154335],
        [-0.15615370869636536, 0.10906321555376053, -0.1629846692085266],
        [-0.044347044080495834, -0.09446988999843597, 0.06551916897296906],
        [0.284021258354187, -0.052716027945280075, 0.04702078178524971],
        [-0.18937312066555023, -0.21798783540725708, -0.07471635192632675],
    ],
}
JAX_LJ_PALLAS_STEP_LOSS = {
    'dense':
        [11.210762977600098, 7.201947212219238, 5.25237512588501,
         2.7583110332489014, 1.231848955154419, 0.6050155162811279,
         0.4517867863178253, 0.4365600645542145, 0.6739151477813721,
         1161.4866943359375],
    'neighborlist':
        [11.21076488494873, 7.211883544921875, 5.258123874664307,
         2.7627146244049072, 1.2327677011489868, 0.6052030920982361,
         0.4521811604499817, 0.4364464282989502, 0.674301028251648,
         1163.502197265625],
}
JAX_LJ_PALLAS_STEP_GRAD_NORM = {
    'dense':
        [152.15933227539062, 317.4409484863281, 210.59669494628906,
         81.92987823486328, 51.46177673339844, 33.47886657714844,
         19.64616584777832, 67.03063201904297, 22.029096603393555,
         19714.3046875],
    'neighborlist':
        [152.22665405273438, 317.8999938964844, 210.82395935058594,
         81.83312225341797, 51.403839111328125, 33.548194885253906,
         19.596834182739258, 66.98257446289062, 21.964038848876953,
         14624.9970703125],
}
# the widths of phase 9a's kernel checks (a pad to 32 lanes, 16 and 20;
# the LJ width 48; 96 and 256, libraries of their own, 256 in the wide
# tiles) and of phase 9d's timing (48 beside 64, 256 beside 128)
WIDTHS_9A = (16, 20, 48, 96, 256)
WIDTHS_9D = (48, 64, 256)
# the widths whose K1-K8 libraries the build phase compiles
BUILD_WIDTHS = tuple(sorted({32, 64, 128, *WIDTHS_9A, *WIDTHS_9D}))
# Phase 10: the Pallas pair kernels' bf16 mode (pallas_dot_dtype bfloat16)
# in K1/K2 and K5/K6, served. The widths of 10a (a pad to 32 lanes, the LJ
# width, the checkpoints' 128 and the wide 256), whose bf16 libraries the
# build phase compiles; the median bar of 10a (the median element error over
# the plain output's largest magnitude, beside DUAL_BF16_BAR on the largest):
# where the kernel rounds the operands its plain version rounds, the two
# differ by the fp32 summation order and a rare flip of a rounding; an
# operand rounded on one side only moves the median by about 1e-4
# (tests/test_torch_bf16_pair.py's control).
BF16_WIDTHS = (20, 48, 128, 256)
BF16_MEDIAN_BAR = 1e-5
BF16_DENSE = ('pair_fwd_bf16', 'pair_fwd_first_bf16', 'pair_bwd_bf16',
              'pair_bwd_first_bf16')
BF16_KLIST = ('klist_fwd_bf16', 'klist_fwd_first_bf16', 'klist_bwd_bf16',
              'klist_bwd_first_bf16')
# 10b: artifacts/md17_model_pallas with pallas_dot_dtype bfloat16 on the
# first BF16_ASPIRIN_FRAMES aspirin test frames (collate, n_pad 21): the JAX
# package's energies (eV), the forces of the first 4 frames (eV/A) and its
# own bf16-to-fp32 spread on those frames (the largest absolute difference
# between its bf16 and fp32 models), from `python
# tests/test_torch_bf16_pair.py aspirin` (CPU, interpret-mode Pallas).
# 10c: the LJ checkpoint as a kernel='pallas' bf16 model (LJ_PALLAS) on
# lj_box's box through the JAX package's calculator, dense and over plain
# K-lists with fp32 and bf16 edges: energy, the first 8 atoms' forces and
# the spread, from `python tests/test_torch_bf16_pair.py lj`. Both are held
# at BF16_SPREAD_FACTOR times the spread.
BF16_ASPIRIN_FRAMES = 50
BF16_SPREAD_FACTOR = 4.0
JAX_BF16_ASPIRIN_ENERGY = [
    -17591.810546875, -17592.166015625, -17592.861328125,
    -17592.72265625, -17592.318359375, -17592.470703125,
    -17591.90234375, -17592.20703125, -17592.015625,
    -17592.294921875, -17592.10546875, -17592.478515625,
    -17592.466796875, -17592.041015625, -17591.748046875,
    -17591.705078125, -17592.427734375, -17592.7109375,
    -17592.05078125, -17592.130859375, -17592.4453125,
    -17592.1328125, -17591.99609375, -17591.83984375,
    -17592.234375, -17592.00390625, -17591.953125,
    -17591.720703125, -17592.650390625, -17592.234375,
    -17592.59765625, -17591.603515625, -17592.404296875,
    -17592.1484375, -17591.8125, -17592.353515625,
    -17591.8203125, -17592.0859375, -17591.82421875,
    -17592.38671875, -17592.228515625, -17591.90625,
    -17592.1328125, -17592.208984375, -17592.171875,
    -17591.8125, -17592.47265625, -17592.30859375,
    -17592.5, -17591.765625,
]
JAX_BF16_ASPIRIN_FORCES_4 = [
    [
        [1.5657679, 2.253922, 0.5659969],
        [1.3176204, -2.285882, -0.1330001],
        [0.8788271, -0.6573746, -0.5460213],
        [-2.8284433, 1.1299343, 0.1219357],
        [-3.2149363, -1.4194081, -0.1574625],
        [-0.2238388, -0.6183659, -1.1259253],
        [0.0917425, -0.3938419, 2.0335307],
        [1.7769148, -1.6686223, -1.1047566],
        [-0.4096322, 0.1235576, -0.5694569],
        [-1.1808068, -0.524627, -0.8557308],
        [-1.7474543, 1.5104601, 3.3167515],
        [2.9457622, -2.54037, -1.5198944],
        [-0.8325512, 1.6212058, 1.0752746],
        [0.2210693, 1.0235981, -0.3214014],
        [-0.3286401, -2.2689734, 0.9935197],
        [-0.0826835, 1.5912331, -0.6492441],
        [-0.6378059, -0.1238804, -0.1655045],
        [1.7315331, 1.3726246, -1.4677715],
        [0.1636122, 0.605921, 1.3437448],
        [0.38101, -0.2685509, -0.7060573],
        [0.4129329, 1.5374391, -0.1285263],
    ],
    [
        [-3.4143083, -3.9654922, 3.6522601],
        [-0.8907585, 1.5254192, 0.3851261],
        [2.500891, 3.2250481, -2.4776282],
        [0.3903651, 1.3123113, -0.7869843],
        [2.3317375, -1.578876, 0.5169899],
        [0.7920143, 0.3705421, -0.7331965],
        [-1.7307527, -0.1421021, -0.7338144],
        [0.1600551, -1.7105235, -1.5295544],
        [0.3988219, 0.0969241, -0.5474842],
        [-1.6277554, -1.4942725, 0.8014207],
        [0.4750361, 0.920046, 2.4817662],
        [-1.2495272, 0.1909371, 1.5521058],
        [2.7618113, 0.463095, -1.5827012],
        [0.9167938, 1.2427509, -0.7467844],
        [0.0102509, -0.3020392, -0.8969821],
        [0.4095853, -0.5304281, 0.4557672],
        [-0.2053605, -0.6578607, 0.8240325],
        [-0.2687364, -0.0637008, 0.266931],
        [-0.489043, 2.1802258, -1.5586246],
        [-1.5247865, -0.9500433, -0.2854958],
        [0.2536665, -0.13196, 0.9428506],
    ],
    [
        [-1.0484169, -0.5189314, 0.9571162],
        [1.6414754, -1.9237419, -0.0193655],
        [-0.4617311, 0.9686961, -0.680105],
        [-0.0564224, -1.7636104, 0.6903974],
        [-0.0394302, 0.3315204, -0.1070526],
        [0.5103521, 1.9138851, -1.2433338],
        [-1.024338, -0.116076, -0.1573913],
        [-2.094326, 1.0427306, -0.4407881],
        [-0.2212199, -0.6545106, -0.8476565],
        [-0.0440741, -1.154289, 1.0998303],
        [1.5932841, -1.4187217, 0.633406],
        [-0.0717164, -0.8545665, 0.6954584],
        [-0.4102073, 0.8988906, 1.315479],
        [0.4710323, 1.1462584, -1.3763545],
        [0.3729701, 0.2215306, -0.131889],
        [-0.892971, 1.6031318, -0.6133177],
        [0.3733521, -0.1507537, -0.0864416],
        [-0.037557, 0.583959, 0.2589076],
        [-0.0073143, -0.3292877, -0.7159458],
        [0.1423826, 0.4391474, 0.0035525],
        [1.3048759, -0.2652608, 0.7654941],
    ],
    [
        [0.726291, -3.2774715, 1.7894243],
        [1.0742719, 0.5844905, -0.5271311],
        [-1.3758062, 0.7557851, -1.0032403],
        [-0.7974502, 2.9113638, -1.1973779],
        [-0.363885, 2.1378031, 0.9088389],
        [0.3416765, -0.8822031, -0.9180756],
        [-0.5849047, -0.7597973, 1.0692402],
        [0.4855519, -1.5639609, -1.1036741],
        [-0.1339734, 0.7325997, 0.2208278],
        [-1.6894996, 0.4520717, 0.1782722],
        [0.4040182, 1.5151134, 2.3371663],
        [1.5044301, -2.1062269, -0.8641006],
        [-0.4390439, 1.1079693, -0.3172752],
        [0.7418108, 0.2386725, -0.8417572],
        [-0.4583102, 1.2909849, 0.0016171],
        [0.2217146, -0.538799, -0.1657331],
        [1.7494714, -0.9735081, -0.0827558],
        [-0.3486786, -0.6534636, 0.5815665],
        [-1.9925274, -1.3441359, -0.8612202],
        [0.1794829, -0.2368196, 1.0997002],
        [0.7553598, 0.609532, -0.3043125],
    ],
]
JAX_BF16_ASPIRIN_SPREAD = {'energy': 0.005859375,
                           'forces': 0.008157134056091309}
# (graph_mode, compute_dtype of the edges) of 10c's layouts
BF16_LJ_LAYOUTS = {'dense': ('dense', ''),
                   'klist_fp32_edges': ('neighborlist', ''),
                   'klist_bf16_edges': ('neighborlist', 'bfloat16')}
JAX_BF16_LJ_ENERGY = {
    'dense': -0.8434973955154419,
    'klist_fp32_edges': -0.8434973955154419,
    'klist_bf16_edges': -0.8446181416511536,
}
JAX_BF16_LJ_FORCES_8 = {
    'dense': [
        [-0.06263429, 0.00777896, 0.00980835],
        [-0.00194692, -0.09123254, 0.05919761],
        [-0.04206689, 0.17581148, 0.11196369],
        [0.02357298, 0.09031244, 0.04511277],
        [-0.15595996, 0.10897519, -0.16269761],
        [-0.04432977, -0.09444351, 0.06558999],
        [0.28390944, -0.05271781, 0.04710156],
        [-0.18897235, -0.21746373, -0.07456359],
    ],
    'klist_fp32_edges': [
        [-0.06256032, 0.00776922, 0.00977578],
        [-0.00203516, -0.09103705, 0.05917269],
        [-0.04213427, 0.17584832, 0.11204991],
        [0.02310453, 0.09010401, 0.04541176],
        [-0.15603428, 0.10885698, -0.16283427],
        [-0.04442054, -0.09432964, 0.06534065],
        [0.28402197, -0.05292482, 0.04714361],
        [-0.18888089, -0.21739925, -0.07454219],
    ],
    'klist_bf16_edges': [
        [-0.06280071, 0.0079582, 0.00949243],
        [-0.00189245, -0.09069975, 0.05899455],
        [-0.04195592, 0.17598413, 0.11232339],
        [0.02305029, 0.0903592, 0.04549427],
        [-0.15581222, 0.10872356, -0.16265668],
        [-0.04426331, -0.09413382, 0.06548937],
        [0.28406945, -0.05282651, 0.04754356],
        [-0.18932877, -0.21710217, -0.07457086],
    ],
}
JAX_BF16_LJ_SPREAD = {
    'dense': {'energy': 0.005288422107696533,
              'forces': 0.000865638256072998},
    'klist_fp32_edges': {'energy': 0.005288541316986084,
                         'forces': 0.0029218196868896484},
    'klist_bf16_edges': {'energy': 0.004579067230224609,
                         'forces': 0.002246379852294922},
}
# Phase 11: the K-list duals K7/K8 in bf16 mode, and fine-tuning
# pallas_dot_dtype bfloat16 models dense and over K-lists. The bf16 dual
# variants; 11b/11c's JAX numbers: the JAX package's first 10 fine-tuning
# steps (loss, global gradient norm before the clip) of its bf16 model and
# their bf16-to-fp32 shift (|bf16 - fp32| of each quantity, the same recipe
# with pallas_dot_dtype float32), from `python
# tests/test_torch_bf16_training.py aspirin` (scripts/config_md17_pallas.yml
# from the trained checkpoint: phase 7a's recipe dense, 7d's with graph_mode
# neighborlist, k_max 48) and `... lj` (the LJ checkpoint as a
# kernel='pallas' bf16 model fine-tuned by LJ_CONFIG over 10c's layouts:
# phase 9c's recipe); CPU, interpret-mode Pallas. Each quantity is held at
# BF16_SPREAD_FACTOR times its shift, or at PR 2's fp32 bar where that is
# larger (check_bf16_steps). On the CPU the port's plain bf16 aspirin step
# 1 gradient over K-lists is 1.5e-3 (relative norm) from its dense one:
# the two round different operands (K5/K6 and K7/K8 against K1/K2 and
# K3/K4), so 11b holds them at BF16_KLIST_VS_DENSE. 11c holds the LJ
# model's at BF16_LJ_KLIST_FACTOR times the JAX package's own distance
# between its bf16 K-list and dense step 1 gradients
# (JAX_BF16_LJ_KLIST_VS_DENSE, relative norm, from `python
# tests/test_torch_bf16_training.py lj-klist`). Not 4x: 4x passes the
# control, the bf16 K-list step against the fp32-product dense one, which
# the JAX package puts at 2.85x its distance with fp32 edges
# (JAX_BF16_LJ_KLIST_VS_FP32_DENSE) and the port's CPU run at 2.86x; at 2x
# the port's CPU distances are 1.00x (fp32 edges) and 1.66x (bf16 edges)
# of the JAX package's. With bf16 edges the edges' rounding dominates: the
# JAX package's control is 1.20x its distance and the port's own distance
# 1.66x, so no multiple separates a control there, and 11c computes the
# control with fp32 edges alone.
BF16_DUAL = ('klist_dual_fwd_bf16', 'klist_dual_fwd_first_bf16',
             'klist_dual_bwd_bf16', 'klist_dual_bwd_first_bf16')
BF16_KLIST_VS_DENSE = 2e-3
BF16_LJ_KLIST_FACTOR = 2.0
JAX_BF16_LJ_KLIST_VS_DENSE = {'klist_fp32_edges': 0.0030425613963543734,
                              'klist_bf16_edges': 0.007627414972146785}
JAX_BF16_LJ_KLIST_VS_FP32_DENSE = {'klist_fp32_edges': 0.008670860981708446,
                                   'klist_bf16_edges': 0.0091654828261673}
JAX_BF16_ASPIRIN_STEP_LOSS = {
    'dense': [7.437622547149658, 1.9063150882720947, 1.69451904296875,
              2.0260660648345947, 0.8412765860557556, 0.4333455562591553,
              0.426226943731308, 0.2938873767852783, 0.4301496744155884,
              0.46481817960739136],
    'neighborlist': [7.441060543060303, 1.9138054847717285, 1.6917777061462402,
                     2.0304901599884033, 0.8468963503837585,
                     0.4289546608924866, 0.4205749034881592,
                     0.28811758756637573, 0.4290848672389984,
                     0.47147321701049805],
}
JAX_BF16_ASPIRIN_STEP_GRAD_NORM = {
    'dense': [441.7536315917969, 157.07211303710938, 169.60189819335938,
              225.13279724121094, 103.35162353515625, 31.419347763061523,
              26.358827590942383, 13.103588104248047, 40.573726654052734,
              36.74274444580078],
    'neighborlist': [442.268310546875, 157.68922424316406, 169.42095947265625,
                     225.31719970703125, 104.24945831298828,
                     31.424633026123047, 25.78559112548828, 12.33523178100586,
                     40.828330993652344, 36.621070861816406],
}
JAX_BF16_ASPIRIN_STEP_SHIFT = {
    'dense': {
        'loss': [0.005924701690673828, 0.009181022644042969,
                 0.007262825965881348, 0.021657466888427734,
                 0.005901515483856201, 0.00037541985511779785,
                 0.00348016619682312, 0.005118519067764282,
                 0.0014879107475280762, 0.013849765062332153],
        'grad_norm': [0.2989501953125, 0.0913543701171875, 0.603057861328125,
                      1.2500457763671875, 0.5165939331054688,
                      0.7331066131591797, 0.6452808380126953, 0.7625732421875,
                      0.5742645263671875, 0.7238388061523438],
    },
    'neighborlist': {
        'loss': [0.009362220764160156, 0.003407001495361328,
                 0.009351134300231934, 0.030375957489013672,
                 0.0022742152214050293, 0.00218963623046875,
                 0.009017407894134521, 2.2351741790771484e-06,
                 0.0008099675178527832, 0.007458299398422241],
        'grad_norm': [0.29278564453125, 0.4499053955078125, 0.9797210693359375,
                      2.322967529296875, 1.5567245483398438, 0.5738525390625,
                      0.16149330139160156, 0.013742446899414062,
                      0.458251953125, 0.08815765380859375],
    },
}
JAX_BF16_LJ_STEP_LOSS = {
    'dense': [11.261275291442871, 7.167778491973877, 5.25321626663208,
              2.7779831886291504, 1.2276614904403687, 0.6056777238845825,
              0.456305593252182, 0.43583863973617554, 0.6743670701980591,
              1165.58447265625],
    'klist_fp32_edges': [11.255277633666992, 7.177620887756348,
                         5.266170501708984, 2.7680163383483887,
                         1.2207694053649902, 0.6031954884529114,
                         0.4580892026424408, 0.4351978003978729,
                         0.6734233498573303, 1161.8255615234375],
    'klist_bf16_edges': [11.239806175231934, 7.198912620544434,
                         5.276431083679199, 2.750553607940674,
                         1.2167086601257324, 0.6007124781608582,
                         0.45038890838623047, 0.4296683669090271,
                         0.675966203212738, 1162.0030517578125],
}
JAX_BF16_LJ_STEP_GRAD_NORM = {
    'dense': [153.6453857421875, 316.05914306640625, 210.12167358398438,
              82.60806274414062, 50.213077545166016, 33.73255920410156,
              19.153383255004883, 66.82833099365234, 21.903793334960938,
              19550.552734375],
    'klist_fp32_edges': [153.42742919921875, 316.58294677734375,
                         210.62570190429688, 82.09170532226562,
                         49.67734909057617, 33.6422119140625,
                         19.16147804260254, 66.68804931640625,
                         21.828744888305664, 19693.6484375],
    'klist_bf16_edges': [153.27008056640625, 317.98248291015625,
                         212.36669921875, 81.03970336914062,
                         49.383033752441406, 33.472904205322266,
                         18.83971405029297, 65.49048614501953,
                         20.985553741455078, 16245.4658203125],
}
JAX_BF16_LJ_STEP_SHIFT = {
    'dense': {
        'loss': [0.05051231384277344, 0.03416872024536133,
                 0.0008411407470703125, 0.019672155380249023,
                 0.004187464714050293, 0.0006622076034545898,
                 0.0045188069343566895, 0.0007214248180389404,
                 0.0004519224166870117, 4.0977783203125],
        'grad_norm': [1.486053466796875, 1.381805419921875, 0.4750213623046875,
                      0.6781845092773438, 1.2486991882324219,
                      0.253692626953125, 0.4927825927734375, 0.202301025390625,
                      0.1253032684326172, 163.751953125],
    },
    'klist_fp32_edges': {
        'loss': [0.04451274871826172, 0.034262657165527344,
                 0.008046627044677734, 0.005301713943481445,
                 0.011998295783996582, 0.002007603645324707,
                 0.0059080421924591064, 0.0012486279010772705,
                 0.000877678394317627, 1.6766357421875],
        'grad_norm': [1.200775146484375, 1.317047119140625, 0.1982574462890625,
                      0.25858306884765625, 1.7264900207519531,
                      0.09401702880859375, 0.43535614013671875,
                      0.294525146484375, 0.13529396057128906, 5068.6513671875],
    },
    'klist_bf16_edges': {
        'loss': [0.01710987091064453, 0.00942230224609375, 0.03796100616455078,
                 0.011311769485473633, 0.013683319091796875,
                 0.005718410015106201, 0.003297269344329834,
                 0.008052319288253784, 0.004491865634918213, 8.911376953125],
        'grad_norm': [0.5893707275390625, 0.42730712890625, 2.2406768798828125,
                      1.12554931640625, 2.462474822998047, 0.14518356323242188,
                      0.7249698638916016, 1.8253402709960938,
                      1.4053192138671875, 3729.0791015625],
    },
}
# Phase 12: the data pipeline (ROADMAP.md A4) under the repo's
# heterogeneous config, config_lj_hetero.yml as in the tree (F=64, 3
# interactions, cutoff 7, bucketed batches of 20 LJ clusters of 6-38 atoms,
# an XLA model), from the checkpoint that config trained, over a copy of
# data/lj_hetero. 12a's JAX numbers: the JAX package's first 10 training
# steps (loss, global gradient norm before the clip) and each batch's n_pad,
# from `python tests/test_torch_bucketed_training.py hetero` (CPU).
HETERO_DIR = os.path.join(ROOT, 'data', 'lj_hetero')
HETERO_RUN = os.path.join(ROOT, 'artifacts', 'lj_hetero_model', 'training_1')
HETERO_CONFIG = os.path.join(HETERO_RUN, 'run_scripts',
                             'config_lj_hetero.yml')
HETERO_CKPT = os.path.join(HETERO_RUN, 'models', 'best_model.msgpack')
HETERO_BUCKETS = (8, 16, 24, 32, 40)
HETERO_SHARD = 64
JAX_LJ_HETERO_STEP_LOSS = [
    0.0035989556927233934, 0.0004746905469801277, 0.000642496335785836,
    0.000615361554082483, 0.00011181036097696051, 0.01157854963093996,
    0.0002738984767347574, 0.00014937161176931113, 0.0004660892009269446,
    0.0006347735179588199]
JAX_LJ_HETERO_STEP_GRAD_NORM = [
    1.2836589813232422, 0.4442877471446991, 0.5637891888618469,
    0.5640550255775452, 0.11487258225679398, 8.194170951843262,
    0.28286048769950867, 0.10472200810909271, 0.4215766191482544,
    0.549811065196991]
JAX_LJ_HETERO_N_PAD = [16, 16, 16, 16, 8, 40, 16, 16, 16, 16]
DENSE_FP32 = ('pair_fwd', 'pair_fwd_first', 'pair_bwd', 'pair_bwd_first',
              'dual_fwd', 'dual_fwd_first', 'dual_bwd', 'dual_bwd_first')

# Phase 13: charge heads, the latent Ewald energy and Born effective charges
# (kernel='xla' models). Every phase 13 model's charge head comes from
# charge_head_tree (numpy, CHARGE_SEED). The JAX package's numbers: the
# arrays in CHARGE_REF and the steps below, from `python
# tests/test_torch_charge_model.py card` (CPU).
CHARGE_SEED = 17
CHARGE_REF = os.path.join(ROOT, 'tests', 'reference', 'jax_charge_heads.npz')
CHARGE_OUTPUTS = ('energy', 'gradient_force', 'charge', 'bec')
CHARGE_FRAMES = 8
CHARGE_ASPIRIN_KEYS = {'energy': 'ENERGY', 'gradient_force': 'FORCES',
                       'charge': 'CHARGES', 'bec': 'BEC'}
CHARGE_BOX_OUTPUTS = ('energy', 'gradient_force', 'stress', 'charge', 'bec')
CHARGE_BOX_KEYS = {'energy': 'ENERGY', 'forces': 'FORCES',
                   'stress': 'STRESS', 'charges': 'CHARGES'}
LJ_CHARGE_FRAMES = 4
# the float32 model bar (atol) of forces and charges; BEC at CHARGE_BAR of
# its largest magnitude; energies of the trained aspirin model at E_ATOL
# (one float32 ulp at -17,600 eV is 0.002 eV)
CHARGE_BAR = 2e-4
# the acoustic sum rule sum_i Z*_i = (sum_i q_i) I, relative to
# sum_i |Z*_i| (Frobenius norms)
SUM_RULE_BAR = 1e-5
FASTGRAD_CHARGE_BAR = 2e-4
JAX_LJ_CHARGE_STEP_LOSS = [1.860039, 0.6277779, 0.6093386, 0.5693539,
                           665.002, 0.2448078, 2.182259, 2.886215, 0.4894759,
                           33.04141]
JAX_LJ_CHARGE_STEP_GRAD_NORM = [59.4, 89.255, 74.687, 53.441, 1584.5,
                                40.489, 97.842, 54.554, 30.338, 391.6]

# Phase 14: the Hessian, the direct-force head and ensembles (kernel='xla').
# The JAX package's numbers: the arrays in HESSIAN_REF and the steps below,
# from `python tests/test_torch_hessian.py card` (CPU).
HESSIAN_REF = os.path.join(ROOT, 'tests', 'reference',
                           'jax_hessian_heads.npz')
HESSIAN_PROPS = ['energy', 'forces', 'hessian']
HESSIAN_FRAMES = 4
# 14a/14b's bars: this factor times the JAX package's own float32-to-
# float64 spread of the same quantity
HESSIAN_SPREAD_FACTOR = 4.0
HESSIAN_ASPIRIN_BLOCK = 16
LJ_HESSIAN_ATOMS = 512
LJ_HESSIAN_ATOMS_PICKED = (0, 171, 342)
LJ_HESSIAN_BLOCKS = (192, 96)
# the translational sum rule, relative to max |H|
HESSIAN_SUM_BAR = 1e-4
# atomic masses (u) of the elements of aspirin and LJ argon
MASSES = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999, 18: 39.948}
DIRECT_SEED = 18
DIRECT_FRAMES = 8
DIRECT_LOSS = {'energy': {'weight': 1.0, 'mode': 'mse'},
               'gradient_force': {'weight': 50.0, 'mode': 'mse'},
               'direct_force': {'weight': 50.0, 'mode': 'mse'}}
JAX_DIRECT_STEP_LOSS = [163.6291, 129.4189, 74.35656, 65.06251, 68.4675,
                        68.8425, 45.72818, 49.2178, 41.45601, 35.31856]
JAX_DIRECT_STEP_GRAD_NORM = [1346.6, 1200.5, 306.08, 312.59, 243.24, 326.0,
                             293.92, 461.44, 463.13, 281.94]
# the ensemble's MAE against the JAX ensemble's: energies at one float32
# ulp of the energies (0.002 eV at -17,600 eV; the members' sum is rounded
# at five times their magnitude, so the two packages' ensembles round
# apart by about that), forces at phase 4's force MAE bar
ENSEMBLE_MAE_BARS = {'energy': 2e-3, 'forces': 5e-5}
ENSEMBLE_CKPTS = [os.path.join(ROOT, 'artifacts', f'md17_model_s{k}',
                               'best_model.msgpack') for k in range(3, 8)]
ENSEMBLE_REQUESTS = 20
ENSEMBLE_MAE_FRAMES = 100

# Phase 15: MD (ROADMAP.md A9). 15a: the aspirin record MD_LOG (the JAX
# driver's run of XLA_CKPT: frame 0 at rest, 300 K, 0.5 fs, friction
# 1/(500 fs), logged every 100 steps), against MD_REPLICAS replicas of the
# same run over MD_ASPIRIN_STEPS steps: mean T and Epot over MD_WINDOW (ps)
# within MD_T_BAR / MD_EPOT_BAR of the record's MD_REF_WINDOW means; the
# first 0.5 ps (MD_CONTROL_WINDOW, 343.7 K in the record) must fail the
# temperature bar.
MD_LOG = os.path.join(ROOT, 'artifacts', 'md17_model', 'md.log')
MD_REPLICAS = 8
MD_ASPIRIN_STEPS = 6000
MD_LOG_EVERY = 10
MD_WINDOW, MD_REF_WINDOW, MD_CONTROL_WINDOW = (2.0, 3.0), (2.0, 10.0), \
    (0.0, 0.5)
MD_T_BAR, MD_EPOT_BAR = 20.0, 0.06
MD_SIMULATE_STEPS = 200
# 15b: NHC of CKPT (K1/K2) over MD_NHC_STEPS, tdamp 50 fs: the largest drift
# of the conserved quantity within MD_DRIFT_BAR (eV), which a run at 4x the
# timestep over the same simulated time must miss; MD_NVE_STEPS friction-0 steps on the card within
# MD_TRAJ_BAR (A) of the same run with the model on the CPU (the plain
# versions)
MD_NHC_STEPS = 1000
MD_DRIFT_BAR = 0.03
MD_NVE_STEPS = 20
MD_TRAJ_BAR = 1e-5
# 15c: LJ_CKPT on lj_box(512): MD_LJ's 20 friction-0 steps in three
# layouts against the JAX package's newton3 run (MD_LJ_REF, from `python
# tests/test_torch_md_driver.py lj-newton3` on the CPU), positions and
# per-step Epot within MD_LJ_BAR; the K-list layout at k_max MD_LJ_K_MAX
# (full lists at cutoff + skin: the box's largest degree there is 22)
MD_LJ = dict(atoms=512, steps=20, nlist_every=5, skin=1.0, temperature=100.0,
             timestep_fs=1.0)
MD_LJ_REF = os.path.join(ROOT, 'tests', 'reference', 'jax_md_lj_newton3.npz')
MD_LJ_BAR = 1e-4
MD_LJ_K_MAX = 32
# 15d: tools/demo_large_md.py's box (4096 atoms at 0.1 per cubic A, F=128,
# bf16 stack, box_weights scaled by 0.1 as the demo scales its weights),
# Langevin over MD_BOX_STEPS steps with rebuilds every MD_BOX_EVERY, at the
# demo's half-list capacity; 40 steps (four rebuild chunks) give the rate,
# and the staircase's step takes about half a second of the script's limit
MD_BOX_ATOMS, MD_BOX_K_MAX = 4096, 72
MD_BOX_STEPS, MD_BOX_EVERY = 40, 10

# the window ops' shapes (tools/bench_window.py): T atoms per block, the
# payload 4F = 512 bf16; K12 at tools/exp_pallas_gather.py's default
WINDOW_T, WINDOW_F = 128, 512
EXP_GATHER_N, EXP_GATHER_F, EXP_GATHER_ROWS = 4096, 512, 163840
LOG_COLUMNS = (
    ['epoch', 'lr', 'step']
    + [f'train_{k}' for k in ('loss', 'energy_mae', 'energy_mse',
                              'energy_per_atom_mae', 'energy_per_atom_mse',
                              'gradient_force_mae', 'gradient_force_mse')]
    + ['epoch_seconds', 'steps_per_s', 'edges_per_s']
    + [f'{s}_{k}' for s in ('val', 'test')
       for k in ('loss', 'energy_mae', 'energy_mse', 'energy_per_atom_mae',
                 'energy_per_atom_mse', 'gradient_force_mae',
                 'gradient_force_mse')]
    + ['best_model'])


class PhaseFailed(Exception):
    pass


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def random_inputs(torch, B, N, F, R, seed):
    '''Layer inputs of the scale the model produces, made on the card.'''
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device='cuda') * scale

    eye = torch.eye(N, device='cuda', dtype=torch.bool)
    adj = ((torch.rand((B, N, N), generator=g, device='cuda') < 0.6)
           & ~eye).float()
    ins = [rnd(B, N, F, scale=0.3), rnd(B, N, N, R, scale=0.3),
           rnd(B, 3, N, N), adj, rnd(B, 3, N, F, scale=0.2)]
    ins += [rnd(*s, scale=s[0] ** -0.5)
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    return ins, rnd(B, N, F), rnd(B, 3, N, F)


def layer_work(B, N, F, R, kind, first):
    '''(flops, bytes) the layer function needs: matrix products plus the
    per-feature multiply-adds over all B*N*N pair slots (sigmoids not
    counted); each input read once and each output written once, fp32.'''
    S = B * N * N
    nb = 1 if first else 2
    if kind == 'fwd':
        flops = S * (2 * R * F + 4 * F + nb * (4 * F * F + 6 * F))
        floats = (B * N * F + S * R + 4 * S + R * F + nb * 2 * F * F
                  + (0 if first else 3 * B * N * F) + 4 * B * N * F)
    else:
        flops = S * (4 * R * F + 11 * F + nb * (8 * F * F + 12 * F))
        floats = (B * N * F + S * R + 4 * S + R * F + nb * 2 * F * F
                  + (0 if first else 3 * B * N * F) + 4 * B * N * F
                  + B * N * F + S * R + 3 * S + 3 * B * N * F)
    return flops, 4 * floats


def dual_inputs(torch, B, N, F, R, seed):
    '''K3's 14 inputs and K4's 4 cotangents, made on the card.'''
    ins, di, dq = random_inputs(torch, B, N, F, R, seed)
    g = torch.Generator(device='cuda').manual_seed(seed + 100)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device='cuda') * 0.1

    np_, rbf, dir_, adj, force = ins[:5]
    args = [np_, rnd(B, N, F), rbf, rnd(B, N, N, R), dir_, rnd(B, 3, N, N),
            adj, force, rnd(B, 3, N, F)] + ins[5:]
    return args, [di, dq, rnd(B, N, F), rnd(B, 3, N, F)]


def dual_work(B, N, F, R, kind, first):
    '''(flops, bytes) of K3 ('fwd') or K4 ('bwd'): the matrix products (K3
    per pair slot: me, medot, and p, pdot, phi, phidot per branch; K4 adds
    dh, dhdot, dmsg, dmsgdot and the weight cotangents h^T g, hdot^T gdot,
    msg^T dp, msgdot^T dpdot per branch, rbf^T dme and rbfdot^T dmedot)
    plus the per-feature multiply-adds (sigmoids not counted); each input
    read once and each output written once, fp32.'''
    S = B * N * N
    nb = 1 if first else 2
    node = B * N * F
    floats_in = (2 * node + 2 * S * R + 7 * S + R * F + nb * 2 * F * F
                 + (0 if first else 6 * node))
    if kind == 'fwd':
        flops = S * (4 * R * F + (4 if first else 12) * F
                     + nb * (8 * F * F + 14 * F))
        floats = floats_in + 8 * node
    else:
        flops = S * (8 * R * F + (10 if first else 24) * F
                     + nb * (20 * F * F + 40 * F) + (nb - 1) * 4 * F * F)
        floats = floats_in + 8 * node + 8 * node + R * F + 4 * F * F
    return flops, 4 * floats


def time_ms(torch, fn, reps=7, inner=10):
    '''Median over `reps` of the mean time of `inner` back-to-back calls,
    from CUDA events.'''
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_ms(torch, fn, calls=20):
    '''Device time of one call of fn: its kernels' device time summed under
    torch.profiler over `calls` back-to-back calls, divided by `calls`
    (time_ms measures the host's enqueue instead where that is longer).'''
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / calls


def profile_call(torch, fn):
    """One call of fn under torch.profiler: wall ms (host clock, ending in
    a synchronise), device busy ms (the sum of the device's own events),
    the fused kernels' share of it, and the five longest device kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    events = prof.key_averages()
    dev = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in events if str(e.device_type).endswith('CUDA')]
    busy = sum(ms for _, ms, _ in dev)
    families = {}
    for key, ms, _ in dev:
        m = re.search(r'(klist_dual_fwd|klist_dual_bwd|klist_fwd|klist_bwd|'
                      r'pair_fwd|pair_bwd|dual_fwd|dual_bwd|row_gather)'
                      r'(?:_prep)?_kernel', key)
        if m:
            families[m.group(1)] = families.get(m.group(1), 0.0) + ms
    # K1-K4 with their reductions and weight preparation, by kernel name
    dense = {}
    for key, ms, _ in dev:
        m = re.search(r'(?<!klist_)(pair_fwd|pair_bwd|dual_fwd|dual_bwd)_\w*'
                      r'kernel', key)
        if m:
            k = {'pair_fwd': 'K1', 'pair_bwd': 'K2', 'dual_fwd': 'K3',
                 'dual_bwd': 'K4'}[m.group(1)]
            dense[k] = dense.get(k, 0.0) + ms
    # the neighbour gathers and their transposes, from the operators that
    # launch them (their device time, children included)
    ops = {e.key: getattr(e, 'device_time_total', 0.0) / 1e3 for e in events}
    top = sorted(dev, key=lambda d: -d[1])[:5]
    return {'wall_ms': wall, 'device_busy_ms': busy,
            'device_idle_share': 1.0 - busy / wall if busy else None,
            'fused_kernels_ms': sum(v for k, v in families.items()
                                    if k != 'row_gather'),
            'k9_ms': families.get('row_gather', 0.0),
            'k9_launches': sum(n for k, _, n in dev
                               if 'row_gather_kernel' in k),
            'kernel_ms': families, 'dense_kernel_ms': dense,
            'gather_ms': ops.get('aten::gather', 0.0),
            'gather_nodes_backward_ms': ops.get('gather_nodes_backward',
                                                0.0),
            'scatter_add_ms': ops.get('aten::scatter_add_',
                                      ops.get('aten::scatter_add', 0.0)),
            'top_device_ms': [[k[:70], ms, n] for k, ms, n in top]}


def phase_kernels(torch, fd, shapes=None):
    '''Phase 3: every kernel variant against its plain version, at phase
    3's shapes or at `shapes` ((B, N, F, R) each; phase 12b's buckets).'''
    errs = {}
    # the last one ragged: N = 37 is no multiple of K2's 8-row or 4-column
    # tiles, R = 12 pads to 32 in its products
    shapes = shapes or [(100, 21, 128, 20), (1, 24, 128, 20),
                        (2, 70, 64, 16), (3, 37, 32, 12)]
    for si, (B, N, F, R) in enumerate(shapes):
        ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=si)
        worst = 0.0
        for first in (False, True):
            name = 'pair_fwd_first' if first else 'pair_fwd'
            got = fd.pair_interaction_fwd(*ins, first_layer=first)
            ref = fd.pair_interaction_fwd_ref(*ins, first_layer=first)
            torch.cuda.synchronize()
            outs = [(name, 'inv1', got[0], ref[0]),
                    (name, 'eq', got[1], ref[1])]
            bname = 'pair_bwd_first' if first else 'pair_bwd'
            for wg in (False, True):
                got = fd.pair_interaction_bwd(*ins, dinv1, deq,
                                              first_layer=first,
                                              weight_grads=wg)
                ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                                  first_layer=first,
                                                  weight_grads=wg)
                torch.cuda.synchronize()
                labels = ['dnp', 'drbf', 'ddir', 'dforce', 'dWe', 'dW1a',
                          'dW1b', 'dW2a', 'dW2b']
                for lab, a, b in zip(labels, got, ref):
                    check((a is None) == (b is None), f'{bname} {lab}')
                    if a is not None:
                        outs.append((bname, f'{lab}(wg={int(wg)})', a, b))
            for kname, lab, a, b in outs:
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                check(bool(torch.isfinite(a).all()),
                      f'{kname} {lab} not finite at {(B, N, F, R)}')
                check(err <= KERNEL_BAR * scale,
                      f'{kname} {lab} at {(B, N, F, R)}: max err {err} > '
                      f'{KERNEL_BAR} * {scale}')
                worst = max(worst, err / max(scale, 1e-30))
                if si == 0:
                    errs[kname] = max(errs.get(kname, 0.0), err)
        emit('kernel_vs_plain', shape=dict(B=B, N=N, F=F, R=R),
             worst_err_over_max=worst, bar=KERNEL_BAR)
    # three K2 launches on one input give equal bits (no float atomics)
    ins, dinv1, deq = random_inputs(torch, *shapes[0], seed=0)
    same = {}
    for first in (False, True):
        for wg in (False, True):
            runs = [fd.pair_interaction_bwd(*ins, dinv1, deq,
                                            first_layer=first,
                                            weight_grads=wg)
                    for _ in range(3)]
            same[f'first={int(first)} wg={int(wg)}'] = all(
                exact(torch, a, b) for r in runs[1:]
                for a, b in zip(runs[0], r) if a is not None)
    emit('pair_bwd_repeats_its_bits', shape=shapes[0], **same)
    check(all(same.values()), f'three K2 launches differ in their bits: {same}')
    # and three K1 launches (its row sums over column tiles, fixed order)
    same = {}
    for first in (False, True):
        runs = [fd.pair_interaction_fwd(*ins, first_layer=first)
                for _ in range(3)]
        same[f'first={int(first)}'] = all(
            exact(torch, a, b) for r in runs[1:] for a, b in zip(runs[0], r))
    emit('pair_fwd_repeats_its_bits', shape=shapes[0], **same)
    check(all(same.values()), f'three K1 launches differ in their bits: {same}')
    return errs


def phase_dual_kernels(torch, fdd, shapes=None):
    '''Phase 3, dual: K3/K4 against their plain versions, both variants,
    fp32 and bf16 modes, at phase 3's shapes or at `shapes`. -> {variant:
    max abs err} at the first shape (the training shape) in bf16 mode (the
    training path's).'''
    errs = {}
    # the training shape, one molecule, and two whose N is no multiple of
    # the 8-row or 4-column tiles (the last with R padded to 32)
    shapes = shapes or [(10, 24, 128, 20), (1, 24, 128, 20),
                        (2, 70, 64, 16), (3, 37, 32, 12)]
    labels = ['inv1', 'eq', 'inv1dot', 'eqdot', 'dnp', 'dnpdot', 'dforce',
              'dforcedot', 'dWe', 'dW1a', 'dW1b', 'dW2a', 'dW2b']
    for si, (B, N, F, R) in enumerate(shapes):
        args, cots = dual_inputs(torch, B, N, F, R, seed=10 + si)
        worst = {}
        for first in (False, True):
            suffix = '_first' if first else ''
            for dt, bar in (('float32', KERNEL_BAR),
                            ('bfloat16', DUAL_BF16_BAR)):
                kw = dict(first_layer=first, dot_dtype=dt)
                got = list(fdd.pair_interaction_dual_fwd(*args, **kw))
                got += fdd.pair_interaction_dual_bwd(*args, *cots, **kw)
                ref = list(fdd.pair_interaction_dual_fwd_ref(*args, **kw))
                ref += fdd.pair_interaction_dual_bwd_ref(*args, *cots, **kw)
                torch.cuda.synchronize()
                for k, (lab, a, b) in enumerate(zip(labels, got, ref)):
                    kname = ('dual_fwd' if k < 4 else 'dual_bwd') + suffix
                    err = (a - b).abs().max().item()
                    scale = b.abs().max().item()
                    check(bool(torch.isfinite(a).all()),
                          f'{kname} {lab} not finite at {(B, N, F, R)} {dt}')
                    check(err <= bar * scale,
                          f'{kname} {lab} at {(B, N, F, R)} {dt}: max err '
                          f'{err} > {bar} * {scale}')
                    worst[dt] = max(worst.get(dt, 0.0),
                                    err / scale if scale else err)
                    if si == 0 and dt == 'bfloat16':
                        errs[kname] = max(errs.get(kname, 0.0), err)
        emit('dual_vs_plain', shape=dict(B=B, N=N, F=F, R=R),
             worst_err_over_max=worst,
             bar={'float32': KERNEL_BAR, 'bfloat16': DUAL_BF16_BAR})
    # three K4 launches on one input give equal bits (no float atomics)
    args, cots = dual_inputs(torch, *shapes[0], seed=10)
    same = {}
    for dt in ('float32', 'bfloat16'):
        for first in (False, True):
            runs = [fdd.pair_interaction_dual_bwd(*args, *cots,
                                                  first_layer=first,
                                                  dot_dtype=dt)
                    for _ in range(3)]
            same[f'{dt} first={int(first)}'] = all(
                exact(torch, a, b) for r in runs[1:]
                for a, b in zip(runs[0], r))
    emit('dual_bwd_repeats_its_bits', shape=shapes[0], **same)
    check(all(same.values()), f'three K4 launches differ in their bits: {same}')
    return errs


def box_system(n_atoms=BOX_ATOMS, seed=0):
    """The large periodic box of tools/bench_train_large.py: n_atoms at 0.1
    atoms per cubic Angstrom in a cubic cell, z drawn from {1, 1, 8}, and
    energy / force targets, all from numpy with `seed`. -> (z (1, N), pos
    (1, N, 3), cell (1, 3, 3), energy (1,), force (1, N, 3))."""
    import numpy as np
    L = (n_atoms / 0.1) ** (1 / 3)
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 1, 8], size=(1, n_atoms)).astype(np.int32)
    pos = (rs.rand(1, n_atoms, 3) * L).astype(np.float32)
    cell = np.diag([L, L, L]).astype(np.float32)[None]
    energy = np.zeros((1,), np.float32)
    force = rs.randn(1, n_atoms, 3).astype(np.float32)
    return z, pos, cell, energy, force


def lj_periodic(np, pos, box, r_c, eps=0.0104, sigma=3.4):
    """Truncated and shifted Lennard-Jones (argon) energy and forces of one
    cubic box under the minimum image, as tools/make_lj_periodic_dataset.py
    computes its labels."""
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r2 = np.sum(d * d, axis=-1)
    np.fill_diagonal(r2, np.inf)
    inside = r2 < r_c * r_c
    inv6 = np.where(inside, (sigma * sigma / np.where(inside, r2, 1.0)) ** 3,
                    0.0)
    inv12 = inv6 * inv6
    s6 = (sigma / r_c) ** 6
    shift = 4.0 * eps * (s6 * s6 - s6)
    energy = 2.0 * np.sum(eps * 4.0 * 0.5 * (inv12 - inv6)
                          - 0.5 * shift * inside)
    coef = np.where(inside, 4.0 * eps * (12.0 * inv12 - 6.0 * inv6)
                    / np.where(inside, r2, 1.0), 0.0)
    return energy, np.sum(coef[:, :, None] * d, axis=1)


def lj_box(n_atoms=64, n_frames=1, seed=0, cutoff=5.0, density=0.021):
    """Periodic LJ liquid frames packed as tools/make_lj_periodic_dataset.py
    packs them (random positions, 80 damped relaxation steps, a 0.09 A
    jitter), from numpy's default_rng(seed). -> (z (F, N) argon, pos
    (F, N, 3), cell (F, 3, 3), energy (F,), force (F, N, 3)), float64."""
    import numpy as np
    box = (n_atoms / density) ** (1 / 3)
    rng = np.random.default_rng(seed)
    pos, energy, force = [], [], []
    for _ in range(n_frames):
        p = rng.random((n_atoms, 3)) * box
        for _ in range(80):
            _, f = lj_periodic(np, p, box, cutoff)
            p = (p + np.clip(f * 15.0, -0.25, 0.25)) % box
        p = (p + rng.standard_normal((n_atoms, 3)) * 0.09) % box
        e, f = lj_periodic(np, p, box, cutoff)
        pos.append(p)
        energy.append(e)
        force.append(f)
    z = np.full((n_frames, n_atoms), 18, np.int32)
    cell = np.broadcast_to(np.eye(3) * box, (n_frames, 3, 3)).copy()
    return z, np.stack(pos), cell, np.asarray(energy), np.stack(force)


def write_lj_dataset(root, n_frames=LJ_FRAMES, seed=0):
    """lj_box frames as root/raw/lj_liquid.extxyz, in the format of
    tools/make_lj_periodic_dataset.py (positions and forces to 8 decimals,
    energy to 10)."""
    import numpy as np
    z, pos, cell, energy, force = lj_box(n_frames=n_frames, seed=seed)
    os.makedirs(os.path.join(root, 'raw'), exist_ok=True)
    box = cell[0, 0, 0]
    with open(os.path.join(root, 'raw', 'lj_liquid.extxyz'), 'w') as f:
        for p, e, fo in zip(pos, energy, force):
            f.write(f'{len(p)}\n')
            f.write(f'Lattice="{box} 0 0 0 {box} 0 0 0 {box}" '
                    f'Properties=species:S:1:pos:R:3:forces:R:3 '
                    f'energy={e:.10f} pbc="T T T"\n')
            for a, b in zip(p, fo):
                f.write(f'Ar {a[0]:.8f} {a[1]:.8f} {a[2]:.8f} '
                        f'{b[0]:.8f} {b[1]:.8f} {b[2]:.8f}\n')
    return root


def lj_data_settings(root):
    """The `data` section of LJ_CONFIG for write_lj_dataset's frames: its
    batch size 12 and precompute_nlist (mode newton3, k_max 16), prefetch 0
    (the same batches, assembled in the caller's thread), 120 / 15 / 15
    frames."""
    import yaml
    with open(LJ_CONFIG) as f:
        data = yaml.safe_load(f)['data']
    data.update(train_root=root, prefetch=0, train_size=120, val_size=15,
                test_size=15, val_batch_size=15, test_batch_size=15)
    return data


def lj_pallas_data_settings(root, graph_mode):
    """lj_data_settings for phase 9c's kernel='pallas' fine-tuning: no
    precomputed lists for the dense model, plain full lists (the config's
    cutoff and k_max) for the K-list one."""
    data = lj_data_settings(root)
    lists = data.pop('precompute_nlist')
    if graph_mode == 'neighborlist':
        data['precompute_nlist'] = dict(lists, mode='plain')
    return data


def box_stress(seed=0):
    """The box's (1, 3, 3) stress label (eV/A^3) for phase 7h's loss, from
    numpy with `seed` (box_system's labels have none)."""
    import numpy as np
    return (np.random.RandomState(seed + 1).randn(1, 3, 3)
            * 1e-3).astype(np.float32)


def box_weights(torch, core, seed=0):
    """Fill `core` from numpy with `seed`, as flax initializes it: every
    kernel and bias U(+-1/sqrt(fan_in)), the embedding N(0, 1) with row 0
    zeroed; the energy scaler stays at scale 1, shift 0. The box runs on
    such weights, as tools/bench_train_large.py runs it: the trained aspirin
    weights overflow float32 at the random box's 0.2 A contacts."""
    import numpy as np
    rs = np.random.RandomState(seed)
    params = dict(core.named_parameters())
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            if name.startswith('scaler_energy'):
                continue
            if name == 'node_embedding':
                v = rs.randn(*p.shape)
                v[0] = 0.0
            else:
                fan_in = params[name.rsplit('.', 1)[0] + '.kernel'].shape[0]
                bound = fan_in ** -0.5
                v = rs.uniform(-bound, bound, size=tuple(p.shape))
            p.copy_(torch.from_numpy(v))
    return core


def box_model(torch, base_cfg, compute_dtype, output_properties,
              device='cuda', **changes):
    """The checkpoint's widths (F=128, R=20, 3 interactions, cutoff 5 A) in
    neighbour-list mode with k_max BOX_K_MAX and box_weights; `changes`
    (such as inverse_lists=True, or a k_max) on top."""
    from newtonnet_tpu_torch import NewtonNet
    model = NewtonNet(**{**base_cfg, 'graph_mode': 'neighborlist',
                         'k_max': BOX_K_MAX, 'compute_dtype': compute_dtype,
                         'output_properties': output_properties, **changes},
                      device=device)
    box_weights(torch, model.core)
    return model.requires_grad_(False).eval()


def c11_reference():
    """C11_REF: for each (atoms, seed) of C11_BOXES and each stack ('bf16',
    'fp32'), the JAX package's energy, per-atom energies (N,) and forces
    (N, 3) under f'{atoms}_{seed}_{stack}_energy' / '_atom_energy' /
    '_forces'."""
    import numpy as np
    with np.load(C11_REF) as f:
        return {k: f[k] for k in f.files}


def c11_box_requests(torch, model, device='cuda'):
    """model (a box_model over inverse lists) on every C11 box: {(atoms,
    seed): (energy, per-atom energies (N,), forces (N, 3))}, numpy."""
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    got = {}
    for n, seed in C11_BOXES:
        z, pos, cell, _, _ = box_system(n, seed=seed)
        t = [torch.from_numpy(a).to(device) for a in (z, pos, cell)]
        o = model(*t, nlist=host_symmetric_nlist(model, *t, skin=0.0))
        got[(n, seed)] = (float(o['energy'][0]),
                          o['atomic_energy'][0].reshape(-1).cpu().numpy(),
                          o['gradient_force'][0].cpu().numpy())
    return got


def c11_box_stats(np, ref, got):
    """got (c11_box_requests) against the JAX package's bf16 program, in
    units of that program's own bf16-to-fp32 shift, each a root mean square
    over the C11 boxes: of the total energies ('energy'), the per-atom
    energies ('atom_energy') and the force components ('forces'); and the
    JAX shifts themselves (the units, '*_jax_shift')."""
    def rms(parts):
        v = np.concatenate([np.ravel(np.asarray(x, np.float64))
                            for x in parts])
        return float(np.sqrt(np.mean(v * v)))
    out = {}
    for i, key in enumerate(('energy', 'atom_energy', 'forces')):
        diff, shift = [], []
        for n, seed in C11_BOXES:
            j16 = ref[f'{n}_{seed}_bf16_{key}']
            diff.append(got[(n, seed)][i] - j16)
            shift.append(j16 - ref[f'{n}_{seed}_fp32_{key}'])
        out[f'{key}_jax_shift'] = rms(shift)
        out[key] = rms(diff) / out[f'{key}_jax_shift']
    return out


def node_rows_fp8(torch, model):
    """The control of phase 5c's bf16-to-fp32 bar: every layer's
    message_nodepart rows (the rows the layer gathers) rounded through
    float8_e4m3fn. -> the hook handles (remove them to undo)."""
    def hook(module, args, out):
        return out.to(torch.float8_e4m3fn).to(out.dtype)
    return [lp.message_nodepart.register_forward_hook(hook)
            for lp in model.core.interactions()]


def md17_settings(output, epochs):
    '''scripts/config_md17_pallas.yml warm-started from the trained
    checkpoint, on CUDA, with the data of this checkout, `epochs` epochs,
    writing into `output`.'''
    import yaml
    with open(MD17_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cuda', output=output)
    cfg['data'].update(train_root=os.path.dirname(os.path.dirname(XYZ_TRAIN)),
                       test_root=os.path.dirname(os.path.dirname(XYZ)))
    cfg['model']['pretrained_model'] = {'path': CKPT}
    cfg['training']['epochs'] = epochs
    return cfg


def rel_norm(a, b):
    '''||a - b|| / ||b|| over lists of tensors.'''
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y ** 2).sum()) for y in b)
    return (num / den) ** 0.5


def float64_loss(fd, main_loss, batch, model, nlist=None):
    """(loss, one-ulp term) of `batch` through the dense model's plain
    path in float64 (kernel='pallas': the fused layer's plain version;
    kernel='xla' is plain PyTorch): the loss, and (2/B) sum_b |E_b -
    E_ref_b| ulp(E_b), what one float32 ulp of every frame's energy moves
    it by."""
    import numpy as np
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items() if k != 'nlist_stair'}
    plain = {'pair_op': fd.pair_interaction_fwd_ref} \
        if model.kernel == 'pallas' else {'nlist': nlist}
    preds = model.double()(b64['z'], b64['pos'], b64['cell'], **plain)
    e64 = preds['energy'].cpu().numpy()
    err = e64 - b64['energy'].cpu().numpy()
    ulp_term = 2.0 / len(err) * float(
        (abs(err) * abs(np.spacing(e64.astype(np.float32)))).sum())
    return float(main_loss(preds, b64)), ulp_term


def phase_train_steps(torch, fd, fdd):
    '''Phase 7a/b: the first 10 fine-tuning steps against the JAX package's,
    and the first step through the plain path. -> (the model's device
    batch of step 1, the fine-tuned model, its optimizer, main_loss, step
    seconds).'''
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls

    cfg = md17_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])

    def fine_tune_start():
        model = load_model(CKPT).requires_grad_(True)
        set_scalers(model.core, model.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        return model

    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]
    model = fine_tune_start()
    opt = get_optimizer_by_string('adam', model.core, clip_grad=1.0, lr=1e-3)
    losses, norms, step_s, grads1 = [], [], [], None
    with fp32_matmuls():
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = fastgrad.value_and_grad(model, main_loss, b)
            norm = opt.global_norm()
            if grads1 is None:
                grads1 = [p.grad.clone() for p in model.core.parameters()]
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
            norms.append(float(norm))
        rel_loss = [abs(a - b) / b for a, b in zip(losses, JAX_STEP_LOSS)]
        rel_norm_jax = [abs(a - b) / b for a, b in zip(norms,
                                                       JAX_STEP_GRAD_NORM)]
        emit('train_steps', loss=losses, jax_loss=JAX_STEP_LOSS,
             grad_norm=norms, jax_grad_norm=JAX_STEP_GRAD_NORM,
             rel_loss=rel_loss, rel_grad_norm=rel_norm_jax,
             step_ms=[1e3 * t for t in step_s],
             step_ms_median=1e3 * statistics.median(step_s[1:]),
             steps_per_s=1.0 / statistics.median(step_s[1:]))
        check(all(math.isfinite(v) for v in losses + norms),
              'non-finite loss or gradient norm')
        # Step 1's loss is mostly the energy term of energies near -17,600
        # eV, where one float32 ulp is 0.002 eV: two float32 programs that
        # sum the atomic energies in another order land a few ulp apart per
        # frame. One ulp of every frame's energy, all of one sign, moves the
        # loss by (2/B) sum_b |E_b - E_ref_b| ulp(E_b): the bar for step 1,
        # relative to the float64 loss of the same step (plain path), both
        # for the port against the JAX value and for each against float64.
        loss64, ulp_term = float64_loss(fd, main_loss, batches[0],
                                        fine_tune_start())
        bar1 = ulp_term / loss64
        to64 = {'port': abs(losses[0] - loss64) / loss64,
                'jax': abs(JAX_STEP_LOSS[0] - loss64) / loss64}
        emit('train_step1_float64', loss64=loss64, rel_to_float64=to64,
             port_rel_to_jax=rel_loss[0], energy_ulp_loss_term=ulp_term,
             step1_loss_bar=bar1)
        check(max(rel_loss[0], *to64.values()) <= bar1,
              f'step 1 loss {losses[0]} (float64 {loss64})')
        check(rel_norm_jax[0] <= 1e-3, f'step 1 grad norm {norms[0]}')
        check(max(rel_loss[1:]) <= 1e-2, f'steps 2-10 loss {losses}')

        plain = fine_tune_start()
        loss_p, _ = fastgrad.value_and_grad(
            plain, main_loss, batches[0], pair_op=fd.pair_interaction_fwd_ref,
            dual_op=functools.partial(fdd.fused_pair_interaction_dual,
                                      plain=True))
        grads_p = [p.grad for p in plain.core.parameters()]
        rel = rel_norm(grads1, grads_p)
        emit('train_step_vs_plain', loss=losses[0], plain_loss=float(loss_p),
             grad_rel_norm_diff=rel, bar=DUAL_BF16_BAR)
        check(abs(losses[0] - float(loss_p)) <= 1e-5 * float(loss_p),
              'kernel vs plain step loss')
        check(rel <= DUAL_BF16_BAR, f'kernel vs plain gradients: {rel}')
    return batches[0], model, opt, main_loss, step_s


def phase_train_epoch(torch, fd, fdd):
    '''Phase 7c: one epoch through the CLI's entry point, the training main
    path. -> its launch counts.'''
    import csv
    import tempfile
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.train.cli import train_from_settings

    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        fd.reset_launch_counts()
        fdd.reset_launch_counts()
        t = time.perf_counter()
        trainer = train_from_settings(md17_settings(out, 1))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {**fd.LAUNCHES, **fdd.LAUNCHES}
        wgrad = dict(fd.WEIGHT_GRAD_LAUNCHES)
        with open(os.path.join(trainer.output_path, 'log.csv')) as f:
            rows = list(csv.DictReader(f))
        best = load_model(os.path.join(trainer.model_path,
                                       'best_model.msgpack'))
        again = trainer.run_one_epoch(trainer.test_generator, model=best)
    row = rows[0]
    emit('train_epoch', seconds=seconds, rows=[r['epoch'] for r in rows],
         log=row, jax_epoch0_test_force_mae=JAX_EPOCH0_TEST_FORCE_MAE,
         reloaded_best_test=again, launches=launches,
         weight_grad_launches=wgrad)
    check(list(row) == LOG_COLUMNS, f'log.csv columns {list(row)}')
    check([r['epoch'] for r in rows] == ['0', 'last', 'best'],
          'log.csv rows')
    check(all(math.isfinite(float(row[k])) for k in LOG_COLUMNS[1:-1]),
          'non-finite log.csv value')
    check(row['best_model'] == 'True', 'epoch 0 saved no best model')
    for k, v in again.items():
        logged = float(row[f'test_{k}'])
        check(abs(v - logged) <= 1e-5 * abs(logged),
              f'reloaded best model test_{k}: {v} vs {logged}')
    check(all(launches[k] > 0 for k in fp32_names(launches)),
          f'a kernel was not launched on the training path: {launches}')
    check(sum(wgrad.values()) == 0,
          f'K2 computed weight cotangents while training: {wgrad}')
    return launches


KLIST_NAMES = ('klist_fwd', 'klist_fwd_first', 'klist_bwd', 'klist_bwd_first',
               'klist_dual_fwd', 'klist_dual_fwd_first', 'klist_dual_bwd',
               'klist_dual_bwd_first')


def bf16_ulp(torch, x):
    """One bf16 ulp at each element of x: 2^(floor(log2|x|) - 7)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def klist_inputs(torch, B, N, K, F, R, first, edt, seed):
    """K5's inputs, K7's tangents and the cotangents of both, made on the
    card at the scale the model produces; the edge tensors in edt."""
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device='cuda') * scale) \
            .to(dtype)

    C = F if first else 4 * F
    mask = (torch.rand((B, N, K), generator=g, device='cuda') < 0.7).float()
    ins = [rnd(B, N, F, scale=0.3), rnd(B, N, K, C, scale=0.3, dtype=edt),
           rnd(B, N, K, R, scale=0.3, dtype=edt), rnd(B, 3, N, K), mask]
    ins += [rnd(*s, scale=s[0] ** -0.5)
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    tans = [rnd(B, N, F, scale=0.1), rnd(B, N, K, C, scale=0.1, dtype=edt),
            rnd(B, N, K, R, scale=0.1, dtype=edt), rnd(B, 3, N, K, scale=0.1)]
    cots = [rnd(B, N, F), rnd(B, 3, N, F), rnd(B, N, F, scale=0.3),
            rnd(B, 3, N, F, scale=0.3)]
    return ins, tans, cots


def dual_args(ins, tans):
    """K7's argument list from klist_inputs' inputs and tangents."""
    return [ins[0], tans[0], ins[1], tans[1], ins[2], tans[2], ins[3],
            tans[3], ins[4]] + ins[5:]


def klist_calls(fk, ins, tans, cots, first, ref=False):
    """{call: (kernel name, argument list, keywords)} of K5, K6 without and
    with weight cotangents, K7 and K8; ref=True names the plain versions."""
    args = dual_args(ins, tans)
    sfx = '_ref' if ref else ''
    return {
        'klist_fwd': (getattr(fk, 'klist_fwd' + sfx), ins, {}),
        'klist_bwd(wg=0)': (getattr(fk, 'klist_bwd' + sfx), ins + cots[:2],
                            {'weight_grads': False}),
        'klist_bwd(wg=1)': (getattr(fk, 'klist_bwd' + sfx), ins + cots[:2],
                            {'weight_grads': True}),
        'klist_dual_fwd': (getattr(fk, 'klist_dual_fwd' + sfx), args, {}),
        'klist_dual_bwd': (getattr(fk, 'klist_dual_bwd' + sfx), args + cots,
                           {})}


def klist_work(B, N, K, F, R, kind, first, edge_bytes):
    """(flops, bytes) of K5 ('klist_fwd'), K6 without weight cotangents
    ('klist_bwd', the force pass's), K7 ('klist_dual_fwd') or K8
    ('klist_dual_bwd') over the B*N*K list slots: the matrix products as
    layer_work and dual_work count them (K5 2(R*F + 4F^2) per slot) plus the
    per-feature multiply-adds (sigmoids not counted); each input read once
    and each output written once, edge tensors in edge_bytes per value."""
    S, node = B * N * K, B * N * F
    nb = 1 if first else 2
    C = F if first else 4 * F
    w = R * F + nb * 2 * F * F
    edge = S * (C + R)
    if kind == 'klist_fwd':
        flops = S * (2 * R * F + 4 * F + nb * (4 * F * F + 6 * F))
        nbytes = 4 * (node + 4 * S + w + 4 * node) + edge_bytes * edge
    elif kind == 'klist_bwd':
        flops = S * (4 * R * F + 11 * F + nb * (8 * F * F + 12 * F))
        nbytes = (4 * (node + 4 * S + w + 4 * node + node + 3 * S)
                  + edge_bytes * 2 * edge)
    elif kind == 'klist_dual_fwd':
        flops = S * (4 * R * F + 12 * F + nb * (8 * F * F + 14 * F))
        nbytes = 4 * (2 * node + 7 * S + w + 8 * node) + edge_bytes * 2 * edge
    else:
        flops = S * (8 * R * F + 24 * F + nb * (20 * F * F + 40 * F)
                     + (nb - 1) * 4 * F * F)
        nbytes = (4 * (2 * node + 7 * S + w + 8 * node + 2 * node + R * F
                       + 4 * F * F)
                  + edge_bytes * (2 * edge + 2 * S * C))
    return flops, nbytes


def phase_klist_kernels(torch, fk):
    """Phase 3, klist: K5-K8 (K6 with and without weight cotangents) against
    their plain versions, both variants, at the large box's shape with bf16
    edges, two fp32 shapes and a ragged bf16 one at F=32 (N = 61 and K = 39
    no multiple of the 8-atom and 4-slot tiles; K8's grid of at most one
    block per SM then walks several atom tiles per block at the box
    shape). fp32 outputs: max|kernel - plain| <=
    KERNEL_BAR * max|plain|. bf16-stored outputs (dcat, dcatdot, drbf): at
    most one bf16 ulp of the element beyond that, as a last-bit fp32
    difference before the store can round to the neighbouring bf16 value.
    -> {variant: max abs err} at the box shape."""
    errs = {}
    shapes = [(1, BOX_ATOMS, BOX_K_MAX, 128, 20, torch.bfloat16),
              (100, 21, 20, 128, 20, torch.float32),
              (2, 70, 37, 64, 16, torch.float32),
              (3, 61, 39, 32, 12, torch.bfloat16)]
    for si, (B, N, K, F, R, edt) in enumerate(shapes):
        worst = {'fp32': 0.0, 'bf16_stored': 0.0}
        for first in (False, True):
            ins, tans, cots = klist_inputs(torch, B, N, K, F, R, first, edt,
                                           seed=20 + si)
            got = {c: fn(*a, first_layer=first, **kw) for c, (fn, a, kw) in
                   klist_calls(fk, ins, tans, cots, first).items()}
            torch.cuda.synchronize()
            for call, (fn, a, kw) in klist_calls(fk, ins, tans, cots, first,
                                                 ref=True).items():
                want = fn(*a, first_layer=first, **kw)
                kname = call.split('(')[0] + ('_first' if first else '')
                where = f'{call} first={first} at {(B, N, K, F, R)}'
                for k, (x, y) in enumerate(zip(got[call], want)):
                    check((x is None) == (y is None), f'{where} output {k}')
                    if x is None:
                        continue
                    check(x.dtype == y.dtype and x.shape == y.shape,
                          f'{where} output {k}: {x.dtype} {tuple(x.shape)}')
                    check(bool(torch.isfinite(x.float()).all()),
                          f'{where} output {k} not finite')
                    x32, y32 = x.float(), y.float()
                    diff = (x32 - y32).abs()
                    scale = y32.abs().max().item()
                    if x.dtype == torch.bfloat16:
                        key = 'bf16_stored'
                        over = (diff - bf16_ulp(torch, torch.maximum(
                            x32.abs(), y32.abs()))).clamp_min(0).max().item()
                    else:
                        key, over = 'fp32', diff.max().item()
                    ratio = over / scale if scale else over
                    check(ratio <= KERNEL_BAR,
                          f'{where} output {k}: {ratio} > {KERNEL_BAR}')
                    worst[key] = max(worst[key], ratio)
                    if si == 0:
                        errs[kname] = max(errs.get(kname, 0.0),
                                          diff.max().item())
                del want
            del got, ins, tans, cots
            torch.cuda.empty_cache()
        emit('klist_vs_plain', shape=dict(B=B, N=N, K=K, F=F, R=R),
             edge_dtype=str(edt).split('.')[-1], worst_err_over_max=worst,
             bar=KERNEL_BAR, bf16_stored_bar='one bf16 ulp + bar')
    # three K5 launches and three K7 launches at the box shape give equal
    # bits
    B, N, K, F, R, edt = shapes[0]
    for call, kname in (('klist_fwd', 'K5'), ('klist_dual_fwd', 'K7')):
        same = {}
        for first in (False, True):
            ins, tans, cots = klist_inputs(torch, B, N, K, F, R, first, edt,
                                           seed=20)
            fn, a, kw = klist_calls(fk, ins, tans, cots, first)[call]
            runs = [fn(*a, first_layer=first, **kw) for _ in range(3)]
            same[f'first={int(first)}'] = all(
                exact(torch, x, y) for r in runs[1:]
                for x, y in zip(runs[0], r))
            del ins, tans, cots, runs
            torch.cuda.empty_cache()
        emit(f'{call}_repeats_its_bits', shape=dict(B=B, N=N, K=K, F=F, R=R),
             **same)
        check(all(same.values()),
              f'three {kname} launches differ in their bits: {same}')
    # and three K6 launches, with and without weight cotangents (its weight
    # partials are summed in a fixed order)
    same = {}
    for first in (False, True):
        ins, tans, cots = klist_inputs(torch, B, N, K, F, R, first, edt,
                                       seed=20)
        calls = klist_calls(fk, ins, tans, cots, first)
        for wg in (0, 1):
            fn, a, kw = calls[f'klist_bwd(wg={wg})']
            runs = [fn(*a, first_layer=first, **kw) for _ in range(3)]
            same[f'first={int(first)} wg={wg}'] = all(
                exact(torch, x, y) for r in runs[1:]
                for x, y in zip(runs[0], r) if x is not None)
            del runs
        del ins, tans, cots, calls
        torch.cuda.empty_cache()
    emit('klist_bwd_repeats_its_bits', shape=dict(B=B, N=N, K=K, F=F, R=R),
         **same)
    check(all(same.values()), f'three K6 launches differ in their bits: {same}')
    return errs


def klist_model(torch, base, **changes):
    """The checkpoint's weights in a neighbour-list model on the card."""
    from newtonnet_tpu_torch import NewtonNet
    cfg = dict(base.config_dict(), graph_mode='neighborlist', **changes)
    model = NewtonNet(**cfg, device='cuda')
    model.load_state_dict(base.state_dict())
    return model.requires_grad_(False).eval()


def plain_klist(fk):
    return functools.partial(fk.fused_klist_interaction, plain=True)


def phase_serve_nlist(torch, fk, base, batches, to_dev, served):
    """Phase 4b: the 500 aspirin test frames through the checkpoint in
    neighbour-list mode (fp32 edges, K = 20) in batches of 100: the JAX
    package's MAE bars, and phase 4's dense kernel path at E_ATOL /
    F_ATOL. -> the launch counts of the 500 frames."""
    import numpy as np
    from newtonnet_tpu_torch.ops.nlist import neighbor_list
    model = klist_model(torch, base)
    model(*to_dev(batches[0]))  # first use loads the library
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    out_nl, batch_s = [], []
    for b in batches:
        t = time.perf_counter()
        out = model(*to_dev(b))
        out_nl.append((out['energy'].cpu().numpy(),
                       out['gradient_force'].cpu().numpy()))
        batch_s.append(time.perf_counter() - t)
    launches = dict(fk.LAUNCHES)
    overflow = 0
    for b in batches:
        z, pos, cell = to_dev(b)
        overflow += int(neighbor_list(pos, cell, z > 0, model.cutoff,
                                      model.k_max)[3].sum())
    ae = af = 0.0
    e_diff = f_diff = 0.0
    for b, (e, f), (ed, fd_) in zip(batches, out_nl, served):
        check(np.isfinite(e).all() and np.isfinite(f).all(),
              'non-finite neighbour-list output')
        ae += np.abs(e - b['energy']).astype(np.float64).sum()
        af += np.abs(f - b['force']).astype(np.float64).sum()
        e_diff = max(e_diff, float(np.abs(e - ed).max()))
        f_diff = max(f_diff, float(np.abs(f - fd_).max()))
    e_mae, f_mae = ae / 500, af / (500 * 21 * 3)
    emit('serve_nlist', frames=500, batch=100, k=min(model.k_max, 20),
         energy_mae=e_mae, force_mae=f_mae, jax_energy_mae=JAX_ENERGY_MAE,
         jax_force_mae=JAX_FORCE_MAE, energy_max_abs_diff_vs_dense=e_diff,
         force_max_abs_diff_vs_dense=f_diff, overflow=overflow,
         batch_ms_median=1e3 * statistics.median(batch_s),
         launches=launches)
    check(abs(e_mae - JAX_ENERGY_MAE) <= 5e-4, f'nlist energy MAE {e_mae}')
    check(abs(f_mae - JAX_FORCE_MAE) <= 5e-5, f'nlist force MAE {f_mae}')
    check(e_diff <= E_ATOL and f_diff <= F_ATOL, 'nlist vs dense serving')
    check(overflow == 0, f'aspirin lists overflowed: {overflow}')
    check(all(launches[k] > 0 for k in KLIST_NAMES[:4]),
          f'a K5/K6 variant was not launched serving: {launches}')
    return launches


def phase_box_request(torch, fk, base):
    """Phase 5b: calculator requests (energy, forces, stress) on the
    4096-atom box: box_model (k_max 88, bf16 edges), served from a
    checkpoint file. Held against the plain path on the card, and on the
    512-atom box against the JAX package's numbers, at bars of
    BOX_SPREAD_FACTOR times the bf16-to-fp32-edge spread. -> (per-request
    launch counts, the calculator, the request's arguments)."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.ops.nlist import neighbor_list
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    outs = ['energy', 'gradient_force', 'stress']
    box = box_model(torch, base.config_dict(), 'bfloat16', outs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'box.msgpack')
        save_model(path, box)
        calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                     'stress'])
    z, pos, cell, _, _ = box_system()
    request = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    calc.calculate(**request)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    lat, forces, n_req = [], [], 3
    for _ in range(n_req):
        t = time.perf_counter()
        r = calc.calculate(**request)
        lat.append(time.perf_counter() - t)
        forces.append(r['forces'])
    launches = {k: v // n_req for k, v in fk.LAUNCHES.items()}
    # gather_nodes' backward sums in a fixed order (no atomics): the
    # requests' forces repeat their bits (ROADMAP.md C4)
    repeats = all(np.array_equal(forces[0], x) for x in forces[1:])
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (z, pos, cell)]
    _, kmask, _, over = neighbor_list(tpos, tcell, tz > 0, box.cutoff,
                                      BOX_K_MAX)
    overflow, n_edges = int(over.sum()), int(kmask.sum())
    plain = box(tz, tpos, tcell, pair_op=plain_klist(fk))
    p32 = box_model(torch, base.config_dict(), '', outs)(
        tz, tpos, tcell, pair_op=plain_klist(fk))
    e, f = r['energy'], r['forces']
    e_p = float(plain['energy'][0])
    f_p = plain['gradient_force'][0].cpu().numpy()
    e_32 = float(p32['energy'][0])
    f_32 = p32['gradient_force'][0].cpu().numpy()
    s_p = plain['stress'][0].cpu().numpy()
    voigt = s_p[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
    # the 512-atom box against the JAX package's numbers
    z5, pos5, cell5, _, _ = box_system(BOX_REF_ATOMS)
    r5 = calc.calculate(numbers=z5[0], positions=pos5[0], cell=cell5[0])
    jf8 = np.asarray(JAX_BOX_FORCES_8)
    jf8_32 = np.asarray(JAX_BOX_FP32_EDGES_FORCES_8)
    k = BOX_SPREAD_FACTOR
    bars = {'energy_vs_plain': k * abs(e_p - e_32),
            'forces_vs_plain': k * float(np.abs(f_p - f_32).max()),
            'energy_512_vs_jax': k * abs(JAX_BOX_ENERGY
                                         - JAX_BOX_FP32_EDGES_ENERGY),
            'forces8_512_vs_jax': k * float(np.abs(jf8 - jf8_32).max())}
    diffs = {'energy_vs_plain': abs(e - e_p),
             'forces_vs_plain': float(np.abs(f - f_p).max()),
             'energy_512_vs_jax': abs(r5['energy'] - JAX_BOX_ENERGY),
             'forces8_512_vs_jax': float(np.abs(r5['forces'][:8] - jf8)
                                         .max())}
    emit('box_request', atoms=BOX_ATOMS, k_max=BOX_K_MAX, edges=n_edges,
         overflow=overflow, energy=e, plain_energy=e_p,
         plain_fp32_edges_energy=e_32,
         forces_max_abs=float(np.abs(f).max()),
         energy_512=r5['energy'], jax_energy_512=JAX_BOX_ENERGY,
         diffs=diffs, bars=bars,
         stress_vs_plain=float(np.abs(r['stress'] - voigt).max()),
         stress_max_abs=float(np.abs(voigt).max()),
         latency_ms=[1e3 * t for t in lat],
         latency_ms_median=1e3 * statistics.median(lat),
         forces_repeat_their_bits=repeats,
         launches_per_request=launches)
    check(np.isfinite(e) and np.isfinite(f).all()
          and np.isfinite(r['stress']).all(), 'box request not finite')
    check(overflow == 0, f'box lists overflowed: {overflow}')
    check(repeats, 'three box requests gave forces of different bits')
    for key, d in diffs.items():
        check(d <= bars[key], f'box {key}: {d} > {bars[key]}')
    check(all(launches[k] > 0 for k in KLIST_NAMES[:4]),
          f'a K5/K6 variant was not launched on the box: {launches}')
    timing = {'latency_ms_median': 1e3 * statistics.median(lat)}
    return launches, calc, request, {'energy': e, 'forces': f,
                                     'energy_fp32': e_32,
                                     'forces_fp32': f_32, **timing}


def phase_box_train(torch, fk, base, dot_dtype='float32'):
    """Phase 7e (and 11d with dot_dtype bfloat16: K5-K8 in bf16 mode):
    three fastgrad steps with Adam (lr 1e-3, no clip) on the box, as
    tools/bench_train_large.py takes them: box_model (bf16 edges,
    pallas_dot_dtype dot_dtype), targets from box_system's seed. Step 1's
    gradient is held against the plain path on the card at 2e-3 relative
    norm; three gradients from one start repeat their bits; a step launches
    every K5-K8 variant of its mode and no other. -> (per-step launch
    counts, one_step, step seconds)."""
    import math as _math
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    z, pos, cell, energy, force = box_system()
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             (('z', z), ('pos', pos), ('cell', cell), ('energy', energy),
              ('force', force))}
    batch['graph_mask'] = torch.ones(1, dtype=torch.bool, device='cuda')
    main_loss, _ = get_loss_by_string({'energy': {'weight': 1.0},
                                       'gradient_force': {'weight': 50.0}})

    def start():
        return box_model(torch, base.config_dict(), 'bfloat16',
                         ['energy', 'gradient_force'],
                         pallas_dot_dtype=dot_dtype).requires_grad_(True)

    model = start()
    opt = get_optimizer_by_string('adam', model.core, lr=1e-3)
    losses, step_s, grads1, launches = [], [], None, None
    with fp32_matmuls():
        for k in range(3):
            torch.cuda.synchronize()
            if k == 2:
                fk.reset_launch_counts()
            t = time.perf_counter()
            loss, _ = fastgrad.value_and_grad(model, main_loss, batch)
            if grads1 is None:
                grads1 = [p.grad.clone() for p in model.core.parameters()]
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            if k == 2:
                launches = dict(fk.LAUNCHES)
            losses.append(float(loss))
        plain = start()
        loss_p, _ = fastgrad.value_and_grad(
            plain, main_loss, batch, pair_op=plain_klist(fk),
            dual_op=functools.partial(fk.fused_klist_interaction_dual,
                                      plain=True))
        rel = rel_norm(grads1, [p.grad for p in plain.core.parameters()])
        del plain
        # three gradients from the same start: the same bits (C4)
        again = []
        for _ in range(3):
            fresh = start()
            fastgrad.value_and_grad(fresh, main_loss, batch)
            again.append([p.grad.clone() for p in fresh.core.parameters()])
            del fresh
        repeats = all(exact(torch, a, b) for g in again[1:]
                      for a, b in zip(again[0], g))
        del again

    def one_step():
        with fp32_matmuls():
            fastgrad.value_and_grad(model, main_loss, batch)
            opt.step()
    bf = dot_dtype == 'bfloat16'
    emit('bf16_box_train' if bf else 'box_train', atoms=BOX_ATOMS, steps=3,
         loss=losses, plain_loss=float(loss_p),
         grad_rel_norm_diff_vs_plain=rel, bar=2e-3,
         step_ms=[1e3 * t for t in step_s],
         step_ms_after_first=1e3 * statistics.median(step_s[1:]),
         gradients_repeat_their_bits=repeats, launches_per_step=launches)
    check(all(_math.isfinite(v) for v in losses), f'box losses {losses}')
    check(repeats, 'three box gradients from one start differ in their bits')
    check(rel <= 2e-3, f'box step 1 gradient vs plain: {rel}')
    names = BF16_KLIST + BF16_DUAL if bf else KLIST_NAMES
    check({k for k, v in launches.items() if v} == set(names),
          f'a box step launched {launches}, not every one of {names}')
    return launches, one_step, step_s


def phase_train_nlist_steps(torch, fd, fk):
    """Phase 7d a/b: the first 10 neighbour-list fine-tuning steps against
    the JAX package's, and step 1's gradient against the dense port path
    with fp32 duals on the same batch (the same function: all 20
    neighbours of each atom fit in the list)."""
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.models.fused_stack import apply_core
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    cfg = md17_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])

    def fine_tune_start(**changes):
        base = load_model(CKPT)
        model = NewtonNet(**dict(base.config_dict(), **changes),
                          device='cuda')
        model.load_state_dict(base.state_dict())
        set_scalers(model.core, model.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        return model.requires_grad_(True)

    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]
    model = fine_tune_start(graph_mode='neighborlist')
    opt = get_optimizer_by_string('adam', model.core, clip_grad=1.0, lr=1e-3)
    losses, norms, step_s, grads1, e1 = [], [], [], None, None
    with fp32_matmuls():
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, preds = fastgrad.value_and_grad(model, main_loss, b)
            norm = opt.global_norm()
            if grads1 is None:
                grads1 = [p.grad.clone() for p in model.core.parameters()]
                e1 = preds['energy']
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
            norms.append(float(norm))
        rel_loss = [abs(a - b) / b for a, b in zip(losses,
                                                   JAX_NLIST_STEP_LOSS)]
        rel_gn = [abs(a - b) / b for a, b in zip(norms,
                                                 JAX_NLIST_STEP_GRAD_NORM)]
        # step 1's bar as phase 7's, from the dense plain path in float64
        # (the same function)
        loss64, ulp_term = float64_loss(fd, main_loss, batches[0],
                                        fine_tune_start())
        bar1 = ulp_term / loss64
        # b: the dense path, fp32 duals, same batch. Its energies differ
        # from these by float32 rounding (a few ulp of -17,600 eV), which
        # changes e_bar = dL/dE by de; the gradient then moves by
        # grad_theta(de . E) on top of the products' own rounding: the bar
        # is 1e-4 plus that term's norm relative to the gradient's
        dense = fine_tune_start(pallas_grad_dot_dtype='float32')
        loss_d, preds_d = fastgrad.value_and_grad(dense, main_loss,
                                                  batches[0])
        grads_d = [p.grad.clone() for p in dense.core.parameters()]
        rel = rel_norm(grads1, grads_d)
        with torch.enable_grad():
            bar_e = []
            for e in (e1, preds_d['energy']):
                e = e.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(main_loss(
                    {'energy': e, 'gradient_force': preds_d['gradient_force']},
                    batches[0]), e)
                bar_e.append(g)
            de = (bar_e[0] - bar_e[1]).detach()
            for p in dense.core.parameters():
                p.grad = None
            out = apply_core(dense.core, batches[0]['z'], batches[0]['pos'],
                             batches[0]['cell'], dense.cutoff)
            torch.dot(de, out['atomic_energy'][..., 0].sum(-1)).backward()
        e_term = (sum(float((p.grad ** 2).sum())
                      for p in dense.core.parameters())
                  / sum(float((g ** 2).sum()) for g in grads_d)) ** 0.5
    bar_b = 1e-4 + e_term
    emit('train_nlist_steps', loss=losses, jax_loss=JAX_NLIST_STEP_LOSS,
         grad_norm=norms, jax_grad_norm=JAX_NLIST_STEP_GRAD_NORM,
         rel_loss=rel_loss, rel_grad_norm=rel_gn, step1_loss_bar=bar1,
         loss64=loss64, step_ms=[1e3 * t for t in step_s],
         step_ms_median=1e3 * statistics.median(step_s[1:]),
         dense_loss=float(loss_d), grad_rel_norm_diff_vs_dense=rel,
         vs_dense_bar=bar_b, energy_residual_term=e_term)
    check(all(math.isfinite(v) for v in losses + norms),
          'non-finite neighbour-list loss or gradient norm')
    check(max(rel_loss[0], abs(losses[0] - loss64) / loss64) <= bar1,
          f'nlist step 1 loss {losses[0]} (float64 {loss64})')
    check(rel_gn[0] <= 1e-3, f'nlist step 1 grad norm {norms[0]}')
    check(max(rel_loss[1:]) <= 1e-2, f'nlist steps 2-10 loss {losses}')
    check(rel <= bar_b, f'nlist vs dense step 1 gradient: {rel} > {bar_b}')
    return step_s


def phase_train_nlist_epoch(torch, fk, fd, fdd):
    """Phase 7d c: one epoch at train_size 100 (10 steps) with val and test
    through train_from_settings, from the checkpoint in neighbour-list mode.
    -> its launch counts."""
    import csv
    import tempfile
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.train.cli import train_from_settings
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    with tempfile.TemporaryDirectory() as out:
        start = os.path.join(out, 'nlist_start.msgpack')
        save_model(start, klist_model(torch, load_model(CKPT)))
        cfg = md17_settings(out, 1)
        cfg['data']['train_size'] = 100
        cfg['model']['graph_mode'] = 'neighborlist'
        cfg['model']['pretrained_model'] = {'path': start}
        torch.cuda.synchronize()
        for mod in (fk, fd, fdd):
            mod.reset_launch_counts()
        t = time.perf_counter()
        trainer = train_from_settings(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(fk.LAUNCHES)
        dense = {**fd.LAUNCHES, **fdd.LAUNCHES}
        wgrad = dict(fk.WEIGHT_GRAD_LAUNCHES)
        with open(os.path.join(trainer.output_path, 'log.csv')) as f:
            rows = list(csv.DictReader(f))
        best = load_model(os.path.join(trainer.model_path,
                                       'best_model.msgpack'))
        again = trainer.run_one_epoch(trainer.test_generator, model=best)
    row = rows[0]
    emit('train_nlist_epoch', seconds=seconds, steps=row['step'], log=row,
         reloaded_best_test=again, launches=launches,
         weight_grad_launches=wgrad, dense_launches=dense)
    check(list(row) == LOG_COLUMNS, f'log.csv columns {list(row)}')
    check([r['epoch'] for r in rows] == ['0', 'last', 'best'],
          'log.csv rows')
    check(row['step'] == '10', f'expected 10 steps, got {row["step"]}')
    check(all(math.isfinite(float(row[k])) for k in LOG_COLUMNS[1:-1]),
          'non-finite log.csv value')
    check(best.graph_mode == 'neighborlist', 'best model lost its lists')
    for k, v in again.items():
        logged = float(row[f'test_{k}'])
        check(abs(v - logged) <= 1e-5 * abs(logged),
              f'reloaded best model test_{k}: {v} vs {logged}')
    check(all(launches[k] > 0 for k in KLIST_NAMES),
          f'a K5-K8 variant was not launched training: {launches}')
    check(sum(wgrad.values()) == 0,
          f'K6 computed weight cotangents while training: {wgrad}')
    check(sum(dense.values()) == 0, f'a dense kernel ran: {dense}')
    return launches


def klist_timing(torch, fk, errs, launches, train_launches):
    """Each K5-K8 variant at the box shape (bf16 edges), the force pass's K6
    (no weight cotangents): CUDA-event times, the plain versions', and the
    bound from klist_work; K5/K6 rows also give their launches in the
    list-mode training epoch. -> the `kernels` rows."""
    B, N, K, F, R = 1, BOX_ATOMS, BOX_K_MAX, 128, 20
    rows = []
    for first in (False, True):
        ins, tans, cots = klist_inputs(torch, B, N, K, F, R, first,
                                       torch.bfloat16, seed=30)
        calls = klist_calls(fk, ins, tans, cots, first)
        refs = klist_calls(fk, ins, tans, cots, first, ref=True)
        for call in ('klist_fwd', 'klist_bwd(wg=0)', 'klist_dual_fwd',
                     'klist_dual_bwd'):
            kind = call.split('(')[0]
            name = kind + ('_first' if first else '')

            def run(entry):
                fn, a, kw = entry
                return lambda: fn(*a, first_layer=first, **kw)
            plain1 = time_ms(torch, run(refs[call]), inner=3)
            ms = time_ms(torch, run(calls[call]), inner=3)
            ms2 = time_ms(torch, run(calls[call]), inner=3)
            plain2 = time_ms(torch, run(refs[call]), inner=3)
            flops, nbytes = klist_work(B, N, K, F, R, kind, first, 2)
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
            rows.append({
                'name': name, 'route': 'cuda', 'source': SOURCES['klist'],
                'replaces': REPLACES[name], 'launches': launches[name],
                'max_abs_err': errs[name],
                'ms': statistics.median([ms, ms2]),
                'plain_ms': statistics.median([plain1, plain2]),
                'bound_ms': 1e3 * max(t_ops, t_bytes),
                'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
                'library_ms': None, 'flops': flops, 'bytes': nbytes,
                'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2]})
            # three tf32 products per fp32 one
            rows[-1]['tc_3xtf32_bound_ms'] = 1e3 * 3 * flops / PEAK_TF32_FLOPS
            if kind in ('klist_fwd', 'klist_bwd'):
                rows[-1]['train_launches'] = train_launches[name]
        del ins, tans, cots, calls, refs
        torch.cuda.empty_cache()
    rows.sort(key=lambda r: KLIST_NAMES.index(r['name']))
    emit('timing', shape=dict(B=B, N=N, K=K, F=F, R=R), what='K5-K8',
         edge_dtype='bfloat16', weight_grads=False,
         peak_fp32_tflops=PEAK_FP32_FLOPS / 1e12)
    return rows


def tf32_pinned(torch, what, calc, request):
    """C6: one calculator request with both TF32 flags switched on by the
    caller gives the bits of one with them off (the calculator pins IEEE
    fp32 products, as the JAX calculator pins 'highest'); the flags are
    left off, as main sets them."""
    import numpy as np
    out = {}
    for on in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        out[on] = calc.calculate(**request)
    same = all(np.array_equal(np.asarray(out[True][k]),
                              np.asarray(out[False][k])) for k in out[False])
    emit('tf32_pinned', what=what, same_bits=same)
    check(same, f'{what}: TF32 switched on changed the result')


def exact(torch, a, b):
    """True iff a and b hold the same bits (NaN-free values)."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def window_list(torch, n_atoms=BOX_ATOMS):
    """The cell-sorted box (tools/bench_window.py's recipe on box_system):
    the port's full list (k_max BOX_K_MAX, cutoff 5 A) in the K-major
    layout, masked slots pointed at their block's window start, and the
    smallest multiple of WINDOW_T that check_window passes. -> (idx_kn
    (1, K, N) int64, mask_kn, W, window_margin, valid edges)."""
    from newtonnet_tpu_torch.ops import window as wn
    from newtonnet_tpu_torch.ops.nlist import neighbor_list
    z, pos, cell, _, _ = box_system(n_atoms)
    order = wn.cell_sort_order(pos[0], cell[0], 5.0)
    tz, tpos, tcell = [torch.from_numpy(a).cuda()
                       for a in (z[:, order], pos[:, order], cell)]
    idx, kmask, _, over = neighbor_list(tpos, tcell, tz > 0, 5.0, BOX_K_MAX)
    check(int(over.sum()) == 0, 'window list overflowed')
    idx_kn = idx.transpose(1, 2).contiguous()
    mask_kn = kmask.transpose(1, 2).contiguous()
    N = n_atoms
    for W in range(WINDOW_T, N + 1, WINDOW_T):
        starts = torch.tensor(wn.window_starts(N, W, WINDOW_T),
                              device='cuda').repeat_interleave(WINDOW_T)
        cand = torch.where(mask_kn, idx_kn, starts[None, None])
        if wn.check_window(cand, mask_kn, W, WINDOW_T):
            return cand, mask_kn, W, wn.window_margin(cand, mask_kn, W,
                                                      WINDOW_T), \
                int(mask_kn.sum())
    raise PhaseFailed('no window holds the box list')


def phase_gather_kernels(torch, rg, wn):
    """Phase 3e: K9 (row_gather) and K12 (its B = 1 form) against the plain
    row gather, bitwise, at the shapes of their paths; K10 against its
    plain version bitwise and K11 within 1e-6 of the largest magnitude
    plus one ulp of the output dtype, on the cell-sorted box; the
    transposition identity in float64 over the card's outputs; then the
    window ops' entry point (gather and its backward) with the launch
    counts. -> ({kernel row: max abs err}, window path launches, the
    window list)."""
    g = torch.Generator(device='cuda').manual_seed(40)
    N = BOX_ATOMS
    cases = [  # (what, B, N, F, R, dtype, index dtype)
        ('box inv_gather, 4F', 1, N, 4 * 128, BOX_K_MAX * N, torch.bfloat16,
         torch.int64),
        ('box inv_gather, F', 1, N, 128, BOX_K_MAX * N, torch.bfloat16,
         torch.int64),
        ('box inv_gather fp32, 4F', 1, N, 4 * 128, BOX_K_MAX * N,
         torch.float32, torch.int64),
        ('box scatter chunk', 1, 6 * N, 4 * 128, 6 * N, torch.bfloat16,
         torch.int64),
        ('box positions', 1, N, 3, BOX_K_MAX * N, torch.float32,
         torch.int64),
        ('aspirin, 4F', 100, 21, 512, INV_K_MAX * 21, torch.float32,
         torch.int64),
        ('aspirin, F', 100, 21, 128, INV_K_MAX * 21, torch.float32,
         torch.int32),
        ('odd', 3, 21, 3, 1001, torch.float32, torch.int32),
        ('odd bf16', 2, 33, 5, 777, torch.bfloat16, torch.int64),
        ('K12 exp_pallas_gather bf16', 1, EXP_GATHER_N, EXP_GATHER_F,
         EXP_GATHER_ROWS, torch.bfloat16, torch.int32),
        ('K12 exp_pallas_gather fp32', 1, EXP_GATHER_N, EXP_GATHER_F,
         EXP_GATHER_ROWS, torch.float32, torch.int32)]
    results = []
    for what, B, n, F, R, dt, it in cases:
        x = torch.randn((B, n, F), generator=g, device='cuda').to(dt)
        idx = torch.randint(0, n, (B, R), generator=g, device='cuda').to(it)
        got = rg.row_gather(x, idx)
        torch.cuda.synchronize()
        same = exact(torch, got, rg.row_gather_ref(x, idx))
        results.append({'what': what, 'shape': [B, n, F, R],
                        'dtype': str(dt).split('.')[-1], 'bitwise': same})
        check(same, f'K9 {what}: kernel and plain gather differ')
        del x, idx, got
    emit('gather_vs_plain', cases=results, bar='bitwise')

    idx_kn, mask_kn, W, margin, n_edges = window_list(torch)
    K = idx_kn.shape[1]
    x = torch.randn((1, N, WINDOW_F), generator=g, device='cuda') \
        .to(torch.bfloat16)
    y = (torch.randn((1, K, N, WINDOW_F), generator=g, device='cuda')
         * mask_kn[..., None]).to(torch.bfloat16)
    errs = {}
    got = wn.window_gather_fwd(x, idx_kn, W, WINDOW_T)
    torch.cuda.synchronize()
    check(exact(torch, got, wn.window_gather_ref(x, idx_kn, W, WINDOW_T)),
          'K10: kernel and plain differ')
    errs['window_gather'] = 0.0
    got32 = wn.window_gather_fwd(x.float(), idx_kn, W, WINDOW_T)
    check(exact(torch, got32, wn.window_gather_ref(x.float(), idx_kn, W,
                                                   WINDOW_T)),
          'K10 (fp32 payload): kernel and plain differ')
    del got, got32
    worst = 0.0
    k11_same = {}  # three launches give equal bits
    for dt in (torch.bfloat16, torch.float32):
        yd = y.to(dt)
        s = wn.window_scatter_sum_fwd(yd, idx_kn, W, WINDOW_T).float()
        want = wn.window_scatter_sum_ref(yd, idx_kn, W, WINDOW_T).float()
        diff = (s - want).abs()
        over = (diff - torch.finfo(dt).eps * want.abs()).clamp_min(0).max()
        scale = want.abs().max().item()
        worst = max(worst, over.item() / scale)
        check(over.item() <= 1e-6 * scale,
              f'K11 {dt}: {over.item()} > 1e-6 * {scale} beyond one ulp')
        if dt == torch.bfloat16:
            errs['window_scatter_sum'] = diff.max().item()
        runs = [s] + [wn.window_scatter_sum_fwd(yd, idx_kn, W, WINDOW_T)
                      .float() for _ in range(2)]
        k11_same[str(dt).split('.')[-1]] = all(exact(torch, runs[0], r)
                                               for r in runs[1:])
        del yd, s, want, diff, runs
    # the transposition identity over bf16-exact payloads in fp32 storage
    gx = wn.window_gather_fwd(x.float(), idx_kn, W, WINDOW_T).double()
    sy = wn.window_scatter_sum_fwd(y.float(), idx_kn, W, WINDOW_T).double()
    lhs = float((gx * y.double()).sum())
    rhs = float((x.double() * sy).sum())
    rel_t = abs(lhs - rhs) / abs(lhs)
    del gx, sy
    # the entry point: the gather and, through autograd, its transpose
    torch.cuda.synchronize()
    wn.reset_launch_counts()
    xg = x.clone().requires_grad_(True)
    out = wn.window_gather(xg, idx_kn, W, WINDOW_T)
    (out.float() * y.float()).sum().backward()
    torch.cuda.synchronize()
    launches = dict(wn.LAUNCHES)
    emit('window_vs_plain', atoms=N, k=K, valid_edges=n_edges, W=W,
         T=WINDOW_T, F=WINDOW_F, window_margin=margin,
         k10='bitwise (bf16 and fp32 payloads)',
         k11_worst_over_max_beyond_ulp=worst, k11_bar=1e-6,
         k11_repeats_its_bits=k11_same,
         transposition_rel_diff=rel_t, transposition_bar=1e-6,
         entry_point_launches=launches)
    check(all(k11_same.values()),
          f'three K11 launches differ in their bits: {k11_same}')
    check(margin >= 0, f'window margin {margin}')
    check(rel_t <= 1e-6, f'<gather(x), y> != <x, scatter(y)>: {rel_t}')
    check(exact(torch, xg.grad, wn.window_scatter_sum_fwd(
        y, idx_kn, W, WINDOW_T)), 'window_gather backward is not K11')
    check(all(v > 0 for v in launches.values()),
          f'a window kernel was not launched: {launches}')
    return errs, launches, (idx_kn, mask_kn, W)


def xla_model(torch, base, **changes):
    """The XLA checkpoint's weights in a model of another layout."""
    from newtonnet_tpu_torch import NewtonNet
    model = NewtonNet(**dict(base.config_dict(), **changes), device='cuda')
    model.load_state_dict(base.state_dict())
    return model.requires_grad_(False).eval()


def mae(batches, outs):
    import numpy as np
    ae = af = 0.0
    for b, (e, f) in zip(batches, outs):
        check(np.isfinite(e).all() and np.isfinite(f).all(),
              'non-finite XLA output')
        ae += np.abs(e - b['energy']).astype(np.float64).sum()
        af += np.abs(f - b['force']).astype(np.float64).sum()
    n = sum(len(b['energy']) for b in batches)
    return ae / n, af / (n * 21 * 3)


def phase_serve_xla(torch, rg, batches, samples, to_dev):
    """Phase 4c: the trained kernel='xla' checkpoint on the 500 aspirin
    frames, dense and in inverse-list mode (host_symmetric_nlist, k_max
    INV_K_MAX), each against the JAX package's MAEs; inverse lists against
    the dense XLA path (E_ATOL, F_ATOL) and against their plain row gather
    (bitwise); then 20 calculator requests in inverse-list mode against
    the batches. -> K9 launches of the 500 frames."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    base = load_model(XLA_CKPT)
    check(base.kernel == 'xla' and base.graph_mode == 'dense',
          f'the XLA checkpoint loaded as {base.kernel}/{base.graph_mode}')
    base(*to_dev(batches[0]))
    dense, dense_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = base(*to_dev(b))
        dense.append((out['energy'].cpu().numpy(),
                      out['gradient_force'].cpu().numpy()))
        dense_s.append(time.perf_counter() - t)
    e_mae, f_mae = mae(batches, dense)
    inv = xla_model(torch, base, graph_mode='neighborlist', k_max=INV_K_MAX,
                    inverse_lists=True)
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    served, lists, inv_s, list_s = [], [], [], []
    for b in batches:
        z, pos, cell = to_dev(b)
        t = time.perf_counter()
        nl = host_symmetric_nlist(inv, z, pos, cell, skin=0.0)
        t1 = time.perf_counter()
        out = inv(z, pos, cell, nlist=nl)
        served.append((out['energy'].cpu().numpy(),
                       out['gradient_force'].cpu().numpy()))
        t2 = time.perf_counter()
        lists.append(nl)
        list_s.append(t1 - t)
        inv_s.append(t2 - t)
    launches = dict(rg.LAUNCHES)
    ie_mae, if_mae = mae(batches, served)
    same_bits = True
    for b, nl, (e, f) in zip(batches, lists, served):
        out = inv(*to_dev(b), nlist=nl, plain=True)
        same_bits &= (np.array_equal(out['energy'].cpu().numpy(), e)
                      and np.array_equal(
                          out['gradient_force'].cpu().numpy(), f))
    e_diff = max(float(np.abs(a[0] - d[0]).max())
                 for a, d in zip(served, dense))
    f_diff = max(float(np.abs(a[1] - d[1]).max())
                 for a, d in zip(served, dense))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'inv.msgpack')
        save_model(path, inv)
        calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                     'stress', 'virial'])
    box = 30.0 * np.eye(3)
    r_e = r_f = r_s = 0.0
    lat = []
    e_ref, f_ref = served[0]
    for k in range(20):
        s = samples[k]
        t = time.perf_counter()
        r = calc.calculate(numbers=s['z'], positions=s['pos'],
                           cell=box if k >= 10 else None)
        lat.append(time.perf_counter() - t)
        check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all(),
              f'XLA request {k} not finite')
        r_e = max(r_e, abs(r['energy'] - float(e_ref[k])))
        r_f = max(r_f, float(np.abs(r['forces'] - f_ref[k]).max()))
        if k >= 10:
            v = -r['virial'] / 30.0 ** 3
            r_s = max(r_s, float(np.abs(
                r['stress'] - v[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]])
                .max()))
    emit('serve_xla', frames=500, batch=100, checkpoint=XLA_CKPT[len(ROOT)
                                                                 + 1:],
         dense_energy_mae=e_mae, dense_force_mae=f_mae,
         jax_energy_mae=JAX_XLA_ENERGY_MAE, jax_force_mae=JAX_XLA_FORCE_MAE,
         inv_energy_mae=ie_mae, inv_force_mae=if_mae,
         jax_inv_energy_mae=JAX_XLA_INV_ENERGY_MAE,
         jax_inv_force_mae=JAX_XLA_INV_FORCE_MAE, k_max=INV_K_MAX,
         inv_vs_dense_energy_max_abs=e_diff, inv_vs_dense_force_max_abs=f_diff,
         inv_kernel_vs_plain_bitwise=same_bits,
         dense_batch_ms_median=1e3 * statistics.median(dense_s),
         inv_batch_ms_median=1e3 * statistics.median(inv_s),
         inv_host_list_ms_median=1e3 * statistics.median(list_s),
         requests=20, request_energy_max_abs_diff=r_e,
         request_force_max_abs_diff=r_f, request_stress_vs_virial=r_s,
         request_latency_ms_median=1e3 * statistics.median(lat),
         launches_500_frames=launches)
    check(abs(e_mae - JAX_XLA_ENERGY_MAE) <= 5e-4, f'XLA energy MAE {e_mae}')
    check(abs(f_mae - JAX_XLA_FORCE_MAE) <= 5e-5, f'XLA force MAE {f_mae}')
    check(abs(ie_mae - JAX_XLA_INV_ENERGY_MAE) <= 5e-4,
          f'XLA inverse-list energy MAE {ie_mae}')
    check(abs(if_mae - JAX_XLA_INV_FORCE_MAE) <= 5e-5,
          f'XLA inverse-list force MAE {if_mae}')
    check(e_diff <= E_ATOL and f_diff <= F_ATOL, 'XLA inverse vs dense')
    check(same_bits, 'XLA inverse lists: kernel and plain gathers differ')
    check(r_e <= E_ATOL and r_f <= F_ATOL, 'XLA requests vs batches')
    check(r_s <= 1e-6, 'XLA request stress is not -virial / volume')
    check(launches['row_gather'] > 0, f'K9 was not launched: {launches}')
    return launches


def phase_box_xla(torch, rg, klist_box):
    """Phase 5c: calculator requests (energy, forces, stress) on the
    4096-atom box in inverse-list mode (k_max BOX_K_MAX, bf16 stack,
    box_weights): against the plain row gather (bitwise), three requests
    repeating their bits; C11: the bf16 stack on the C11 boxes against the
    JAX package's bf16 program (C11_BARS, in units of that program's own
    bf16-to-fp32 shift), with the float32 model as the control that must
    fail them; the 512-atom float32 request against the JAX package (1e-5
    of the energy, 1e-4 of the largest force); the 4096-atom bf16 request
    against its float32 one (per-atom energies and forces within
    BOX_BF16_VS_FP32 of the JAX program's pooled shifts; the node_rows_fp8
    control must exceed it); and the 4096-atom float32 result against the
    K-list path of phase 5b (klist_box) at the float32 bars (the bf16
    K-list program's distance is printed).
    -> (K9 launches per request, the calculator, the request, timings with
    the float32 result and the C11 numbers)."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    outs = ['energy', 'gradient_force', 'stress']
    xcfg = load_model(XLA_CKPT).config_dict()
    box = box_model(torch, xcfg, 'bfloat16', outs, inverse_lists=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'box_xla.msgpack')
        save_model(path, box)
        calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                     'stress'])
    z, pos, cell, _, _ = box_system()
    request = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    calc.calculate(**request)
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    lat, results = [], []
    for _ in range(3):
        t = time.perf_counter()
        results.append(calc.calculate(**request))
        lat.append(time.perf_counter() - t)
    launches = {k: v // 3 for k, v in rg.LAUNCHES.items()}
    repeats = all(np.array_equal(results[0][k], r[k])
                  for r in results[1:] for k in ('forces', 'stress')) and \
        all(results[0]['energy'] == r['energy'] for r in results[1:])
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (z, pos, cell)]
    list_s, model_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nl = host_symmetric_nlist(calc.model, tz, tpos, tcell, skin=0.0)
        list_s.append(time.perf_counter() - t)
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = calc.model(tz, tpos, tcell, nlist=nl)
        torch.cuda.synchronize()
        model_s.append(time.perf_counter() - t)
    plain = calc.model(tz, tpos, tcell, nlist=nl, plain=True)
    bitwise = all(exact(torch, out[k], plain[k]) for k in outs)
    r = results[0]
    calc_vs_model = (r['energy'] == float(out['energy'][0])
                     and np.array_equal(r['forces'], out['gradient_force'][0]
                                        .cpu().numpy()))
    n_edges = int(nl[1].sum())
    del plain
    torch.cuda.empty_cache()
    ae_16 = out['atomic_energy'][0].reshape(-1).cpu().numpy()
    handles = node_rows_fp8(torch, calc.model)
    ctl = calc.model(tz, tpos, tcell, nlist=nl)
    for h in handles:
        h.remove()
    ae_ctl = ctl['atomic_energy'][0].reshape(-1).cpu().numpy()
    f_ctl = ctl['gradient_force'][0].cpu().numpy()
    del ctl
    model32 = box_model(torch, xcfg, '', outs, inverse_lists=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p32 = model32(tz, tpos, tcell, nlist=nl)
    torch.cuda.synchronize()
    fp32_model_s = time.perf_counter() - t
    e_32 = float(p32['energy'][0])
    ae_32 = p32['atomic_energy'][0].reshape(-1).cpu().numpy()
    f_32 = p32['gradient_force'][0].cpu().numpy()
    del p32
    torch.cuda.empty_cache()
    e, f = r['energy'], r['forces']
    # C11 on the reference boxes: the bf16 stack, and the float32 model
    # (what the bf16 stack was before C11) as the control
    ref = c11_reference()
    g16 = c11_box_requests(torch, calc.model)
    g32 = c11_box_requests(torch, model32)
    c11 = {'bf16': c11_box_stats(np, ref, g16),
           'fp32_control': c11_box_stats(np, ref, g32)}
    # both packages' shifts: the port's own bf16-to-fp32 shift on the same
    # boxes, in the same units
    c11['port_bf16_shift'] = {
        key: float(np.sqrt(np.mean(np.concatenate(
            [np.ravel(g16[b][i] - g32[b][i]) for b in C11_BOXES]) ** 2)))
        / c11['bf16'][f'{key}_jax_shift']
        for i, key in enumerate(('energy', 'atom_energy', 'forces'))}
    z5, pos5, cell5, _, _ = box_system(BOX_REF_ATOMS)
    t5 = [torch.from_numpy(a).cuda() for a in (z5, pos5, cell5)]
    o5 = model32(*t5, nlist=host_symmetric_nlist(model32, *t5, skin=0.0))
    del model32
    torch.cuda.empty_cache()
    jf8_32 = np.asarray(JAX_XLA_BOX_FP32_FORCES_8)
    f8_32 = o5['gradient_force'][0, :8].cpu().numpy()

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    # the 4096-atom bf16 request against its float32 one, per atom, in
    # units of the JAX program's pooled shifts; the control must exceed it
    unit = {'atom_energy': c11['bf16']['atom_energy_jax_shift'],
            'forces': c11['bf16']['forces_jax_shift']}
    own = {'atom_energy': rms(ae_16 - ae_32) / unit['atom_energy'],
           'forces': rms(f - f_32) / unit['forces']}
    control = {'atom_energy': rms(ae_ctl - ae_32) / unit['atom_energy'],
               'forces': rms(f_ctl - f_32) / unit['forces']}
    c11['box_bf16_vs_fp32'] = {'bf16': own, 'fp8_rows_control': control,
                               'bar': BOX_BF16_VS_FP32}
    bars = {'energy_fp32_vs_klist_fp32': 1e-5 * abs(e_32),
            'forces_fp32_vs_klist_fp32': 1e-4 * float(np.abs(f_32).max()),
            'energy_512_fp32_vs_jax': 1e-5 * abs(JAX_XLA_BOX_FP32_ENERGY),
            'forces8_512_fp32_vs_jax': 1e-4 * float(np.abs(jf8_32).max())}
    diffs = {'energy_fp32_vs_klist_fp32': abs(e_32
                                              - klist_box['energy_fp32']),
             'forces_fp32_vs_klist_fp32': float(np.abs(
                 f_32 - klist_box['forces_fp32']).max()),
             'energy_512_fp32_vs_jax': abs(float(o5['energy'][0])
                                           - JAX_XLA_BOX_FP32_ENERGY),
             'forces8_512_fp32_vs_jax': float(np.abs(f8_32 - jf8_32).max())}
    c11['bf16_vs_klist_bf16_edges'] = {
        'energy': abs(e - klist_box['energy']),
        'forces': float(np.abs(f - klist_box['forces']).max())}
    timing = {'latency_ms': [1e3 * t for t in lat],
              'latency_ms_median': 1e3 * statistics.median(lat),
              'host_list_ms_median': 1e3 * statistics.median(list_s),
              'model_ms_median': 1e3 * statistics.median(model_s),
              'fp32_model_ms_one_call': 1e3 * fp32_model_s}
    emit('box_xla', atoms=BOX_ATOMS, k_max=BOX_K_MAX, edges=n_edges,
         compute_dtype='bfloat16', energy=e, fp32_energy=e_32,
         klist_energy=klist_box['energy'], diffs=diffs, bars=bars, c11=c11,
         c11_bars=C11_BARS,
         kernel_vs_plain_bitwise=bitwise, calculator_vs_model_bitwise=(
             calc_vs_model), requests_repeat_their_bits=repeats,
         forces_max_abs=float(np.abs(f).max()),
         launches_per_request=launches, **timing)
    check(np.isfinite(e) and np.isfinite(f).all()
          and np.isfinite(r['stress']).all(), 'XLA box request not finite')
    check(bitwise, 'XLA box: kernel and plain gathers differ')
    check(calc_vs_model, 'XLA box: calculator and model differ')
    check(repeats, 'XLA box: requests do not repeat their bits')
    for key, d in diffs.items():
        check(d <= bars[key], f'XLA box {key}: {d} > {bars[key]}')
    for key, bar in C11_BARS.items():
        check(c11['bf16'][key] <= bar,
              f'C11: bf16 {key} {c11["bf16"][key]} > {bar} JAX shifts')
        check(c11['fp32_control'][key] > bar,
              f'C11: the float32 control passes the {key} bar '
              f'({c11["fp32_control"][key]} <= {bar})')
    for key in own:
        check(own[key] <= BOX_BF16_VS_FP32,
              f'XLA box bf16 vs fp32 {key}: {own[key]} > '
              f'{BOX_BF16_VS_FP32} JAX shifts')
        check(control[key] > BOX_BF16_VS_FP32,
              f'XLA box: the fp8-rows control passes the bf16 vs fp32 '
              f'{key} bar ({control[key]} <= {BOX_BF16_VS_FP32})')
    check(launches['row_gather'] > 0 and launches['row_gather_b1'] > 0,
          f'K9 was not launched on the box: {launches}')
    timing['fp32'] = {'energy': e_32, 'forces': f_32}
    timing['c11'] = c11
    return launches, calc, request, timing


def xla_settings(output, epochs):
    '''artifacts/md17_model/config.yml (no kernel key: an XLA model),
    warm-started from the XLA checkpoint, on CUDA, with the data of this
    checkout, `epochs` epochs, writing into `output`.'''
    import yaml
    with open(XLA_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cuda', output=output)
    cfg['data'].update(train_root=os.path.dirname(os.path.dirname(XYZ_TRAIN)),
                       test_root=os.path.dirname(os.path.dirname(XYZ)))
    cfg['model']['pretrained_model'] = {'path': XLA_CKPT}
    cfg['training']['epochs'] = epochs
    return cfg


def xla_fine_tune(torch, **changes):
    '''The fine-tuning of phases 7f/7g: (config, its first 10 training
    batches on the card, a function giving the starting model, the
    configured main loss). The start is the XLA checkpoint's weights in a
    model with `changes`, the energy scaler refit as the CLI refits it.'''
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    cfg = xla_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]

    def start(**more):
        base = load_model(XLA_CKPT)
        model = NewtonNet(**dict(base.config_dict(), **changes, **more),
                          device='cuda')
        model.load_state_dict(base.state_dict())
        set_scalers(model.core, model.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        return model.requires_grad_(True)
    return cfg, batches, start, get_loss_by_string(cfg['training']['loss'])


def param_grads(torch, model):
    """Each parameter's gradient (zeros where it got none)."""
    return [p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for p in model.core.parameters()]


def xla_steps(torch, model, loss_fns, batches, fast_grad, lr=1e-3,
              clip=1.0, train_generator=None):
    """Steps through Trainer.loss_and_grad (the step fast_grad resolves
    to) with Adam (lr, clip); the Trainer is given train_generator (which
    it reads only to resolve a charge head's ewald_mode). -> (losses,
    global gradient norms before the clip, step seconds, step 1's
    gradients and predictions, the Trainer)."""
    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    opt = get_optimizer_by_string('adam', model.core, clip_grad=clip, lr=lr)
    trainer = Trainer(model, loss_fns=loss_fns, optimizer=opt,
                      fast_grad=fast_grad, train_generator=train_generator)
    losses, norms, step_s, grads1, preds1 = [], [], [], None, None
    with fp32_matmuls():
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, preds = trainer.loss_and_grad(b)
            norm = opt.global_norm()
            if grads1 is None:
                grads1, preds1 = param_grads(torch, model), preds
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(loss))
            norms.append(float(norm))
    return losses, norms, step_s, grads1, preds1, trainer


def check_jax_steps(what, losses, norms, jax_loss, jax_norm, loss64, bar1,
                    norm_bar=1e-3):
    """Phase 7a's bars: step 1's loss, and the JAX package's, within bar1
    (one float32 ulp of every frame's energy) of the float64 loss and of
    each other; step 1's gradient norm at norm_bar (1e-3; bf16 duals 2e-3)
    and steps 2-10's losses at 1e-2 relative to the JAX package's. -> the
    relative differences."""
    rel_loss = [abs(a - b) / b for a, b in zip(losses, jax_loss)]
    rel_gn = [abs(a - b) / b for a, b in zip(norms, jax_norm)]
    check(all(math.isfinite(v) for v in losses + norms),
          f'{what}: non-finite loss or gradient norm')
    check(max(rel_loss[0], abs(losses[0] - loss64) / loss64,
              abs(jax_loss[0] - loss64) / loss64) <= bar1,
          f'{what}: step 1 loss {losses[0]} (float64 {loss64})')
    check(rel_gn[0] <= norm_bar, f'{what}: step 1 grad norm {norms[0]}')
    check(max(rel_loss[1:]) <= 1e-2, f'{what}: steps 2-10 loss {losses}')
    return rel_loss, rel_gn


def phase_train_xla_steps(torch, fd):
    """Phase 7f a/b: the first 10 fine-tuning steps of the XLA checkpoint
    with its own config, by the standard step (fast_grad 'auto', as the
    JAX Trainer resolves it for an XLA model) and by fastgrad's reverse
    over forward (fast_grad True), each against the JAX package's
    (JAX_XLA_STEP_*); step 1's gradient of the two at 1e-4 relative norm.
    -> (step 1's batch, the starting model's maker, the fine-tuned
    model's Trainer, the step seconds, step 1's gradients and energies,
    the float64 loss and bar)."""
    _, batches, start, loss_fns = xla_fine_tune(torch)
    runs = {fg: xla_steps(torch, start(), loss_fns, batches, fg)
            for fg in ('auto', True)}
    loss64, ulp_term = float64_loss(fd, loss_fns[0], batches[0], start())
    bar1 = ulp_term / loss64
    out = {}
    for fg, (losses, norms, step_s, _, _, trainer) in runs.items():
        check(trainer.fast_grad is (fg is True),
              f'fast_grad {fg!r} resolved to {trainer.fast_grad}')
        rel_loss, rel_gn = check_jax_steps(
            f'XLA fast_grad={fg}', losses, norms, JAX_XLA_STEP_LOSS,
            JAX_XLA_STEP_GRAD_NORM, loss64, bar1)
        out[str(fg)] = dict(
            loss=losses, grad_norm=norms, rel_loss=rel_loss,
            rel_grad_norm=rel_gn, step_ms=[1e3 * t for t in step_s],
            step_ms_median=1e3 * statistics.median(step_s[1:]))
    rel = rel_norm(runs[True][3], runs['auto'][3])
    emit('train_xla_steps', checkpoint=XLA_CKPT[len(ROOT) + 1:],
         config=XLA_CONFIG[len(ROOT) + 1:], jax_loss=JAX_XLA_STEP_LOSS,
         jax_grad_norm=JAX_XLA_STEP_GRAD_NORM, loss64=loss64,
         step1_loss_bar=bar1, standard=out['auto'], fast_grad=out['True'],
         fast_vs_standard_grad_rel_norm=rel, bar=1e-4)
    check(rel <= 1e-4, f'XLA fastgrad vs standard step 1 gradient: {rel}')
    _, _, step_s, grads1, preds1, trainer = runs['auto']
    return (batches[0], start, trainer, step_s, grads1, preds1['energy'],
            (loss64, bar1))


def phase_train_xla_epoch(torch, rg):
    """Phase 7c of the XLA checkpoint (7f c): one epoch through the CLI's
    entry point with artifacts/md17_model/config.yml (95 steps, val, test,
    final re-evaluation). -> its seconds."""
    import csv
    import tempfile
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.train.cli import train_from_settings
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        rg.reset_launch_counts()
        t = time.perf_counter()
        trainer = train_from_settings(xla_settings(out, 1))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(rg.LAUNCHES)
        with open(os.path.join(trainer.output_path, 'log.csv')) as f:
            rows = list(csv.DictReader(f))
        best = load_model(os.path.join(trainer.model_path,
                                       'best_model.msgpack'))
        again = trainer.run_one_epoch(trainer.test_generator, model=best)
    row = rows[0]
    emit('train_xla_epoch', seconds=seconds, steps=row['step'], log=row,
         fast_grad=trainer.fast_grad, reloaded_best_test=again,
         launches=launches)
    check(trainer.model.kernel == 'xla' and not trainer.fast_grad,
          'the XLA config did not train an XLA model by the standard step')
    check(list(row) == LOG_COLUMNS, f'log.csv columns {list(row)}')
    check([r['epoch'] for r in rows] == ['0', 'last', 'best'],
          'log.csv rows')
    check(row['step'] == '95', f'expected 95 steps, got {row["step"]}')
    check(all(math.isfinite(float(row[k])) for k in LOG_COLUMNS[1:-1]),
          'non-finite log.csv value')
    check(row['best_model'] == 'True', 'epoch 0 saved no best model')
    check(best.kernel == 'xla', 'the best model is not an XLA model')
    for k, v in again.items():
        logged = float(row[f'test_{k}'])
        check(abs(v - logged) <= 1e-5 * abs(logged),
              f'reloaded best model test_{k}: {v} vs {logged}')
    return seconds


def phase_train_xla_nlist_steps(torch, rg, dense_start, dense_grads1,
                                dense_e1, f64):
    """Phase 7g: the same fine-tuning with graph_mode neighborlist, k_max
    48 (plain lists; every neighbour fits, so it computes the dense
    function): 10 standard steps against JAX_XLA_NLIST_STEP_* at phase
    7a's bars (step 1's from 7f's float64 loss), step 1's gradient against the
    dense port path of 7f (1e-4 relative norm plus the term that the
    energies' float32 rounding moves e_bar by, as phase 7d), K9 launched
    (gather_nodes' fixed-order backward), and three step-1 gradients from
    one start with equal bits."""
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    _, batches, start, loss_fns = xla_fine_tune(
        torch, graph_mode='neighborlist', k_max=INV_K_MAX)
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    losses, norms, step_s, grads1, preds1, _ = xla_steps(
        torch, start(), loss_fns, batches, 'auto')
    launches = dict(rg.LAUNCHES)
    loss64, bar1 = f64
    rel_loss, rel_gn = check_jax_steps(
        'XLA neighbour lists', losses, norms, JAX_XLA_NLIST_STEP_LOSS,
        JAX_XLA_NLIST_STEP_GRAD_NORM, loss64, bar1)
    rel = rel_norm(grads1, dense_grads1)
    main_loss = loss_fns[0]
    b0 = batches[0]
    with fp32_matmuls(), torch.enable_grad():
        # the energies of the two paths differ by float32 rounding, which
        # moves e_bar = dL/dE by de: grad_theta(de . E) on the dense model
        bars = []
        for e in (preds1['energy'], dense_e1):
            e = e.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(main_loss(
                {'energy': e, 'gradient_force': preds1['gradient_force']},
                b0), e)
            bars.append(g)
        dense = dense_start()
        out = dense(b0['z'], b0['pos'], b0['cell'], create_graph=True)
        torch.dot((bars[0] - bars[1]).detach(), out['energy']).backward()
        e_term = (sum(float((g ** 2).sum())
                      for g in param_grads(torch, dense))
                  / sum(float((g ** 2).sum()) for g in dense_grads1)) ** 0.5
        again = []
        for _ in range(3):
            model = start()
            standard_value_and_grad(model, main_loss, b0)
            again.append(param_grads(torch, model))
    repeats = all(exact(torch, a, b) for g in again[1:]
                  for a, b in zip(again[0], g))
    bar = 1e-4 + e_term
    emit('train_xla_nlist_steps', k_max=INV_K_MAX, loss=losses,
         jax_loss=JAX_XLA_NLIST_STEP_LOSS, grad_norm=norms,
         jax_grad_norm=JAX_XLA_NLIST_STEP_GRAD_NORM, rel_loss=rel_loss,
         rel_grad_norm=rel_gn, step_ms=[1e3 * t for t in step_s],
         step_ms_median=1e3 * statistics.median(step_s[1:]),
         grad_rel_norm_diff_vs_dense=rel, vs_dense_bar=bar,
         energy_residual_term=e_term, launches_10_steps=launches,
         gradients_repeat_their_bits=repeats)
    check(rel <= bar, f'XLA nlist vs dense step 1 gradient: {rel} > {bar}')
    check(launches['row_gather'] > 0,
          f'K9 was not launched on the XLA list training path: {launches}')
    check(repeats, 'three XLA list gradients from one start differ in '
          'their bits')
    return launches


def box_xla_batch(torch, n_atoms):
    """box_system(n_atoms) with its labels and box_stress's on the card."""
    z, pos, cell, energy, force = box_system(n_atoms)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             (('z', z), ('pos', pos), ('cell', cell), ('energy', energy),
              ('force', force), ('stress', box_stress()))}
    batch['graph_mask'] = torch.ones(1, dtype=torch.bool, device='cuda')
    return batch


def phase_box_train_xla(torch, rg, xcfg):
    """Phase 7h: the standard training step on the 4096-atom box
    (box_model, bf16 stack, box_weights) with BOX_XLA_LOSS (energy + force
    + stress), Adam lr 1e-3: three steps over plain lists and three over
    inverse lists built once by host_symmetric_nlist, from one start.
    Step 1 over inverse lists against the plain row gather (equal bits) and
    against plain lists (2e-3 relative norm: bf16 rows summed in another
    order); three step-1 gradients with equal bits; fastgrad (energy +
    force) against itself over the plain row gather (equal bits) and
    against the standard step on the same loss (2e-3); at BOX_REF_ATOMS,
    step 1's loss and gradient norm against the JAX package's, in float32
    (1e-4 relative) and with the bf16 stack (C11_STEP_SHIFTS times the
    JAX package's bf16-to-fp32 shift, plus the float32 bar; both shifts
    printed).
    -> ({list layout: K9 launches per step}, {list layout: (one more
    step, the step seconds)})."""
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    outs = ['energy', 'gradient_force', 'stress']
    main_loss, _ = get_loss_by_string(BOX_XLA_LOSS)
    ef_loss, _ = get_loss_by_string({k: BOX_XLA_LOSS[k]
                                     for k in ('energy', 'gradient_force')})

    def start(cd='bfloat16'):
        return box_model(torch, xcfg, cd, outs,
                         inverse_lists=True).requires_grad_(True)

    def grad_norm(grads):
        return math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))

    batch = box_xla_batch(torch, BOX_ATOMS)
    nl = host_symmetric_nlist(start(), batch['z'], batch['pos'],
                              batch['cell'], skin=0.0)
    runs = {}
    with fp32_matmuls():
        for name, lists in (('plain_lists', None), ('inverse_lists', nl)):
            model = start()
            opt = get_optimizer_by_string('adam', model.core, lr=1e-3)
            losses, step_s, grads1, launches = [], [], None, None
            for k in range(3):
                torch.cuda.synchronize()
                if k == 2:
                    rg.reset_launch_counts()
                t = time.perf_counter()
                loss, _ = standard_value_and_grad(model, main_loss, batch,
                                                  nlist=lists)
                if grads1 is None:
                    grads1 = param_grads(torch, model)
                opt.step()
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                if k == 2:
                    launches = dict(rg.LAUNCHES)
                losses.append(float(loss))
            runs[name] = (losses, step_s, grads1, launches, model, opt)
        g_inv = runs['inverse_lists'][2]
        plain = start()
        standard_value_and_grad(plain, main_loss, batch, nlist=nl,
                                plain=True)
        bitwise = all(exact(torch, a, b)
                      for a, b in zip(g_inv, param_grads(torch, plain)))
        del plain
        again = []
        for _ in range(3):
            model = start()
            standard_value_and_grad(model, main_loss, batch, nlist=nl)
            again.append(param_grads(torch, model))
        repeats = all(exact(torch, a, b) for g in again[1:]
                      for a, b in zip(again[0], g))
        del again
        model = start()
        fastgrad.value_and_grad(model, ef_loss, batch, nlist=nl)
        g_fast = param_grads(torch, model)
        fastgrad.value_and_grad(model, ef_loss, batch, nlist=nl, plain=True)
        fast_bitwise = all(exact(torch, a, b) for a, b in
                           zip(g_fast, param_grads(torch, model)))
        standard_value_and_grad(model, ef_loss, batch, nlist=nl)
        rel_fast = rel_norm(g_fast, param_grads(torch, model))
        del model, g_fast
        torch.cuda.empty_cache()
        b5 = box_xla_batch(torch, BOX_REF_ATOMS)
        ref = {}
        for cd in ('bfloat16', ''):
            model = start(cd)
            loss, _ = standard_value_and_grad(
                model, main_loss, b5, nlist=host_symmetric_nlist(
                    model, b5['z'], b5['pos'], b5['cell'], skin=0.0))
            ref[cd or 'float32'] = (float(loss),
                                    grad_norm(param_grads(torch, model)))
    rel_lists = rel_norm(g_inv, runs['plain_lists'][2])
    diffs, bars = {}, {}
    shifts = {}
    for i, what in enumerate(('loss', 'grad_norm')):
        jax = (JAX_XLA_BOX_STEP_LOSS, JAX_XLA_BOX_STEP_GRAD_NORM)[i]
        # the bf16 bar is the reference's own bf16-to-fp32 spread: the
        # port's would raise its own bar (ROADMAP.md C11: the two bf16
        # programs round different values, so their shifts differ)
        shifts[what] = {'jax': jax['bfloat16'] - jax['float32'],
                        'port': ref['bfloat16'][i] - ref['float32'][i]}
        diffs[f'{what}_512_vs_jax'] = abs(ref['bfloat16'][i]
                                          - jax['bfloat16'])
        bars[f'{what}_512_vs_jax'] = (C11_STEP_SHIFTS
                                      * abs(shifts[what]['jax'])
                                      + 1e-4 * abs(jax['float32']))
        diffs[f'{what}_512_fp32_vs_jax'] = abs(ref['float32'][i]
                                               - jax['float32'])
        bars[f'{what}_512_fp32_vs_jax'] = 1e-4 * abs(jax['float32'])
    def stepper(name, lists):
        model, opt = runs[name][4:]

        def one_step():
            with fp32_matmuls():
                standard_value_and_grad(model, main_loss, batch,
                                        nlist=lists)
                opt.step()
        return one_step, runs[name][1]
    emit('box_train_xla', atoms=BOX_ATOMS, k_max=BOX_K_MAX,
         compute_dtype='bfloat16', loss=BOX_XLA_LOSS,
         **{f'{name}_loss': r[0] for name, r in runs.items()},
         **{f'{name}_step_ms': [1e3 * t for t in r[1]]
            for name, r in runs.items()},
         **{f'{name}_launches_per_step': r[3] for name, r in runs.items()},
         kernel_vs_plain_gather_bitwise=bitwise,
         fastgrad_kernel_vs_plain_gather_bitwise=fast_bitwise,
         gradients_repeat_their_bits=repeats,
         inverse_vs_plain_lists_grad_rel_norm=rel_lists,
         fastgrad_vs_standard_ef_grad_rel_norm=rel_fast, bar=2e-3,
         step1_512=ref, jax_step1_512={
             'loss': JAX_XLA_BOX_STEP_LOSS,
             'grad_norm': JAX_XLA_BOX_STEP_GRAD_NORM},
         bf16_shift_512=shifts, diffs=diffs, bars=bars)
    for name, r in runs.items():
        check(all(math.isfinite(v) for v in r[0]), f'box {name} losses')
        check(r[3]['row_gather'] > 0 and r[3]['row_gather_b1'] > 0,
              f'K9 was not launched in an XLA box step ({name}): {r[3]}')
    check(bitwise, 'XLA box step: kernel and plain gathers differ')
    check(fast_bitwise, 'XLA box fastgrad: kernel and plain gathers differ')
    check(repeats, 'three XLA box gradients from one start differ in their '
          'bits')
    check(rel_lists <= 2e-3, f'XLA box inverse vs plain lists: {rel_lists}')
    check(rel_fast <= 2e-3, f'XLA box fastgrad vs standard: {rel_fast}')
    for key, d in diffs.items():
        check(d <= bars[key], f'XLA box step {key}: {d} > {bars[key]}')
    return ({name: r[3] for name, r in runs.items()},
            {'inverse_lists': stepper('inverse_lists', nl),
             'plain_lists': stepper('plain_lists', None)},
            {'shifts': shifts, 'in_jax_shifts': {
                what: diffs[f'{what}_512_vs_jax'] / abs(shifts[what]['jax'])
                for what in ('loss', 'grad_norm')}})


def box_calculator(torch, model):
    """A calculator serving `model` from a checkpoint file, as a user
    serves one."""
    import tempfile
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'box.msgpack')
        save_model(path, model)
        return NewtonNetCalculator(path, properties=['energy', 'forces',
                                                     'stress'])


def timed_requests(torch, rg, calc, request, n=3):
    """n calculator requests after one warm-up: (results, latencies, K9
    launches per request, whether they repeat their bits)."""
    import numpy as np
    calc.calculate(**request)
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    results, lat = [], []
    for _ in range(n):
        t = time.perf_counter()
        results.append(calc.calculate(**request))
        lat.append(time.perf_counter() - t)
    launches = {k: v // n for k, v in rg.LAUNCHES.items()}
    repeats = all(np.array_equal(results[0][k], r[k]) for r in results[1:]
                  for k in results[0])
    return results, lat, launches, repeats


def against_fp32_box(np, what, r, ref):
    """{diffs, bars} of a float32 box request `r` against phase 5c's
    inverse-list float32 request: 1e-5 of the energy, 1e-4 of the largest
    force."""
    diffs = {'energy': abs(r['energy'] - ref['energy']),
             'forces': float(np.abs(r['forces'] - ref['forces']).max())}
    bars = {'energy': 1e-5 * abs(ref['energy']),
            'forces': 1e-4 * float(np.abs(ref['forces']).max())}
    for key, d in diffs.items():
        check(d <= bars[key], f'{what} {key}: {d} > {bars[key]}')
    return {'diffs': diffs, 'bars': bars}


def phase_newton3_serve(torch, rg, xcfg, ref32):
    """Phase 8a: newton3 half lists served. The trained newton3 checkpoint
    (LJ_CKPT: F=48, 2 interactions, k_max 16) on lj_box's 64-atom LJ box
    against the JAX package's calculator (JAX_LJ_N3_*, float32 bars: 1e-5
    of the energy, 1e-4 of the largest force); the 4096-atom box
    (box_weights, F=128, 3 interactions) with newton3 and half-list
    capacity BOX_N3_K_MAX in float32 against phase 5c's inverse-list
    float32 request (ref32) at the same bars, against the plain row gather
    (bitwise), three requests repeating their bits. K9 runs the half
    lists' gathers and mirror sums (inv_gather / inv_scatter_sum) in the
    forward (counted alone, in a forward without gradients) and every
    backward.
    -> (K9 launches per LJ request, per box request; the box model; the
    newton3 box result; timings)."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.models.xla_stack import apply_core_xla
    z, pos, cell, _, _ = lj_box()
    lj_calc = NewtonNetCalculator(LJ_CKPT)
    check(lj_calc.model.newton3 and lj_calc.model.n_features == 48,
          'the LJ checkpoint is not a newton3 model at F=48')
    lj_req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    lj_res, lj_lat, lj_launches, lj_repeats = timed_requests(
        torch, rg, lj_calc, lj_req)
    r = lj_res[0]
    jf8 = np.asarray(JAX_LJ_N3_FORCES_8)
    lj = {'energy': r['energy'], 'jax_energy': JAX_LJ_N3_ENERGY,
          'energy_diff': abs(r['energy'] - JAX_LJ_N3_ENERGY),
          'energy_bar': 1e-5 * abs(JAX_LJ_N3_ENERGY),
          'forces8_diff': float(np.abs(r['forces'][:8] - jf8).max()),
          'forces8_bar': 1e-4 * float(np.abs(jf8).max())}
    outs = ['energy', 'gradient_force', 'stress']
    model = box_model(torch, xcfg, '', outs, newton3=True,
                      k_max=BOX_N3_K_MAX)
    calc = box_calculator(torch, model)
    zb, pb, cb, _, _ = box_system()
    req = dict(numbers=zb[0], positions=pb[0], cell=cb[0])
    res, lat, launches, repeats = timed_requests(torch, rg, calc, req)
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (zb, pb, cb)]
    list_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nl = host_symmetric_nlist(calc.model, tz, tpos, tcell, skin=0.0)
        list_s.append(time.perf_counter() - t)
    out = calc.model(tz, tpos, tcell, nlist=nl)
    plain = calc.model(tz, tpos, tcell, nlist=nl, plain=True)
    bitwise = all(exact(torch, out[k], plain[k]) for k in outs)
    del plain
    # the forward alone: the half lists' gathers and mirror sums
    rg.reset_launch_counts()
    with torch.no_grad():
        apply_core_xla(calc.model, tz, tpos, tcell, nlist=nl)
    forward_launches = dict(rg.LAUNCHES)
    torch.cuda.empty_cache()
    cmp = against_fp32_box(np, 'newton3 box', res[0], ref32)
    timing = {'lj_latency_ms_median': 1e3 * statistics.median(lj_lat),
              'box_latency_ms_median': 1e3 * statistics.median(lat),
              'box_host_list_ms_median': 1e3 * statistics.median(list_s)}
    emit('newton3_serve', lj=lj, lj_requests_repeat_their_bits=lj_repeats,
         lj_launches_per_request=lj_launches, atoms=BOX_ATOMS,
         k_max_half=BOX_N3_K_MAX, half_edges=int(nl[1].sum()),
         box_vs_inverse_fp32=cmp, kernel_vs_plain_bitwise=bitwise,
         box_requests_repeat_their_bits=repeats,
         box_launches_per_request=launches,
         box_forward_launches=forward_launches, **timing)
    check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all(),
          'LJ newton3 request not finite')
    check(lj['energy_diff'] <= lj['energy_bar'],
          f'LJ newton3 energy: {lj["energy_diff"]}')
    check(lj['forces8_diff'] <= lj['forces8_bar'],
          f'LJ newton3 forces: {lj["forces8_diff"]}')
    check(lj_repeats and repeats, 'newton3 requests do not repeat their '
          'bits')
    check(bitwise, 'newton3 box: kernel and plain gathers differ')
    for name, n in (('LJ request', lj_launches), ('box request', launches),
                    ('box forward', forward_launches)):
        check(n['row_gather'] > 0,
              f'K9 was not launched in a newton3 {name}: {n}')
    return lj_launches, launches, model, res[0], timing


def phase_newton3_train(torch, fd, rg):
    """Phase 8b: newton3 training over precomputed lists. LJ_CONFIG with
    prefetch 0 on write_lj_dataset's frames through
    data.precompute_nlist mode newton3: the first 10 fine-tuning steps of
    LJ_CKPT (its scalers refit, Adam at the config's lr, its clip) by the
    standard step against the JAX package's (JAX_LJ_STEP_*, phase 7a's
    bars, step 1's loss at LJ_STEP1_REL); step 1's gradient against the
    same batch over full inverse lists (1e-4 relative norm); one epoch of
    the config, from its own initialization, through the CLI's entry
    point.
    -> (K9 launches in the 10 steps, in the epoch)."""
    import csv
    import tempfile

    import yaml
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.train.cli import train_from_settings
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    with open(LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    main_loss = get_loss_by_string(cfg['training']['loss'])
    lr = cfg['training']['optimizer']['adam']['lr']
    with tempfile.TemporaryDirectory() as root:
        write_lj_dataset(root)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **lj_data_settings(root))
        it = iter(train_gen)
        batches = [next(it) for _ in range(10)]

        def start(**changes):
            base = load_model(LJ_CKPT)
            model = NewtonNet(**dict(base.config_dict(), **changes),
                              device='cuda')
            model.load_state_dict(base.state_dict())
            set_scalers(model.core, model.output_properties, stats,
                        {'energy': dict(cfg['training']['fit_scalers'])})
            return model.requires_grad_(True)
        model = start()
        dbatches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
                    for b in batches]
        rg.reset_launch_counts()
        losses, norms, step_s, grads1, _, trainer = xla_steps(
            torch, model, main_loss, dbatches, 'auto', lr=lr,
            clip=cfg['training']['clip_grad'])
        step_launches = dict(rg.LAUNCHES)
        nl0 = trainer._batch_nlist(dbatches[0])
        loss64, ulp_term = float64_loss(fd, main_loss[0], dbatches[0],
                                        start(), nlist=nl0)
        # phase 7a's step-1 bar is one float32 ulp of every frame's energy;
        # here the loss is mostly 50 x force mse, whose float32 sums round
        # more than that: 1e-5 relative (LJ_STEP1_REL) where it is larger
        bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
        rel_loss, rel_gn = check_jax_steps(
            'newton3 LJ', losses, norms, JAX_LJ_STEP_LOSS,
            JAX_LJ_STEP_GRAD_NORM, loss64, bar1)
        full = start(newton3=False, inverse_lists=True,
                     k_max=2 * cfg['model']['k_max'] + 8)
        b0 = dbatches[0]
        standard_value_and_grad(full, main_loss[0], b0,
                                nlist=host_symmetric_nlist(
                                    full, b0['z'], b0['pos'], b0['cell'],
                                    skin=0.0))
        rel_full = rel_norm(grads1, param_grads(torch, full))
        del full
        settings = dict(cfg, general=dict(cfg['general'], device='cuda'),
                        data=lj_data_settings(root),
                        training=dict(cfg['training'], epochs=1))
        with tempfile.TemporaryDirectory() as out:
            settings['general']['output'] = out
            torch.cuda.synchronize()
            rg.reset_launch_counts()
            t = time.perf_counter()
            tr = train_from_settings(settings)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t
            epoch_launches = dict(rg.LAUNCHES)
            with open(os.path.join(tr.output_path, 'log.csv')) as f:
                rows = list(csv.DictReader(f))
    finite = all(math.isfinite(float(rows[0][k])) for k in
                 ('train_loss', 'val_loss', 'test_loss'))
    emit('newton3_train', config=LJ_CONFIG[len(ROOT) + 1:],
         precompute_nlist=lj_data_settings('')['precompute_nlist'],
         loss=losses, grad_norm=norms, jax_loss=JAX_LJ_STEP_LOSS,
         jax_grad_norm=JAX_LJ_STEP_GRAD_NORM, rel_loss=rel_loss,
         rel_grad_norm=rel_gn, loss64=loss64, step1_loss_bar=bar1,
         step1_vs_full_inverse_lists_grad_rel_norm=rel_full, bar=1e-4,
         step_ms=[1e3 * t for t in step_s],
         step_ms_median=1e3 * statistics.median(step_s[1:]),
         launches_10_steps=step_launches, cli_epoch_seconds=epoch_s,
         cli_epoch_launches=epoch_launches,
         cli_epoch_log={k: rows[0][k] for k in
                        ('train_loss', 'val_loss', 'test_loss',
                         'steps_per_s')})
    check(rel_full <= 1e-4, f'newton3 vs full inverse lists: {rel_full}')
    check(finite, f'newton3 CLI epoch log not finite: {rows[0]}')
    check(step_launches['row_gather'] > 0 and
          epoch_launches['row_gather'] > 0,
          f'K9 was not launched in newton3 training: {step_launches}')
    return step_launches, epoch_launches


def phase_revlist_cellgrid(torch, rg, xcfg, ref32):
    """Phase 8c: the 4096-atom box in float32 over reverse lists
    (reverse_lists, lists built in the model) and over the O(N) cell grid
    (cell_grid from suggest_grid / suggest_capacity), each against phase
    5c's inverse-list float32 request (ref32) at the float32 box bars;
    the grid's list against neighbor_list's as an edge set (no overflow
    in either), and both builders' times."""
    import numpy as np
    from newtonnet_tpu_torch.ops.cellgrid import (
        cell_grid_neighbor_list,
        suggest_capacity,
        suggest_grid,
    )
    from newtonnet_tpu_torch.ops.nlist import neighbor_list
    outs = ['energy', 'gradient_force', 'stress']
    z, pos, cell, _, _ = box_system()
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    grid = suggest_grid(cell[0], xcfg['cutoff'])
    cap = suggest_capacity(BOX_ATOMS, grid)
    results = {}
    for name, layout in (('reverse_lists', {'reverse_lists': True}),
                         ('cell_grid', {'cell_grid': grid,
                                        'cell_capacity': cap})):
        calc = box_calculator(torch, box_model(torch, xcfg, '', outs,
                                               **layout))
        res, lat, _, repeats = timed_requests(torch, rg, calc, req)
        results[name] = dict(
            against_fp32_box(np, f'{name} box', res[0], ref32),
            latency_ms_median=1e3 * statistics.median(lat),
            requests_repeat_their_bits=repeats)
        check(repeats, f'{name} box requests do not repeat their bits')
        del calc
        torch.cuda.empty_cache()
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (z, pos, cell)]
    mask = tz > 0
    build = {}
    for name, fn in (('neighbor_list', lambda: neighbor_list(
            tpos, tcell, mask, xcfg['cutoff'], BOX_K_MAX)),
            ('cell_grid', lambda: cell_grid_neighbor_list(
                tpos, tcell, mask, xcfg['cutoff'], BOX_K_MAX, grid, cap))):
        fn()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lists = fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        build[name] = (lists, 1e3 * statistics.median(ts))

    def edges(lists):
        idx, kmask = lists[0][0].cpu().numpy(), lists[1][0].cpu().numpy()
        rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
        return set(zip(rows[kmask.ravel()].tolist(),
                       idx.ravel()[kmask.ravel()].tolist()))
    same = edges(build['neighbor_list'][0]) == edges(build['cell_grid'][0])
    over = {k: int(v[0][3].sum()) for k, v in build.items()}
    emit('revlist_cellgrid', atoms=BOX_ATOMS, k_max=BOX_K_MAX, grid=grid,
         cell_capacity=cap, requests=results, grid_edges_equal=same,
         overflow=over, build_ms={k: v[1] for k, v in build.items()})
    check(same, 'cell grid and neighbor_list edge sets differ')
    check(not any(over.values()), f'list overflow at the box: {over}')


def phase_staircase(torch, rg, xcfg, n3_model, n3_result):
    """Phase 8d: the 4096-atom box with newton3_compact over staircase
    chunks (ops/staircase.py from the full list at 2 * BOX_N3_K_MAX + 8,
    the frame permuted into the staircase's order) against phase 8a's
    newton3 request (n3_result) at the float32 box bars, and a compact
    checkpoint served by the calculator, which swaps it to the newton3
    layout: its request equals 8a's bit for bit. -> K9 launches of one
    staircase forward + forces."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.ops.nlist import neighbor_list
    from newtonnet_tpu_torch.ops.staircase import (stair_nlist,
                                                   staircase_half_list)
    z, pos, cell, _, _ = box_system()
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (z, pos, cell)]
    compact = NewtonNet(**dict(n3_model.config_dict(), newton3=False,
                               newton3_compact=True), device='cuda')
    compact.load_state_dict(n3_model.state_dict())
    compact.requires_grad_(False).eval()

    def build():
        idx, kmask, _, over = neighbor_list(
            tpos, tcell, tz > 0, xcfg['cutoff'], 2 * BOX_N3_K_MAX + 8)
        check(int(over.sum()) == 0, 'staircase full list overflows')
        sl = staircase_half_list(idx[0].cpu().numpy(),
                                 kmask[0].cpu().numpy())
        return sl, tuple(tuple(torch.from_numpy(a).cuda() for a in ch)
                         for ch in stair_nlist(sl))
    build()  # the first call builds csrc/host/staircase.cpp
    torch.cuda.synchronize()
    t = time.perf_counter()
    sl, nl = build()
    host_ms = 1e3 * (time.perf_counter() - t)
    perm = torch.from_numpy(sl.perm.astype(np.int64)).cuda()
    compact(tz[:, perm], tpos[:, perm], tcell, nlist=nl)
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    t = time.perf_counter()
    out = compact(tz[:, perm], tpos[:, perm], tcell, nlist=nl)
    torch.cuda.synchronize()
    model_ms = 1e3 * (time.perf_counter() - t)
    launches = dict(rg.LAUNCHES)
    r = {'energy': float(out['energy'][0]),
         'forces': out['gradient_force'][0].cpu().numpy()[sl.inv_perm]}
    cmp = against_fp32_box(np, 'staircase box', r, n3_result)
    calc = box_calculator(torch, compact)
    swapped = calc.model.newton3 and not calc.model.newton3_compact
    rc = calc.calculate(numbers=z[0], positions=pos[0], cell=cell[0])
    same = rc['energy'] == n3_result['energy'] and \
        np.array_equal(rc['forces'], n3_result['forces'])
    slots = sum(c * n for c, n in sl.widths)
    emit('staircase', atoms=BOX_ATOMS, widths=sl.widths, chunk_slot_rows=slots,
         newton3_slot_rows=BOX_ATOMS * BOX_N3_K_MAX, vs_newton3=cmp,
         calculator_swaps_to_newton3=swapped,
         calculator_equals_newton3_bitwise=same, host_build_ms=host_ms,
         model_ms_one_call=model_ms, launches_one_call=launches)
    check(swapped, 'the calculator did not swap the compact checkpoint')
    check(same, 'compact checkpoint served through newton3 differs from '
          'the newton3 request')
    check(launches['row_gather'] > 0, f'K9 not launched: {launches}')
    return launches


def gather_timing(torch, rg, wn, errs, launches, window):
    """Rows of the kernels line for K9 (box inv_gather and scatter-chunk
    shapes), K12, K10 and K11: CUDA-event times of the kernel, its plain
    version and one PyTorch call computing the same function, in turns;
    the bound: the bytes written, the indices and one read of the source
    (L2 holds it) over the memory rate."""
    g = torch.Generator(device='cuda').manual_seed(50)
    N, F4 = BOX_ATOMS, 4 * 128
    rows = []

    def row(name, source, what, launch, err, run, plain, library, nbytes):
        plain1 = time_ms(torch, plain, inner=5)
        ms = time_ms(torch, run, inner=5)
        ms2 = time_ms(torch, run, inner=5)
        plain2 = time_ms(torch, plain, inner=5)
        lib1 = time_ms(torch, library, inner=5)
        rows.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[source],
            'replaces': REPLACES[name], 'launches': launch,
            'max_abs_err': err, 'ms': statistics.median([ms, ms2]),
            'plain_ms': statistics.median([plain1, plain2]),
            'bound_ms': 1e3 * nbytes / PEAK_BYTES_PER_S, 'bound_by': 'bytes',
            'library_ms': lib1, 'shape': what, 'bytes': nbytes,
            'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2]})

    for name, n, R in (('row_gather', N, BOX_K_MAX * N),
                       ('row_gather_chunk', 6 * N, 6 * N),
                       ('exp_row_gather', EXP_GATHER_N, EXP_GATHER_ROWS)):
        x = torch.randn((1, n, F4), generator=g, device='cuda') \
            .to(torch.bfloat16)
        idx = torch.randint(0, n, (1, R), generator=g, device='cuda')
        flat = idx[0]
        key = 'row_gather_b1' if name == 'exp_row_gather' else 'row_gather'
        row(name, 'gather', f'x (1, {n}, {F4}) bf16, {R} rows',
            launches[key], 0.0, lambda: rg.row_gather(x, idx),
            lambda: rg.row_gather_ref(x, idx),
            lambda: torch.index_select(x[0], 0, flat),
            R * F4 * 2 + R * 8 + n * F4 * 2)
        del x, idx, flat
    idx_kn, mask_kn, W = window
    K = idx_kn.shape[1]
    x = torch.randn((1, N, F4), generator=g, device='cuda') \
        .to(torch.bfloat16)
    y = (torch.randn((1, K, N, F4), generator=g, device='cuda')
         * mask_kn[..., None]).to(torch.bfloat16)
    flat = idx_kn.reshape(-1)
    acc = torch.zeros((N, F4), device='cuda')
    y2f = y.reshape(K * N, F4).float()
    row('window_gather', 'window', f'x (1, {N}, {F4}) bf16, idx (1, {K}, '
        f'{N}), W={W}, T={WINDOW_T}', launches['window_gather'],
        errs['window_gather'],
        lambda: wn.window_gather_fwd(x, idx_kn, W, WINDOW_T),
        lambda: wn.window_gather_ref(x, idx_kn, W, WINDOW_T),
        lambda: torch.index_select(x[0], 0, flat),
        K * N * F4 * 2 + K * N * 8 + N * F4 * 2)
    row('window_scatter_sum', 'window', f'y (1, {K}, {N}, {F4}) bf16 -> '
        f'(1, {N}, {F4}), W={W}, T={WINDOW_T}',
        launches['window_scatter_sum'], errs['window_scatter_sum'],
        lambda: wn.window_scatter_sum_fwd(y, idx_kn, W, WINDOW_T),
        lambda: wn.window_scatter_sum_ref(y, idx_kn, W, WINDOW_T),
        lambda: acc.index_add_(0, flat, y2f),
        K * N * F4 * 2 + K * N * 8 + N * F4 * 2)
    emit('timing', what='K9-K12', peak_tb_per_s=PEAK_BYTES_PER_S / 1e12,
         bound='(bytes written + indices + one read of the source) / HBM '
               'rate')
    return rows


def worst_vs_plain(torch, where, pairs, bar):
    """max over (kernel, plain) output pairs of the excess over the plain
    value relative to its largest magnitude: the difference for fp32
    outputs, the difference beyond one bf16 ulp for bf16-stored ones;
    fails the phase past `bar` or on a non-finite output."""
    worst = 0.0
    for k, (x, y) in enumerate(pairs):
        check((x is None) == (y is None), f'{where} output {k}')
        if x is None:
            continue
        check(x.dtype == y.dtype and x.shape == y.shape,
              f'{where} output {k}: {x.dtype} {tuple(x.shape)}')
        check(bool(torch.isfinite(x.float()).all()),
              f'{where} output {k} not finite')
        x32, y32 = x.float(), y.float()
        diff = (x32 - y32).abs()
        if x.dtype == torch.bfloat16:
            diff = (diff - bf16_ulp(torch, torch.maximum(
                x32.abs(), y32.abs()))).clamp_min(0)
        scale = y32.abs().max().item()
        ratio = diff.max().item() / scale if scale else diff.max().item()
        check(ratio <= bar, f'{where} output {k}: {ratio} > {bar}')
        worst = max(worst, ratio)
    return worst


def repeats(torch, fn):
    """True iff a second launch of fn gives the same bits."""
    a, b = fn(), fn()
    return all(exact(torch, x, y) for x, y in zip(a, b) if x is not None)


def phase_width_kernels(torch, fd, fdd, fk):
    """Phase 9a: K1-K8 at the widths of WIDTHS_9A against their plain
    versions, at small seeded ragged shapes (N = 13 and 37 no multiple of
    the row or column tiles, K = 11 of the slot steps, R = 12 padded to 32):
    both first-layer variants, K2/K6 with and without weight cotangents,
    K3/K4 in both dot modes, fp32 and bf16 edges. Bars: KERNEL_BAR of each
    output's largest magnitude, beyond one bf16 ulp for bf16-stored
    outputs; K3/K4 in bf16 mode DUAL_BF16_BAR (phase 3's). Each kernel
    launched twice gives the same bits. -> {F: {kernel: worst ratio}}."""
    from newtonnet_tpu_torch.ops import _build
    out = {}
    for F in WIDTHS_9A:
        worst, same = {}, {}
        B, N, R = 2, 13, 12
        ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=F)
        args, cots = dual_inputs(torch, B, N, F, R, seed=F + 1)
        for first in (False, True):
            kw = dict(first_layer=first)
            pairs = list(zip(fd.pair_interaction_fwd(*ins, **kw),
                             fd.pair_interaction_fwd_ref(*ins, **kw)))
            worst['K1'] = max(worst.get('K1', 0.0), worst_vs_plain(
                torch, f'K1 F={F} first={first}', pairs, KERNEL_BAR))
            same[f'K1 first={first}'] = repeats(
                torch, lambda: fd.pair_interaction_fwd(*ins, **kw))
            for wg in (False, True):
                def k2(wg=wg):
                    return fd.pair_interaction_bwd(*ins, dinv1, deq, **kw,
                                                   weight_grads=wg)
                pairs = list(zip(k2(), fd.pair_interaction_bwd_ref(
                    *ins, dinv1, deq, **kw, weight_grads=wg)))
                worst['K2'] = max(worst.get('K2', 0.0), worst_vs_plain(
                    torch, f'K2 F={F} first={first} wg={wg}', pairs,
                    KERNEL_BAR))
                same[f'K2 first={first} wg={wg}'] = repeats(torch, k2)
            for dt, bar in (('float32', KERNEL_BAR),
                            ('bfloat16', DUAL_BF16_BAR)):
                dkw = dict(first_layer=first, dot_dtype=dt)
                for name, fn, ref, a in (
                        ('K3', fdd.pair_interaction_dual_fwd,
                         fdd.pair_interaction_dual_fwd_ref, args),
                        ('K4', fdd.pair_interaction_dual_bwd,
                         fdd.pair_interaction_dual_bwd_ref, args + cots)):
                    pairs = list(zip(fn(*a, **dkw), ref(*a, **dkw)))
                    worst[name] = max(worst.get(name, 0.0), worst_vs_plain(
                        torch, f'{name} F={F} first={first} {dt}', pairs,
                        bar))
                    same[f'{name} first={first} {dt}'] = repeats(
                        torch, lambda fn=fn, a=a: fn(*a, **dkw))
        names = {'klist_fwd': 'K5', 'klist_bwd(wg=0)': 'K6',
                 'klist_bwd(wg=1)': 'K6', 'klist_dual_fwd': 'K7',
                 'klist_dual_bwd': 'K8'}
        for edt in (torch.float32, torch.bfloat16):
            for first in (False, True):
                kins, tans, kcots = klist_inputs(torch, 1, 37, 11, F, R,
                                                 first, edt, seed=F + 2)
                refs = klist_calls(fk, kins, tans, kcots, first, ref=True)
                for call, (fn, a, kw) in klist_calls(
                        fk, kins, tans, kcots, first).items():
                    rfn, ra, rkw = refs[call]
                    pairs = list(zip(fn(*a, first_layer=first, **kw),
                                     rfn(*ra, first_layer=first, **rkw)))
                    name = names[call]
                    where = f'{call} F={F} first={first} {edt}'
                    worst[name] = max(worst.get(name, 0.0), worst_vs_plain(
                        torch, where, pairs, KERNEL_BAR))
                    same[where] = repeats(
                        torch, lambda fn=fn, a=a, kw=kw: fn(
                            *a, first_layer=first, **kw))
        torch.cuda.synchronize()
        emit('width_kernels', F=F, padded=_build.padded_width(F),
             worst_err_over_max=worst, bar=KERNEL_BAR,
             dual_bf16_bar=DUAL_BF16_BAR,
             bf16_stored_bar='one bf16 ulp + bar',
             repeat_their_bits=all(same.values()))
        check(all(same.values()), f'F={F}: a second launch differs: '
              f'{[k for k, v in same.items() if not v]}')
        out[F] = worst
    return out


def lj_pallas_model(torch, graph_mode, **changes):
    """LJ_CKPT as a kernel='pallas' model (LJ_PALLAS) with its trained
    weights: the config override a caller gives the newton3 checkpoint."""
    from newtonnet_tpu_torch import NewtonNet, load_model
    base = load_model(LJ_CKPT)
    model = NewtonNet(**dict(base.config_dict(), **LJ_PALLAS,
                             graph_mode=graph_mode, **changes),
                      device='cuda')
    model.load_state_dict(base.state_dict())
    return model


def lj_counts(fd, fdd, fk):
    return {**fd.LAUNCHES, **fdd.LAUNCHES, **fk.LAUNCHES}


def reset_counts(fd, fdd, fk):
    for m in (fd, fdd, fk):
        m.reset_launch_counts()


def phase_lj_pallas_serve(torch, fd, fdd, fk):
    """Phase 9b: LJ_CKPT as a kernel='pallas' model at its width F=48
    through the calculator (model and flax params: the JAX package's entry
    point for an overridden config) on lj_box's box, dense (K1/K2) and over
    plain K-lists of k_max 16 (K5/K6): against the JAX package's numbers
    (JAX_LJ_PALLAS_*) and against the checkpoint's own XLA newton3 request
    (phase 8a's), energy within 1e-5 of its magnitude and forces within
    1e-4 of the largest force; three requests repeat their bits.
    -> {graph_mode: launches per request}."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.utils.params import params_to_flax
    z, pos, cell, _, _ = lj_box()
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    n3 = NewtonNetCalculator(LJ_CKPT).calculate(**req)
    per_request = {}
    for gm in ('dense', 'neighborlist'):
        model = lj_pallas_model(torch, gm)
        calc = NewtonNetCalculator(model=model,
                                   params=params_to_flax(model.core))
        calc.calculate(**req)
        torch.cuda.synchronize()
        reset_counts(fd, fdd, fk)
        results, lat = [], []
        for _ in range(3):
            t = time.perf_counter()
            results.append(calc.calculate(**req))
            lat.append(time.perf_counter() - t)
        launches = {k: v // 3 for k, v in lj_counts(fd, fdd, fk).items()
                    if v}
        r = results[0]
        same = all(np.array_equal(r[k], x[k]) for x in results[1:]
                   for k in r)
        jf8 = np.asarray(JAX_LJ_PALLAS_FORCES_8[gm])
        je = JAX_LJ_PALLAS_ENERGY[gm]
        cmp = {'jax': {'energy_diff': abs(r['energy'] - je),
                       'energy_bar': 1e-5 * abs(je),
                       'forces8_diff': float(np.abs(r['forces'][:8] - jf8)
                                             .max()),
                       'forces8_bar': 1e-4 * float(np.abs(jf8).max())},
               'xla_newton3': {
                   'energy_diff': abs(r['energy'] - n3['energy']),
                   'energy_bar': 1e-5 * abs(n3['energy']),
                   'forces_diff': float(np.abs(r['forces'] - n3['forces'])
                                        .max()),
                   'forces_bar': 1e-4 * float(np.abs(n3['forces']).max())}}
        emit('lj_pallas_serve', graph_mode=gm, n_features=model.n_features,
             energy=r['energy'], vs=cmp, requests_repeat_their_bits=same,
             launches_per_request=launches,
             latency_ms_median=1e3 * statistics.median(lat))
        check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all(),
              f'LJ pallas {gm} request not finite')
        for ref, c in cmp.items():
            for key in ('energy', 'forces8', 'forces'):
                if f'{key}_diff' in c:
                    check(c[f'{key}_diff'] <= c[f'{key}_bar'],
                          f'LJ pallas {gm} {key} vs {ref}: {c}')
        check(same, f'LJ pallas {gm} requests do not repeat their bits')
        want = (('pair_fwd', 'pair_fwd_first', 'pair_bwd', 'pair_bwd_first')
                if gm == 'dense' else
                ('klist_fwd', 'klist_fwd_first', 'klist_bwd',
                 'klist_bwd_first'))
        check(all(launches.get(k, 0) > 0 for k in want),
              f'LJ pallas {gm} request did not launch {want}: {launches}')
        per_request[gm] = launches
        del calc, model
    return per_request


def phase_lj_pallas_train(torch, fd, fdd, fk):
    """Phase 9c: LJ_CONFIG's fine-tuning of LJ_CKPT as a kernel='pallas'
    model (prefetch 0, B=12, lj_pallas_data_settings), dense (fastgrad
    through K1/K2 and K3/K4 in the default bf16 duals) and over plain
    precomputed K-lists (K5-K8): 10 steps each against the JAX package's
    (JAX_LJ_PALLAS_STEP_*: step 1's loss within bar1 of the float64 loss,
    its gradient norm at 1e-3 for fp32 duals or 2e-3 for bf16 ones, steps
    2-10 at 1e-2); the K-list step 1 gradient within 1e-4 (relative norm)
    of the dense model's with float32 duals; one epoch of the K-list config
    through the CLI's entry point. -> {what: launches}."""
    import csv
    import tempfile

    import yaml
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.cli import train_from_settings
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    with open(LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    main_loss = get_loss_by_string(cfg['training']['loss'])
    lr = cfg['training']['optimizer']['adam']['lr']
    clip = cfg['training']['clip_grad']
    out, grads1 = {}, {}
    with tempfile.TemporaryDirectory() as root:
        write_lj_dataset(root)
        for gm in ('dense', 'neighborlist'):
            train_gen, _, _, stats = parse_train_test(
                seed=0, **lj_pallas_data_settings(root, gm))
            it = iter(train_gen)
            batches = [{k: torch.as_tensor(v).cuda()
                        for k, v in next(it).items()} for _ in range(10)]

            def start(gm=gm, stats=stats, **changes):
                model = lj_pallas_model(torch, gm, **changes)
                set_scalers(model.core, model.output_properties, stats,
                            {'energy': dict(cfg['training']['fit_scalers'])})
                return model.requires_grad_(True)
            reset_counts(fd, fdd, fk)
            losses, norms, step_s, g1, _, trainer = xla_steps(
                torch, start(), main_loss, batches, 'auto', lr=lr, clip=clip)
            launches = {k: v for k, v in lj_counts(fd, fdd, fk).items() if v}
            check(trainer.fast_grad, f'LJ pallas {gm}: not fastgrad')
            grads1[gm] = g1
            if gm == 'dense':
                loss64, ulp_term = float64_loss(fd, main_loss[0], batches[0],
                                                start())
                bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
                # the dense step 1 with float32 duals: the K-list's reference
                _, _, _, grads1['dense_fp32'], _, _ = xla_steps(
                    torch, start(pallas_grad_dot_dtype='float32'), main_loss,
                    batches[:1], 'auto', lr=lr, clip=clip)
            norm_bar = 2e-3 if gm == 'dense' else 1e-3
            rel_loss, rel_gn = check_jax_steps(
                f'LJ pallas {gm}', losses, norms,
                JAX_LJ_PALLAS_STEP_LOSS[gm], JAX_LJ_PALLAS_STEP_GRAD_NORM[gm],
                loss64, bar1, norm_bar=norm_bar)
            emit('lj_pallas_train', graph_mode=gm, loss=losses,
                 grad_norm=norms, jax_loss=JAX_LJ_PALLAS_STEP_LOSS[gm],
                 jax_grad_norm=JAX_LJ_PALLAS_STEP_GRAD_NORM[gm],
                 rel_loss=rel_loss, rel_grad_norm=rel_gn, loss64=loss64,
                 step1_loss_bar=bar1, step1_grad_norm_bar=norm_bar,
                 step_ms=[1e3 * t for t in step_s],
                 step_ms_median=1e3 * statistics.median(step_s[1:]),
                 launches_10_steps=launches)
            want = fp32_names({**fd.LAUNCHES, **fdd.LAUNCHES}
                              if gm == 'dense' else fk.LAUNCHES)
            check(all(launches.get(k, 0) > 0 for k in want),
                  f'LJ pallas {gm} steps did not launch every kernel: '
                  f'{launches}')
            out[f'train_{gm}_10_steps'] = launches
            del trainer
            torch.cuda.empty_cache()
        rel = rel_norm(grads1['neighborlist'], grads1['dense_fp32'])
        emit('lj_pallas_train_klist_vs_dense_fp32',
             step1_grad_rel_norm=rel, bar=1e-4)
        check(rel <= 1e-4, f'LJ pallas K-list vs dense fp32 step 1: {rel}')
        settings = dict(
            cfg, general=dict(cfg['general'], device='cuda'),
            data=lj_pallas_data_settings(root, 'neighborlist'),
            model=dict(cfg['model'], **LJ_PALLAS),
            training=dict(cfg['training'], epochs=1))
        with tempfile.TemporaryDirectory() as tmp:
            settings['general']['output'] = tmp
            torch.cuda.synchronize()
            reset_counts(fd, fdd, fk)
            t = time.perf_counter()
            tr = train_from_settings(settings)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t
            launches = {k: v for k, v in lj_counts(fd, fdd, fk).items() if v}
            with open(os.path.join(tr.output_path, 'log.csv')) as f:
                rows = list(csv.DictReader(f))
    finite = all(math.isfinite(float(rows[0][k])) for k in
                 ('train_loss', 'val_loss', 'test_loss'))
    emit('lj_pallas_cli_epoch', config=LJ_CONFIG[len(ROOT) + 1:],
         model=settings['model'], seconds=epoch_s, launches=launches,
         log={k: rows[0][k] for k in ('train_loss', 'val_loss', 'test_loss',
                                      'steps_per_s')})
    check(finite, f'LJ pallas CLI epoch log not finite: {rows[0]}')
    check(all(launches.get(k, 0) > 0 for k in fp32_names(fk.LAUNCHES)),
          f'LJ pallas CLI epoch did not launch K5-K8: {launches}')
    out['cli_epoch_neighborlist'] = launches
    return out


def width_timing(torch, fd, fdd, fk, widths=WIDTHS_9D):
    """Phase 9d: K1-K4 at LJ_CONFIG's training shape (B=12, N=64, R=16)
    and K5-K8 at the box shape (bf16 edges, R=20) at each width: CUDA-event
    times (two runs), the bound computed on the work at the true width,
    and the timed call's outputs against its plain version's on the same
    inputs (worst_vs_plain: KERNEL_BAR, K3/K4 in bf16 mode DUAL_BF16_BAR;
    the phase fails past it). -> {kernel name: {F: {...}}}."""
    timing = {}

    def add(name, F, run, plain, bar, flops, nbytes, peak):
        err = worst_vs_plain(torch, f'9d {name} F={F}',
                             list(zip(run(), plain())), bar)
        ms, ms2 = time_ms(torch, run, inner=3), time_ms(torch, run, inner=3)
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
        timing.setdefault(name, {})[F] = {
            'ms': statistics.median([ms, ms2]), 'ms_runs': [ms, ms2],
            'bound_ms': 1e3 * max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'err_over_max_vs_plain': err, 'bar': bar}
    B, N, R = 12, 64, 16
    for F in widths:
        ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=F)
        args, cots = dual_inputs(torch, B, N, F, R, seed=F)
        for first in (False, True):
            sfx = '_first' if first else ''
            kw = dict(first_layer=first)
            add('pair_fwd' + sfx, F,
                lambda: fd.pair_interaction_fwd(*ins, **kw),
                lambda: fd.pair_interaction_fwd_ref(*ins, **kw), KERNEL_BAR,
                *layer_work(B, N, F, R, 'fwd', first), PEAK_FP32_FLOPS)
            bkw = dict(first_layer=first, weight_grads=False)
            add('pair_bwd' + sfx, F,
                lambda: fd.pair_interaction_bwd(*ins, dinv1, deq, **bkw),
                lambda: fd.pair_interaction_bwd_ref(*ins, dinv1, deq, **bkw),
                KERNEL_BAR, *layer_work(B, N, F, R, 'bwd', first),
                PEAK_FP32_FLOPS)
            dkw = dict(first_layer=first, dot_dtype='bfloat16')
            add('dual_fwd' + sfx, F,
                lambda: fdd.pair_interaction_dual_fwd(*args, **dkw),
                lambda: fdd.pair_interaction_dual_fwd_ref(*args, **dkw),
                DUAL_BF16_BAR, *dual_work(B, N, F, R, 'fwd', first),
                PEAK_BF16_FLOPS)
            add('dual_bwd' + sfx, F,
                lambda: fdd.pair_interaction_dual_bwd(*args, *cots, **dkw),
                lambda: fdd.pair_interaction_dual_bwd_ref(*args, *cots,
                                                          **dkw),
                DUAL_BF16_BAR, *dual_work(B, N, F, R, 'bwd', first),
                PEAK_BF16_FLOPS)
        del ins, args, cots
    B, N, K, R = 1, BOX_ATOMS, BOX_K_MAX, 20
    for F in widths:
        for first in (False, True):
            kins, tans, kcots = klist_inputs(torch, B, N, K, F, R, first,
                                             torch.bfloat16, seed=30)
            calls = klist_calls(fk, kins, tans, kcots, first)
            refs = klist_calls(fk, kins, tans, kcots, first, ref=True)
            for call in ('klist_fwd', 'klist_bwd(wg=0)', 'klist_dual_fwd',
                         'klist_dual_bwd'):
                kind = call.split('(')[0]
                fn, a, kw = calls[call]
                rfn, ra, rkw = refs[call]
                add(kind + ('_first' if first else ''), F,
                    lambda: fn(*a, first_layer=first, **kw),
                    lambda: rfn(*ra, first_layer=first, **rkw), KERNEL_BAR,
                    *klist_work(B, N, K, F, R, kind, first, 2),
                    PEAK_FP32_FLOPS)
                torch.cuda.empty_cache()
            del kins, tans, kcots, calls, refs
            torch.cuda.empty_cache()
    emit('timing', what='K1-K8 at other widths', widths=list(widths),
         dense_shape=dict(B=12, N=64, R=16),
         klist_shape=dict(B=1, N=BOX_ATOMS, K=BOX_K_MAX, R=20),
         edge_dtype='bfloat16', dual_dot_dtype='bfloat16', timing=timing,
         vs_plain='worst over outputs of the excess over the plain value '
                  'relative to its largest magnitude (beyond one bf16 ulp '
                  'for bf16-stored outputs)')
    return timing


def fp32_names(counts):
    """The keys of a launch-count dict that name fp32-mode kernels (the
    bf16 mode's end in '_bf16', counted on phase 10's paths)."""
    return [k for k in counts if not k.endswith('_bf16')]


def median_ratio(x, y):
    """The median of |x - y| over the elements where y is not zero, over
    y's largest magnitude (0 for a zero y)."""
    x64, y64 = x.double(), y.double()
    scale = y64.abs().max().item()
    if scale == 0:
        return 0.0
    return (x64 - y64).abs()[y64 != 0].median().item() / scale


def bf16_vs_plain(torch, where, triples):
    """bf16 mode: (kernel, plain, plain in float64) outputs. Each kernel
    output is held against the plain version's at DUAL_BF16_BAR of its
    largest magnitude beyond one bf16 ulp of the element, and its median
    element error, over the elements where the plain output is not zero,
    at BF16_MEDIAN_BAR of it, or at twice the plain version's own median
    error against its float64 run where that is more (an output given no
    float64 run, None, takes BF16_MEDIAN_BAR alone); fails the phase on a
    non-finite output.

    The ulp: both sides round the same operands to bf16, but an fp32
    difference of a sum in another order can flip the rounding of a later
    operand, which moves a product term by one bf16 ulp of it (up to 2^-7
    of the term), and where one term dominates an element, by about one
    bf16 ulp of the element (phase 3 allows bf16-stored outputs the same).
    A flip is rare, so the median of most outputs stays at the fp32 level,
    while an operand rounded on one side only moves it by about 1e-4. An
    output that sums over every slot (the weight cotangents; a box
    request's energy and stress) collects the flips of all its terms, a
    random walk of about sqrt(flips) bf16 ulps of a term against a sum of
    sqrt(slots) terms: there any two fp32 orders differ by more than 1e-5,
    the plain version and its float64 run included, which the second bar
    measures. -> (worst max ratio beyond the ulp, worst median ratio, max
    abs error, worst raw max ratio, the largest median bar used)."""
    worst = worst_med = abs_err = raw = bar_used = 0.0
    for k, (x, y, y_f64) in enumerate(triples):
        check((x is None) == (y is None), f'{where} output {k}')
        if x is None:
            continue
        check(x.dtype == y.dtype and x.shape == y.shape,
              f'{where} output {k}: {x.dtype} {tuple(x.shape)}')
        check(bool(torch.isfinite(x.float()).all()),
              f'{where} output {k} not finite')
        x64, y64 = x.double(), y.double()
        diff = (x64 - y64).abs()
        abs_err = max(abs_err, diff.max().item())
        scale = y64.abs().max().item()
        if scale == 0:  # the first layer's zero dforce, dW2a, dW2b
            check(diff.max().item() == 0, f'{where} output {k} not zero')
            continue
        med = median_ratio(x, y)
        bar = BF16_MEDIAN_BAR if y_f64 is None else max(
            BF16_MEDIAN_BAR, 2 * median_ratio(y_f64, y))
        raw = max(raw, diff.max().item() / scale)
        beyond = (diff - bf16_ulp(torch, torch.maximum(
            x64.abs(), y64.abs())).double()).clamp_min(0)
        ratio = beyond.max().item() / scale
        check(ratio <= DUAL_BF16_BAR and med <= bar,
              f'{where} output {k}: max beyond one bf16 ulp {ratio} (bar '
              f'{DUAL_BF16_BAR}), median {med} (bar {bar}), raw max '
              f'{diff.max().item() / scale}')
        worst, worst_med = max(worst, ratio), max(worst_med, med)
        bar_used = max(bar_used, bar)
    return worst, worst_med, abs_err, raw, bar_used


def plain_triples(fn, args, got, **kw):
    """(kernel output, plain, plain in float64) triples of the kernel's
    outputs `got` and the plain version fn on args, on the card; the
    float64 run's outputs (the same operands rounded to bf16, summed with
    float64's error) cast to the dtypes of `got`."""
    res64 = fn(*[a.double() for a in args], **kw)
    return [(g, r, None if r64 is None else r64.to(g.dtype))
            for g, r, r64 in zip(got, fn(*args, **kw), res64)]


def phase_bf16_kernels(torch, fd, fk):
    """Phase 10a: K1/K2 and K5/K6 in bf16 mode against their plain bf16
    versions, full and first layer, K2/K6 with and without weight
    cotangents, at F = BF16_WIDTHS: K1/K2 at phase 3's ragged small shape
    (B=3, N=37, R=12) and at the aspirin serving shape (B=100, N=21,
    R=20), K5/K6 at phase 3's ragged shape (B=3, N=61, K=39, R=12), the
    serving shape (B=100, N=21, K=20, R=20) and the 4096-atom box's (B=1,
    K=88, R=20), each with fp32 and with bf16 edges; bars of
    bf16_vs_plain (the plain versions run in fp32 and in float64,
    plain_triples); second launches repeat their bits. -> {variant: max abs
    error} at F=128, the serving shape (K1/K2) and the box shape with bf16
    edges (K5/K6), as the fp32 rows of the kernels line."""
    dot = 'bfloat16'
    errs, table = {}, {}
    dense = [('small', 3, 37, 12), ('serve', 100, 21, 20)]
    klist = [('small', 3, 61, 39, 12), ('serve', 100, 21, 20, 20),
             ('box', 1, BOX_ATOMS, BOX_K_MAX, 20)]
    for F in BF16_WIDTHS:
        for tag, B, N, R in dense:
            ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=F + N)
            for first in (False, True):
                fwd = fd.launch_key('pair_fwd', first, dot)
                bwd = fd.launch_key('pair_bwd', first, dot)

                def k1(first=first):
                    return fd.pair_interaction_fwd(*ins, first_layer=first,
                                                   dot_dtype=dot)
                got = k1()
                ref = plain_triples(fd.pair_interaction_fwd_ref, ins, got,
                              first_layer=first, dot_dtype=dot)
                res = {fwd: bf16_vs_plain(torch, f'{fwd} F={F} {tag}',
                                          ref)}
                check(repeats(torch, k1), f'{fwd} F={F} {tag} repeats')
                for wg in (False, True):
                    def k2(first=first, wg=wg):
                        return fd.pair_interaction_bwd(
                            *ins, dinv1, deq, first_layer=first,
                            weight_grads=wg, dot_dtype=dot)
                    got = k2()
                    ref = plain_triples(fd.pair_interaction_bwd_ref,
                                  ins + [dinv1, deq], got, first_layer=first,
                                  weight_grads=wg, dot_dtype=dot)
                    res[f'{bwd}(wg={int(wg)})'] = bf16_vs_plain(
                        torch, f'{bwd} F={F} {tag} wg={int(wg)}', ref)
                    check(repeats(torch, k2), f'{bwd} F={F} {tag} repeats')
                for key, (w, m, a, r, mb) in res.items():
                    table[f'{key} F={F} {tag}'] = [w, m, r, mb]
                    if F == 128 and tag == 'serve':
                        name = key.split('(')[0]
                        errs[name] = max(errs.get(name, 0.0), a)
            del ins, dinv1, deq
        for tag, B, N, K, R in klist:
            for edt in (torch.float32, torch.bfloat16):
                for first in (False, True):
                    ins, _, cots = klist_inputs(torch, B, N, K, F, R, first,
                                                edt, seed=F + N + K)
                    fwd = fd.launch_key('klist_fwd', first, dot)
                    bwd = fd.launch_key('klist_bwd', first, dot)
                    et = 'bf16' if edt == torch.bfloat16 else 'fp32'

                    def k5(first=first):
                        return fk.klist_fwd(*ins, first_layer=first,
                                            dot_dtype=dot)
                    got = k5()
                    ref = plain_triples(fk.klist_fwd_ref, ins, got,
                                  first_layer=first, dot_dtype=dot)
                    res = {fwd: bf16_vs_plain(
                        torch, f'{fwd} F={F} {tag} {et} edges',
                        ref)}
                    check(repeats(torch, k5), f'{fwd} F={F} {tag} repeats')
                    for wg in (False, True):
                        def k6(first=first, wg=wg):
                            return fk.klist_bwd(
                                *ins, *cots[:2], first_layer=first,
                                weight_grads=wg, dot_dtype=dot)
                        got = k6()
                        ref = plain_triples(fk.klist_bwd_ref, ins + cots[:2], got,
                                      first_layer=first, weight_grads=wg,
                                      dot_dtype=dot)
                        res[f'{bwd}(wg={int(wg)})'] = bf16_vs_plain(
                            torch, f'{bwd} F={F} {tag} {et} edges '
                            f'wg={int(wg)}', ref)
                        check(repeats(torch, k6),
                              f'{bwd} F={F} {tag} repeats')
                    for key, (w, m, a, r, mb) in res.items():
                        table[f'{key} F={F} {tag} {et}'] = [w, m, r, mb]
                        if F == 128 and tag == 'box' and et == 'bf16':
                            name = key.split('(')[0]
                            errs[name] = max(errs.get(name, 0.0), a)
                    del ins, cots, got, ref
            torch.cuda.empty_cache()
        emit('bf16_kernel_vs_plain', F=F,
             max_beyond_ulp_median_raw_max_median_bar=table,
             bars={'max': DUAL_BF16_BAR, 'median': BF16_MEDIAN_BAR})
        table = {}
    return errs


def phase_bf16_aspirin(torch, fd, fk, base, batches, to_dev, served):
    """Phase 10b: the aspirin checkpoint with pallas_dot_dtype bfloat16
    (dense, K1/K2 in bf16 mode): the first BF16_ASPIRIN_FRAMES test frames
    against the JAX package's bf16 numbers at BF16_SPREAD_FACTOR times its
    own bf16-to-fp32 spread; all 500 frames in batches of 100 (the main
    path: every K1/K2 bf16 variant launched), their MAEs beside the fp32
    model's (phase 4's). -> (the 500 frames' launches, the model)."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNet
    model = NewtonNet(**dict(base.config_dict(), pallas_dot_dtype='bfloat16'),
                      device='cuda')
    model.load_state_dict(base.state_dict())
    b = batches[0]
    out = model(*[torch.from_numpy(b[k][:BF16_ASPIRIN_FRAMES]).cuda()
                  for k in ('z', 'pos', 'cell')])
    e = out['energy'].double().cpu().numpy()
    f = out['gradient_force'].double().cpu().numpy()
    k = BF16_SPREAD_FACTOR
    diffs = {'energy': float(np.abs(e - JAX_BF16_ASPIRIN_ENERGY).max()),
             'forces_4': float(np.abs(f[:4] - np.asarray(
                 JAX_BF16_ASPIRIN_FORCES_4)).max())}
    bars = {'energy': k * JAX_BF16_ASPIRIN_SPREAD['energy'],
            'forces_4': k * JAX_BF16_ASPIRIN_SPREAD['forces']}
    torch.cuda.synchronize()
    fd.reset_launch_counts()
    fk.reset_launch_counts()
    out_bf, batch_s = [], []
    for bb in batches:
        t = time.perf_counter()
        o = model(*to_dev(bb))
        out_bf.append((o['energy'].cpu().numpy(),
                       o['gradient_force'].cpu().numpy()))
        batch_s.append(time.perf_counter() - t)
    launches = {k: v for k, v in fd.LAUNCHES.items() if v}
    others = sum(fk.LAUNCHES.values()) + sum(
        fd.LAUNCHES[n] for n in fp32_names(fd.LAUNCHES))
    mae = {}
    for what, outs in (('bf16', out_bf), ('fp32', served)):
        ae = af = 0.0
        for bb, (ee, ff) in zip(batches, outs):
            check(np.isfinite(ee).all() and np.isfinite(ff).all(),
                  f'non-finite {what} output')
            ae += np.abs(ee - bb['energy']).astype(np.float64).sum()
            af += np.abs(ff - bb['force']).astype(np.float64).sum()
        mae[what] = {'energy_mae': ae / 500, 'force_mae': af / (500 * 63)}
    # one batch of 100 frames, bf16 and fp32 models in turns (CUDA events)
    dev0 = to_dev(batches[0])
    turns = [time_ms(torch, lambda m=m: m(*dev0), reps=5, inner=2)
             for m in (model, base, base, model)]
    emit('bf16_aspirin', frames_vs_jax=BF16_ASPIRIN_FRAMES, diffs=diffs,
         bars=bars, jax_spread=JAX_BF16_ASPIRIN_SPREAD,
         maes_500_frames=mae, launches_500_frames=launches,
         batch_ms_median=1e3 * statistics.median(batch_s),
         batch_ms_in_turns={
             'bf16': statistics.median([turns[0], turns[3]]),
             'fp32': statistics.median(turns[1:3]), 'runs': turns})
    for key, d in diffs.items():
        check(d <= bars[key], f'bf16 aspirin {key}: {d} > {bars[key]}')
    check(all(launches.get(n, 0) > 0 for n in BF16_DENSE),
          f'a K1/K2 bf16 variant was not launched serving: {launches}')
    check(others == 0, f'a fp32 or K-list kernel ran: {launches}')
    return launches, model


def phase_bf16_lj(torch, fd, fdd, fk):
    """Phase 10c: LJ_CKPT as a kernel='pallas' bf16 model (F=48) through
    the calculator on lj_box's box, dense (K1/K2) and over plain K-lists
    with fp32 and with bf16 edges (K5/K6), against the JAX package's bf16
    numbers at BF16_SPREAD_FACTOR times its bf16-to-fp32 spread; three
    requests repeat their bits. -> {layout: launches per request}."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.utils.params import params_to_flax
    z, pos, cell, _, _ = lj_box()
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    per_request = {}
    for layout, (gm, cd) in BF16_LJ_LAYOUTS.items():
        model = lj_pallas_model(torch, gm, compute_dtype=cd,
                                pallas_dot_dtype='bfloat16')
        calc = NewtonNetCalculator(model=model,
                                   params=params_to_flax(model.core))
        calc.calculate(**req)
        torch.cuda.synchronize()
        reset_counts(fd, fdd, fk)
        results = [calc.calculate(**req) for _ in range(3)]
        launches = {k: v // 3 for k, v in lj_counts(fd, fdd, fk).items()
                    if v}
        r = results[0]
        same = all(np.array_equal(r[k], x[k]) for x in results[1:]
                   for k in r)
        sp = JAX_BF16_LJ_SPREAD[layout]
        diffs = {'energy': abs(r['energy'] - JAX_BF16_LJ_ENERGY[layout]),
                 'forces_8': float(np.abs(r['forces'][:8] - np.asarray(
                     JAX_BF16_LJ_FORCES_8[layout])).max())}
        bars = {'energy': BF16_SPREAD_FACTOR * sp['energy'],
                'forces_8': BF16_SPREAD_FACTOR * sp['forces']}
        emit('bf16_lj', layout=layout, n_features=model.n_features,
             energy=r['energy'], diffs=diffs, bars=bars,
             requests_repeat_their_bits=same,
             launches_per_request=launches)
        check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all(),
              f'bf16 LJ {layout} request not finite')
        for key, d in diffs.items():
            check(d <= bars[key], f'bf16 LJ {layout} {key}: {d} > '
                  f'{bars[key]}')
        check(same, f'bf16 LJ {layout} requests do not repeat their bits')
        want = BF16_DENSE[:] if gm == 'dense' else BF16_KLIST
        check(all(launches.get(k, 0) > 0 for k in want)
              and set(launches) <= set(want),
              f'bf16 LJ {layout} launched {launches}, not {want}')
        per_request[layout] = launches
        del calc, model
    return per_request


def phase_bf16_box(torch, fk, base):
    """Phase 10d: the 4096-atom box request (energy, forces, stress) over
    K-lists with bf16 edges and pallas_dot_dtype bfloat16 (box_model, F=128,
    k_max 88; K5/K6 in bf16 mode) through the calculator, against the
    port's plain bf16 model on the card (in float64, its fp32 run giving
    the median bar's floor as in 10a) at 10a's bars; three requests repeat
    their bits. -> (launches per request, the request's latency and
    that of the fp32-dot box model)."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.utils.params import params_to_flax
    outs = ['energy', 'gradient_force', 'stress']
    box = box_model(torch, base.config_dict(), 'bfloat16', outs,
                    pallas_dot_dtype='bfloat16')
    props = ['energy', 'forces', 'stress']
    calc = NewtonNetCalculator(model=box, params=params_to_flax(box.core),
                               properties=props)
    z, pos, cell, _, _ = box_system()
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    calc.calculate(**req)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    lat, results = [], []
    for _ in range(3):
        t = time.perf_counter()
        results.append(calc.calculate(**req))
        lat.append(time.perf_counter() - t)
    launches = {k: v // 3 for k, v in fk.LAUNCHES.items() if v}
    r = results[0]
    same = all(np.array_equal(r[k], x[k]) for x in results[1:] for k in r)
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (z, pos, cell)]

    def outputs(model, dtype):
        # energy, forces and stress (Voigt) of the plain bf16 model
        o = model(tz, tpos.to(dtype), tcell.to(dtype),
                  pair_op=plain_klist(fk))
        s_p = o['stress'][0][[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
        return [o['energy'][:1].double().cpu(),
                o['gradient_force'][0].double().cpu(), s_p.double().cpu()]
    plain = outputs(box, torch.float32)
    # the plain bf16 model in float64 (bf16 edges all the same): energy and
    # stress sum over every edge of the box, so their flips add up as the
    # weight cotangents' do (bf16_vs_plain)
    plain64_ = outputs(box_model(torch, base.config_dict(), 'bfloat16', outs,
                                 pallas_dot_dtype='bfloat16').double(),
                       torch.float64)
    got = [torch.tensor([r['energy']], dtype=torch.float64),
           torch.from_numpy(r['forces']).double(),
           torch.from_numpy(r['stress']).double()]
    worst, med, err, raw, med_bar = bf16_vs_plain(
        torch, 'bf16 box request', zip(got, plain, plain64_))
    fp32 = box_model(torch, base.config_dict(), 'bfloat16', outs)
    calc32 = NewtonNetCalculator(model=fp32,
                                 params=params_to_flax(fp32.core),
                                 properties=props)
    calc32.calculate(**req)
    lat32 = []
    for _ in range(3):
        t = time.perf_counter()
        calc32.calculate(**req)
        lat32.append(time.perf_counter() - t)
    emit('bf16_box', atoms=BOX_ATOMS, k_max=BOX_K_MAX, energy=r['energy'],
         plain_energy=float(plain[0][0]),
         plain_float64_energy=float(plain64_[0][0]),
         worst_max_beyond_ulp_over_largest=worst,
         worst_median_over_largest=med, worst_raw_max_over_largest=raw,
         largest_median_bar=med_bar, max_abs_err=err, bars={'max': DUAL_BF16_BAR,
                                'median': BF16_MEDIAN_BAR},
         requests_repeat_their_bits=same, launches_per_request=launches,
         latency_ms_median=1e3 * statistics.median(lat),
         fp32_dot_latency_ms_median=1e3 * statistics.median(lat32))
    check(same, 'bf16 box requests do not repeat their bits')
    check(all(launches.get(k, 0) > 0 for k in BF16_KLIST)
          and set(launches) <= set(BF16_KLIST),
          f'bf16 box request launched {launches}, not {BF16_KLIST}')
    return launches, {'bf16_ms': 1e3 * statistics.median(lat),
                      'fp32_ms': 1e3 * statistics.median(lat32)}


def bf16_timing(torch, fd, fk, errs, launches):
    """Phase 10e: K1/K2 at the batched serving shape (B=100, N=21, F=128,
    R=20) and K5/K6 at the box shape (bf16 edges), full and first layer,
    K2/K6 without weight cotangents (the force pass's), in bf16 mode beside
    fp32 mode in the same run, each with its plain bf16 version's time
    (CUDA events, kernel and plain in turns); the bound takes every flop at
    the bf16 tensor cores' peak (K2's fp32 cotangent products included).
    -> the `kernels` rows of the bf16 variants."""
    rows = []
    B, N, F, R = 100, 21, 128, 20
    ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=0)
    for name in BF16_DENSE:
        first = '_first' in name
        fwd = name.startswith('pair_fwd')

        def run(dot, ref=False, first=first, fwd=fwd):
            if fwd:
                f = fd.pair_interaction_fwd_ref if ref else \
                    fd.pair_interaction_fwd
                return f(*ins, first_layer=first, dot_dtype=dot)
            f = fd.pair_interaction_bwd_ref if ref else \
                fd.pair_interaction_bwd
            return f(*ins, dinv1, deq, first_layer=first,
                     weight_grads=False, dot_dtype=dot)
        flops, nbytes = layer_work(B, N, F, R, 'fwd' if fwd else 'bwd',
                                   first)
        rows.append(bf16_row(torch, name, 'pair', run, flops, nbytes, errs,
                             launches, dict(B=B, N=N, F=F, R=R)))
    del ins, dinv1, deq
    B, N, K = 1, BOX_ATOMS, BOX_K_MAX
    for name in BF16_KLIST:
        first = '_first' in name
        fwd = name.startswith('klist_fwd')
        ins, _, cots = klist_inputs(torch, B, N, K, F, R, first,
                                    torch.bfloat16, seed=30)

        def run(dot, ref=False, first=first, fwd=fwd):
            if fwd:
                f = fk.klist_fwd_ref if ref else fk.klist_fwd
                return f(*ins, first_layer=first, dot_dtype=dot)
            f = fk.klist_bwd_ref if ref else fk.klist_bwd
            return f(*ins, *cots[:2], first_layer=first, weight_grads=False,
                     dot_dtype=dot)
        flops, nbytes = klist_work(B, N, K, F, R,
                                   'klist_fwd' if fwd else 'klist_bwd',
                                   first, 2)
        rows.append(bf16_row(torch, name, 'klist', run, flops, nbytes, errs,
                             launches, dict(B=B, N=N, K=K, F=F, R=R),
                             inner=3))
        del ins, cots
        torch.cuda.empty_cache()
    emit('timing', what='K1/K2 and K5/K6 in bf16 mode beside fp32 mode',
         peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
         rows={r['name']: {k: r[k] for k in ('ms', 'fp32_ms', 'plain_ms',
                                              'bound_ms', 'shape')}
               for r in rows})
    return rows


def bf16_row(torch, name, src, run, flops, nbytes, errs, launches, shape,
             inner=10):
    """One `kernels` row of a bf16 variant: its time and its plain
    version's (turns: plain, kernel, kernel, plain), its fp32 mode's time
    in the same turns, the bound at the bf16 peak."""
    base = name[:-len('_bf16')]
    plain1 = time_ms(torch, lambda: run('bfloat16', True), inner=inner)
    ms = time_ms(torch, lambda: run('bfloat16'), inner=inner)
    f32 = time_ms(torch, lambda: run('float32'), inner=inner)
    f32b = time_ms(torch, lambda: run('float32'), inner=inner)
    ms2 = time_ms(torch, lambda: run('bfloat16'), inner=inner)
    plain2 = time_ms(torch, lambda: run('bfloat16', True), inner=inner)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {'name': name, 'route': 'cuda', 'source': SOURCES[src],
            'replaces': REPLACES[base], 'launches': launches.get(name, 0),
            'max_abs_err': errs[name], 'ms': statistics.median([ms, ms2]),
            'plain_ms': statistics.median([plain1, plain2]),
            'bound_ms': 1e3 * max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'library_ms': None, 'dot_dtype': 'bfloat16',
            'fp32_ms': statistics.median([f32, f32b]),
            'flops': flops, 'bytes': nbytes, 'shape': shape,
            'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2],
            'fp32_ms_runs': [f32, f32b]}


# ------------------------------------------------------------ phase 11 --
def phase_bf16_dual_kernels(torch, fk):
    """Phase 11a: K7 and K8 in bf16 mode against their plain bf16 versions,
    full and first layer, at F = BF16_WIDTHS: at phase 3's ragged shape
    (B=3, N=61, K=39, R=12), the aspirin K-list training shape (B=10, N=24,
    K=48, R=20) and the 4096-atom box's (B=1, K=88, R=20), each with fp32
    and with bf16 edges; bars of bf16_vs_plain: each output within
    DUAL_BF16_BAR of its largest magnitude beyond one bf16 ulp, its median
    element error within BF16_MEDIAN_BAR, for the five weight cotangents
    alone within twice the plain version's own median distance from its
    float64 run where that is larger (plain_triples); K8's other four
    outputs are held and printed apart from its weight cotangents (`...
    weights` rows of the table); second launches repeat their bits. ->
    {variant: max abs error} at F=128 and the box shape with bf16 edges,
    the bf16 rows' shape in 11e."""
    dot = 'bfloat16'
    errs, table = {}, {}
    shapes = [('small', 3, 61, 39, 12), ('train', 10, 24, 48, 20),
              ('box', 1, BOX_ATOMS, BOX_K_MAX, 20)]
    for F in BF16_WIDTHS:
        for tag, B, N, K, R in shapes:
            for edt in (torch.float32, torch.bfloat16):
                et = 'bf16' if edt == torch.bfloat16 else 'fp32'
                for first in (False, True):
                    ins, tans, cots = klist_inputs(torch, B, N, K, F, R,
                                                   first, edt,
                                                   seed=F + N + K + 1)
                    args = dual_args(ins, tans)
                    fwd = fk.launch_key('klist_dual_fwd', first, dot)
                    bwd = fk.launch_key('klist_dual_bwd', first, dot)
                    where = f'F={F} {tag} {et} edges'

                    def k7(first=first):
                        return fk.klist_dual_fwd(*args, first_layer=first,
                                                 dot_dtype=dot)

                    def k8(first=first):
                        return fk.klist_dual_bwd(*args, *cots,
                                                 first_layer=first,
                                                 dot_dtype=dot)
                    got = k7()
                    ref = fk.klist_dual_fwd_ref(*args, first_layer=first,
                                                dot_dtype=dot)
                    res = {fwd: bf16_vs_plain(
                        torch, f'{fwd} {where}',
                        [(g, r, None) for g, r in zip(got, ref)])}
                    check(repeats(torch, k7), f'{fwd} {where} repeats')
                    got = k8()
                    ref = plain_triples(fk.klist_dual_bwd_ref, args + cots,
                                        got, first_layer=first,
                                        dot_dtype=dot)
                    # C16: the edge and node cotangents (outputs 0-3) at
                    # BF16_MEDIAN_BAR, held and printed apart from the
                    # weight cotangents (outputs 4-8), whose median bar
                    # has the float64 floor
                    res[bwd] = bf16_vs_plain(
                        torch, f'{bwd} {where}',
                        [(g, r, None) for g, r, _ in ref[:4]])
                    res[f'{bwd} weights'] = bf16_vs_plain(
                        torch, f'{bwd} {where} weights', ref[4:])
                    check(repeats(torch, k8), f'{bwd} {where} repeats')
                    for key, (w, m, a, r, mb) in res.items():
                        table[f'{key} F={F} {tag} {et}'] = [w, m, r, mb]
                        if F == 128 and tag == 'box' and et == 'bf16':
                            key = key.split()[0]
                            errs[key] = max(errs.get(key, 0.0), a)
                    del ins, tans, cots, args, got, ref
                    torch.cuda.empty_cache()
        emit('bf16_dual_kernel_vs_plain', F=F,
             max_beyond_ulp_median_raw_max_median_bar=table,
             bars={'max': DUAL_BF16_BAR, 'median': BF16_MEDIAN_BAR})
        table = {}
    return errs


def check_bf16_steps(what, losses, norms, jax_loss, jax_norm, shift, bar1,
                     norm_bar=1e-3):
    """Phase 11's bars on 10 fine-tuning steps against the JAX package's
    bf16 steps: step 1's loss, step 1's gradient norm and steps 2-10's
    losses, each within BF16_SPREAD_FACTOR times the JAX package's own
    bf16-to-fp32 shift of that quantity (`shift`), or within PR 2's fp32
    bar where that is larger: bar1 (relative) for step 1's loss, norm_bar
    for its gradient norm, 1e-2 for the later losses. -> {quantity:
    [difference, bar]}."""
    check(all(math.isfinite(v) for v in losses + norms),
          f'{what}: non-finite loss or gradient norm')
    out = {}

    def hold(name, got, want, sh, rel):
        bar = max(BF16_SPREAD_FACTOR * sh, rel * abs(want))
        out[name] = [abs(got - want), bar]
        check(abs(got - want) <= bar,
              f'{what}: {name} {got} against the JAX package\'s {want} '
              f'(bar {bar})')
    hold('step 1 loss', losses[0], jax_loss[0], shift['loss'][0], bar1)
    hold('step 1 grad norm', norms[0], jax_norm[0], shift['grad_norm'][0],
         norm_bar)
    for k in range(1, len(losses)):
        hold(f'step {k + 1} loss', losses[k], jax_loss[k], shift['loss'][k],
             1e-2)
    return out


def cli_epoch(torch, fd, fdd, fk, settings):
    """One epoch through the CLI's entry point: -> (seconds, launches,
    log.csv's first row, the best model reloaded)."""
    import csv
    import tempfile
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.train.cli import train_from_settings
    with tempfile.TemporaryDirectory() as out:
        settings['general']['output'] = out
        torch.cuda.synchronize()
        reset_counts(fd, fdd, fk)
        t = time.perf_counter()
        trainer = train_from_settings(settings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: v for k, v in lj_counts(fd, fdd, fk).items() if v}
        with open(os.path.join(trainer.output_path, 'log.csv')) as f:
            row = next(csv.DictReader(f))
        best = load_model(os.path.join(trainer.model_path,
                                       'best_model.msgpack'))
    check(list(row) == LOG_COLUMNS, f'log.csv columns {list(row)}')
    check(all(math.isfinite(float(row[k])) for k in LOG_COLUMNS[1:-1]),
          f'non-finite log.csv value: {row}')
    check(best.pallas_dot_dtype == 'bfloat16',
          f'the best model lost its dot dtype: {best.pallas_dot_dtype}')
    return seconds, launches, row, best


def phase_bf16_aspirin_train(torch, fd, fdd, fk):
    """Phase 11b: fine-tuning artifacts/md17_model_pallas with
    scripts/config_md17_pallas.yml and pallas_dot_dtype bfloat16, 10 steps
    dense (K1/K2 bf16, the duals K3/K4 in the default bf16) and 10 over
    plain K-lists built in each step (k_max 48; K5/K6 and K7/K8 bf16)
    against the JAX package's bf16 steps (JAX_BF16_ASPIRIN_STEP_*,
    check_bf16_steps; step 1's loss floor is phase 7a's bar1); the K-list
    step 1 gradient within BF16_KLIST_VS_DENSE (relative norm) of the dense
    one; one dense epoch through the CLI's entry point (95 steps) from a
    bf16 copy of the checkpoint. -> {what: launches}."""
    import tempfile
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    cfg = md17_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    loss_fns = get_loss_by_string(cfg['training']['loss'])

    def start(**changes):
        base = load_model(CKPT)
        model = NewtonNet(**dict(base.config_dict(), **changes),
                          device='cuda')
        model.load_state_dict(base.state_dict())
        set_scalers(model.core, model.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        return model.requires_grad_(True)

    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]
    # step 1's fp32 floor, phase 7a's: one float32 ulp of every frame's
    # energy, relative to the float64 loss
    loss64, ulp_term = float64_loss(fd, loss_fns[0], batches[0], start())
    bar1 = ulp_term / loss64
    out, grads1 = {}, {}
    for gm in ('dense', 'neighborlist'):
        reset_counts(fd, fdd, fk)
        losses, norms, step_s, g1, _, trainer = xla_steps(
            torch, start(graph_mode=gm, pallas_dot_dtype='bfloat16'),
            loss_fns, batches, 'auto')
        launches = {k: v for k, v in lj_counts(fd, fdd, fk).items() if v}
        check(trainer.fast_grad, f'bf16 aspirin {gm}: not fastgrad')
        grads1[gm] = g1
        bars = check_bf16_steps(
            f'bf16 aspirin {gm}', losses, norms,
            JAX_BF16_ASPIRIN_STEP_LOSS[gm],
            JAX_BF16_ASPIRIN_STEP_GRAD_NORM[gm],
            JAX_BF16_ASPIRIN_STEP_SHIFT[gm], bar1)
        emit('bf16_aspirin_train', graph_mode=gm, loss=losses,
             grad_norm=norms, jax_loss=JAX_BF16_ASPIRIN_STEP_LOSS[gm],
             jax_grad_norm=JAX_BF16_ASPIRIN_STEP_GRAD_NORM[gm],
             diff_and_bar=bars, step1_loss_floor=bar1,
             step_ms=[1e3 * t for t in step_s],
             step_ms_median=1e3 * statistics.median(step_s[1:]),
             launches_10_steps=launches)
        want = (BF16_DENSE + ('dual_fwd', 'dual_fwd_first', 'dual_bwd',
                              'dual_bwd_first')
                if gm == 'dense' else BF16_KLIST + BF16_DUAL)
        check(all(launches.get(k, 0) > 0 for k in want)
              and not set(launches) & set(fp32_names(fd.LAUNCHES)
                                          + fp32_names(fk.LAUNCHES)),
              f'bf16 aspirin {gm} steps launched {launches}')
        out[f'train_{gm}_10_steps'] = launches
        del trainer
        torch.cuda.empty_cache()
    rel = rel_norm(grads1['neighborlist'], grads1['dense'])
    emit('bf16_aspirin_klist_vs_dense', step1_grad_rel_norm=rel,
         bar=BF16_KLIST_VS_DENSE)
    check(rel <= BF16_KLIST_VS_DENSE,
          f'bf16 aspirin K-list vs dense step 1: {rel}')
    # the CLI warm-starts from the checkpoint's own config: a bf16 copy
    with tempfile.TemporaryDirectory() as tmp:
        start_path = os.path.join(tmp, 'bf16_start.msgpack')
        base = load_model(CKPT)
        bf16 = NewtonNet(**dict(base.config_dict(),
                                pallas_dot_dtype='bfloat16'), device='cuda')
        bf16.load_state_dict(base.state_dict())
        save_model(start_path, bf16)
        settings = md17_settings(None, 1)
        settings['model'].update(pallas_dot_dtype='bfloat16',
                                 pretrained_model={'path': start_path})
        seconds, launches, row, best = cli_epoch(torch, fd, fdd, fk,
                                                 settings)
    emit('bf16_aspirin_cli_epoch', seconds=seconds, launches=launches,
         log={k: row[k] for k in ('step', 'train_loss', 'val_loss',
                                  'test_loss', 'test_gradient_force_mae',
                                  'steps_per_s')})
    check(row['step'] == '95', f'expected 95 steps, got {row["step"]}')
    check(all(launches.get(k, 0) > 0 for k in BF16_DENSE),
          f'bf16 aspirin CLI epoch launched {launches}')
    out['cli_epoch_dense'] = launches
    return out


def phase_bf16_lj_train(torch, fd, fdd, fk):
    """Phase 11c: LJ_CONFIG's fine-tuning of LJ_CKPT as a kernel='pallas'
    bf16 model (F=48, prefetch 0, B=12, lj_pallas_data_settings), 10 steps
    dense and over plain precomputed K-lists with fp32 and with bf16 edges
    (10c's layouts) against the JAX package's bf16 steps
    (JAX_BF16_LJ_STEP_*, check_bf16_steps; phase 9c's floors); the K-list
    step 1 gradients' distance from the dense one within
    BF16_LJ_KLIST_FACTOR times the JAX package's, with the fp32-edge
    K-list step against the fp32-product dense step as the control that
    fails that bar; one K-list epoch through the CLI's entry point. ->
    {what: launches}."""
    import tempfile

    import yaml
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    with open(LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    loss_fns = get_loss_by_string(cfg['training']['loss'])
    lr = cfg['training']['optimizer']['adam']['lr']
    clip = cfg['training']['clip_grad']
    out, grads1 = {}, {}
    with tempfile.TemporaryDirectory() as root:
        write_lj_dataset(root)
        for layout, (gm, cd) in BF16_LJ_LAYOUTS.items():
            train_gen, _, _, stats = parse_train_test(
                seed=0, **lj_pallas_data_settings(root, gm))
            it = iter(train_gen)
            batches = [{k: torch.as_tensor(v).cuda()
                        for k, v in next(it).items()} for _ in range(10)]

            def start(gm=gm, stats=stats, **changes):
                model = lj_pallas_model(torch, gm, **changes)
                set_scalers(model.core, model.output_properties, stats,
                            {'energy': dict(cfg['training']['fit_scalers'])})
                return model.requires_grad_(True)
            if layout == 'dense':
                loss64, ulp_term = float64_loss(fd, loss_fns[0], batches[0],
                                                start())
                bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
            reset_counts(fd, fdd, fk)
            losses, norms, step_s, g1, _, trainer = xla_steps(
                torch, start(compute_dtype=cd, pallas_dot_dtype='bfloat16'),
                loss_fns, batches, 'auto', lr=lr, clip=clip)
            launches = {k: v for k, v in lj_counts(fd, fdd, fk).items() if v}
            check(trainer.fast_grad, f'bf16 LJ {layout}: not fastgrad')
            grads1[layout] = g1
            bars = check_bf16_steps(
                f'bf16 LJ {layout}', losses, norms,
                JAX_BF16_LJ_STEP_LOSS[layout],
                JAX_BF16_LJ_STEP_GRAD_NORM[layout],
                JAX_BF16_LJ_STEP_SHIFT[layout], bar1,
                norm_bar=2e-3 if gm == 'dense' else 1e-3)
            emit('bf16_lj_train', layout=layout, loss=losses,
                 grad_norm=norms, jax_loss=JAX_BF16_LJ_STEP_LOSS[layout],
                 jax_grad_norm=JAX_BF16_LJ_STEP_GRAD_NORM[layout],
                 diff_and_bar=bars, step1_loss_floor=bar1,
                 step_ms=[1e3 * t for t in step_s],
                 step_ms_median=1e3 * statistics.median(step_s[1:]),
                 launches_10_steps=launches)
            want = BF16_DENSE if gm == 'dense' else BF16_KLIST + BF16_DUAL
            check(all(launches.get(k, 0) > 0 for k in want),
                  f'bf16 LJ {layout} steps launched {launches}')
            out[f'train_{layout}_10_steps'] = launches
            del trainer
            torch.cuda.empty_cache()
        # C15: step 1's K-list-to-dense distance at BF16_LJ_KLIST_FACTOR
        # times the JAX package's; the control, the fp32-edge K-list step
        # against the fp32-product dense step, must fail its bar
        reset_counts(fd, fdd, fk)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **lj_pallas_data_settings(root, 'dense'))
        b0 = {k: torch.as_tensor(v).cuda()
              for k, v in next(iter(train_gen)).items()}
        model = lj_pallas_model(torch, 'dense')
        set_scalers(model.core, model.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        dense32 = xla_steps(torch, model.requires_grad_(True), loss_fns,
                            [b0], 'auto', lr=lr, clip=clip)[3]
        dist, bars = {}, {}
        for layout in BF16_LJ_LAYOUTS:
            if layout == 'dense':
                continue
            dist[layout] = rel_norm(grads1[layout], grads1['dense'])
            bars[layout] = (BF16_LJ_KLIST_FACTOR
                            * JAX_BF16_LJ_KLIST_VS_DENSE[layout])
        control = rel_norm(grads1['klist_fp32_edges'], dense32)
        emit('bf16_lj_klist_vs_dense', step1_grad_rel_norm=dist, bars=bars,
             jax=JAX_BF16_LJ_KLIST_VS_DENSE,
             factor=BF16_LJ_KLIST_FACTOR,
             control_vs_fp32_dense_fp32_edges=control,
             jax_control=JAX_BF16_LJ_KLIST_VS_FP32_DENSE)
        for layout, d in dist.items():
            check(d <= bars[layout], f'bf16 LJ {layout} step 1 gradient '
                  f'{d} from the dense one (bar {bars[layout]})')
        check(control > bars['klist_fp32_edges'],
              f'the control (fp32-product dense step, {control}) passes the '
              f'bar {bars["klist_fp32_edges"]}')
        settings = dict(
            cfg, general=dict(cfg['general'], device='cuda'),
            data=lj_pallas_data_settings(root, 'neighborlist'),
            model=dict(cfg['model'], **LJ_PALLAS,
                       pallas_dot_dtype='bfloat16'),
            training=dict(cfg['training'], epochs=1))
        seconds, launches, row, _ = cli_epoch(torch, fd, fdd, fk, settings)
    emit('bf16_lj_cli_epoch', config=LJ_CONFIG[len(ROOT) + 1:],
         model=settings['model'], seconds=seconds, launches=launches,
         log={k: row[k] for k in ('step', 'train_loss', 'val_loss',
                                  'test_loss', 'steps_per_s')})
    check(all(launches.get(k, 0) > 0 for k in BF16_KLIST + BF16_DUAL),
          f'bf16 LJ CLI epoch launched {launches}')
    out['cli_epoch_neighborlist'] = launches
    return out


def box_step_timings(torch, steps):
    """Phase 11d's timing: the box steps of `steps` ({dot dtype: one_step})
    taken three times each in turns (host clock, synchronised), then one
    of each under torch.profiler. -> {dot dtype: step ms (median), device
    busy ms, idle share, K5-K8 device ms, K8's share of the busy time}."""
    ms = {dot: [] for dot in steps}
    for _ in range(3):
        for dot, one_step in steps.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            one_step()
            torch.cuda.synchronize()
            ms[dot].append(1e3 * (time.perf_counter() - t))
    out = {}
    for dot, one_step in steps.items():
        prof = profile_call(torch, one_step)
        busy, fam = prof['device_busy_ms'], prof['kernel_ms']
        med = statistics.median(ms[dot])
        out[dot] = {'step_ms': ms[dot], 'step_ms_median': med,
                    'device_busy_ms': busy,
                    'device_idle_share_vs_unprofiled': 1.0 - busy / med,
                    **{f'{k}_ms': fam.get(name, 0.0) for k, name in (
                        ('k8', 'klist_dual_bwd'), ('k7', 'klist_dual_fwd'),
                        ('k6', 'klist_bwd'), ('k5', 'klist_fwd'))},
                    'k8_share_of_busy': fam.get('klist_dual_bwd', 0.0)
                    / busy, 'top_device_ms': prof['top_device_ms']}
    return out


def bf16_dual_timing(torch, fk, errs, launches, phase11):
    """Phase 11e: K7/K8 in bf16 mode beside fp32 mode at the box shape
    (B=1, N=4096, K=88, F=128, R=20, bf16 edges), full and first layer,
    with their plain bf16 versions' times (bf16_row: CUDA events in turns)
    and bounds at the bf16 peak or by bytes, and the same at F=48 (the LJ
    width) in each row's `widths`; the launches of the aspirin K-list
    fine-tuning's 10 steps, and of every phase 11 path in `phase11`. ->
    the `kernels` rows."""
    rows = []
    B, N, K, R = 1, BOX_ATOMS, BOX_K_MAX, 20
    for name in BF16_DUAL:
        first = '_first' in name
        fwd = name.startswith('klist_dual_fwd')
        kind = 'klist_dual_fwd' if fwd else 'klist_dual_bwd'
        row = None
        for F in (128, 48):
            ins, tans, cots = klist_inputs(torch, B, N, K, F, R, first,
                                           torch.bfloat16, seed=31)
            args = dual_args(ins, tans)

            def run(dot, ref=False, first=first, fwd=fwd, args=args,
                    cots=cots):
                if fwd:
                    f = fk.klist_dual_fwd_ref if ref else fk.klist_dual_fwd
                    return f(*args, first_layer=first, dot_dtype=dot)
                f = fk.klist_dual_bwd_ref if ref else fk.klist_dual_bwd
                return f(*args, *cots, first_layer=first, dot_dtype=dot)
            flops, nbytes = klist_work(B, N, K, F, R, kind, first, 2)
            r = bf16_row(torch, name, 'klist', run, flops, nbytes, errs,
                         launches, dict(B=B, N=N, K=K, F=F, R=R), inner=3)
            if row is None:
                row = r
            else:
                row['widths'] = {str(F): {k: r[k] for k in (
                    'ms', 'fp32_ms', 'plain_ms', 'bound_ms', 'bound_by',
                    'shape')}}
            del ins, tans, cots, args
            torch.cuda.empty_cache()
        row['phase11_launches'] = {what: n.get(name, 0)
                                   for what, n in phase11.items()}
        rows.append(row)
    emit('timing', what='K7/K8 in bf16 mode beside fp32 mode',
         peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
         rows={r['name']: {k: r[k] for k in (
             'ms', 'fp32_ms', 'plain_ms', 'bound_ms', 'shape', 'widths',
             'phase11_launches')} for r in rows})
    return rows


def hetero_copy(out):
    """data/lj_hetero's raw files under `out`, where the datasets write
    their caches."""
    import shutil
    for split in ('train', 'test'):
        shutil.copytree(os.path.join(HETERO_DIR, split, 'raw'),
                        os.path.join(out, split, 'raw'))
    return out


def hetero_settings(root, **data):
    """HETERO_CONFIG on CUDA, its data roots under `root` (a hetero_copy),
    with `data` changed."""
    import yaml
    with open(HETERO_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['general']['device'] = 'cuda'
    cfg['data'].update(train_root=os.path.join(root, 'train'),
                       test_root=os.path.join(root, 'test'), **data)
    return cfg


def hetero_start(torch, cfg, stats, **changes):
    """HETERO_CKPT's weights in a model with `changes`, its scalers refit
    as the CLI fits them (training.fit_scalers per output property)."""
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data.statistics import set_scalers
    base = load_model(HETERO_CKPT)
    model = NewtonNet(**dict(base.config_dict(), **changes), device='cuda')
    model.load_state_dict(base.state_dict())
    fit = cfg['training']['fit_scalers']
    set_scalers(model.core, model.output_properties, stats,
                {k: fit.get(k, {}) for k in model.output_properties})
    return model.requires_grad_(True)


def phase_hetero_train(torch, fd, fdd, fk):
    """Phase 12a/b: HETERO_CONFIG's bucketed batches (parse_train_test as
    the CLI calls it; the bucket sequence of the first 10 against
    JAX_LJ_HETERO_N_PAD, the epoch's against HETERO_BUCKETS).
    a. 10 training steps of HETERO_CKPT's XLA model (the standard step)
       against the JAX package's (JAX_LJ_HETERO_STEP_*, check_jax_steps:
       step 1's loss within the energies' rounding, floor LJ_STEP1_REL, its
       gradient norm at 1e-3, steps 2-10's losses at 1e-2).
    b. K1-K4 against their plain versions at every bucket's shape (B=20,
       N in HETERO_BUCKETS, F=64, R=20; phase 3's bars, 2e-3 for the bf16
       duals); the same checkpoint with a kernel='pallas' override trained
       by fastgrad (K1/K2, the duals K3/K4 in bf16) over the whole epoch:
       K1-K4 launched at every bucket size, step 1's gradient within 2e-3
       (relative norm) of 12a's. -> {n_pad: launches} of 12b's epoch."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    with tempfile.TemporaryDirectory() as root:
        cfg = hetero_settings(hetero_copy(root))
        t = time.perf_counter()
        train_gen, _, _, stats = parse_train_test(
            precision=np.float32, seed=cfg['general']['seed'], **cfg['data'])
        epoch = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
                 for b in train_gen]
        data_s = time.perf_counter() - t
    n_pads = [int(b['z'].shape[1]) for b in epoch]
    check(n_pads[:10] == JAX_LJ_HETERO_N_PAD,
          f'bucket sequence {n_pads[:10]}, the JAX loader\'s '
          f'{JAX_LJ_HETERO_N_PAD}')
    check(sorted(set(n_pads)) == list(HETERO_BUCKETS),
          f'the epoch\'s buckets {sorted(set(n_pads))}')
    loss_fns = get_loss_by_string(cfg['training']['loss'])
    lr = cfg['training']['optimizer']['adam']['lr']
    clip = cfg['training']['clip_grad']

    losses, norms, step_s, grads1, _, trainer = xla_steps(
        torch, hetero_start(torch, cfg, stats), loss_fns, epoch[:10], 'auto',
        lr=lr, clip=clip)
    check(not trainer.fast_grad, 'the XLA model resolved to fastgrad')
    loss64, ulp_term = float64_loss(fd, loss_fns[0], epoch[0],
                                    hetero_start(torch, cfg, stats))
    bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
    rel_loss, rel_gn = check_jax_steps(
        'hetero XLA', losses, norms, JAX_LJ_HETERO_STEP_LOSS,
        JAX_LJ_HETERO_STEP_GRAD_NORM, loss64, bar1)
    emit('hetero_train_xla', config=HETERO_CONFIG[len(ROOT) + 1:],
         checkpoint=HETERO_CKPT[len(ROOT) + 1:], n_pad=n_pads[:10],
         jax_n_pad=JAX_LJ_HETERO_N_PAD, epoch_batches=len(epoch),
         epoch_buckets={str(n): n_pads.count(n) for n in HETERO_BUCKETS},
         data_seconds=data_s, loss=losses, grad_norm=norms,
         jax_loss=JAX_LJ_HETERO_STEP_LOSS,
         jax_grad_norm=JAX_LJ_HETERO_STEP_GRAD_NORM, rel_loss=rel_loss,
         rel_grad_norm=rel_gn, loss64=loss64, step1_loss_bar=bar1,
         step_ms=[1e3 * t for t in step_s])
    del trainer
    torch.cuda.empty_cache()

    shapes = [(20, n, 64, 20) for n in HETERO_BUCKETS]
    phase_kernels(torch, fd, shapes=shapes)
    phase_dual_kernels(torch, fdd, shapes=shapes)
    model = hetero_start(torch, cfg, stats, kernel='pallas')
    opt = get_optimizer_by_string('adam', model.core, clip_grad=clip, lr=lr)
    trainer = Trainer(model, loss_fns=loss_fns, optimizer=opt)
    check(trainer.fast_grad, 'the pallas model did not resolve to fastgrad')
    launches = {n: dict.fromkeys(DENSE_FP32, 0) for n in HETERO_BUCKETS}
    step_ms = {n: [] for n in HETERO_BUCKETS}
    pallas_losses, pallas_grads1 = [], None
    with fp32_matmuls():
        for b in epoch:
            n = int(b['z'].shape[1])
            reset_counts(fd, fdd, fk)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = trainer.loss_and_grad(b)
            if pallas_grads1 is None:
                pallas_grads1 = param_grads(torch, model)
            opt.step()
            torch.cuda.synchronize()
            step_ms[n].append(1e3 * (time.perf_counter() - t))
            pallas_losses.append(float(loss))
            for k, v in lj_counts(fd, fdd, fk).items():
                if v:
                    launches[n][k] = launches[n].get(k, 0) + v
    rel = rel_norm(pallas_grads1, grads1)
    emit('hetero_train_pallas', steps=len(epoch), loss=pallas_losses,
         step1_grad_rel_norm_vs_xla=rel, bar=2e-3,
         step_ms_median_by_n_pad={str(n): statistics.median(v)
                                  for n, v in step_ms.items()},
         launches_by_n_pad={str(n): v for n, v in launches.items()})
    check(all(math.isfinite(v) for v in pallas_losses),
          f'non-finite pallas loss: {pallas_losses}')
    check(rel <= 2e-3, f'pallas step 1 gradient {rel} from the XLA one')
    check(all(launches[n][k] > 0 for n in HETERO_BUCKETS
              for k in DENSE_FP32),
          f'a dense kernel was not launched at every bucket: {launches}')
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def phase_hetero_cli(torch, fd, fdd, fk):
    """Phase 12c: one epoch of HETERO_CONFIG (with the kernel='pallas'
    override, fresh weights from the config's seed) through the CLI's entry
    point, in_memory 'sharded' with shards of HETERO_SHARD frames, its
    caches written into a hetero_copy: locality_block 'auto' with prefetch
    2 and 0, and locality_block 0 with prefetch 2; each run's seconds,
    log.csv's epoch_seconds and steps_per_s and the train root's
    shard_loads over the run. Held: log.csv's columns and finite values,
    the kernels launched, and that the sharded, prefetched loaders' epoch
    is that of the in_memory True loaders with the same seed and block
    (locality_block HETERO_SHARD), batch for batch. -> the first run's
    launches."""
    import csv
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.train.cli import train_from_settings
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        hetero_copy(root)
        for name, block, prefetch in (('auto_prefetch_2', 'auto', 2),
                                      ('auto_prefetch_0', 'auto', 0),
                                      ('block_0_prefetch_2', 0, 2)):
            cfg = hetero_settings(root, in_memory='sharded',
                                  shard_size=HETERO_SHARD,
                                  locality_block=block, prefetch=prefetch)
            cfg['general']['output'] = os.path.join(root, 'runs')
            cfg['model']['kernel'] = 'pallas'
            cfg['training']['epochs'] = 1
            torch.cuda.synchronize()
            reset_counts(fd, fdd, fk)
            t = time.perf_counter()
            trainer = train_from_settings(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            with open(os.path.join(trainer.output_path, 'log.csv')) as f:
                row = next(csv.DictReader(f))
            check(list(row) == LOG_COLUMNS, f'log.csv columns {list(row)}')
            check(all(math.isfinite(float(row[k]))
                      for k in LOG_COLUMNS[1:-1]),
                  f'non-finite log.csv value: {row}')
            runs[name] = {
                'seconds': seconds,
                'epoch_seconds': float(row['epoch_seconds']),
                'steps_per_s': float(row['steps_per_s']),
                'train_loss': float(row['train_loss']),
                'shard_loads_train_root':
                    trainer.train_generator.dataset.dataset.shard_loads,
                'launches': {k: v for k, v in lj_counts(fd, fdd,
                                                        fk).items() if v}}
            del trainer
        processed = sorted(os.listdir(os.path.join(root, 'train',
                                                   'processed')))
        data = hetero_settings(root, in_memory='sharded',
                               shard_size=HETERO_SHARD,
                               locality_block='auto', prefetch=2)['data']
        sharded = parse_train_test(precision=np.float32, seed=0, **data)
        data.pop('shard_size')
        in_memory = parse_train_test(precision=np.float32, seed=0, **dict(
            data, in_memory=True, locality_block=HETERO_SHARD, prefetch=0))
        batches = 0
        for gs, gm in zip(sharded[:3], in_memory[:3]):
            check(len(gs) == len(gm), 'loader lengths differ')
            for bs, bm in zip(gs, gm):
                check(bs.keys() == bm.keys() and all(
                    np.array_equal(bs[k], bm[k]) for k in bm),
                      f'sharded batch {batches} differs from in-memory')
                batches += 1
    emit('hetero_cli_epoch', config=HETERO_CONFIG[len(ROOT) + 1:],
         model={'kernel': 'pallas'}, shard_size=HETERO_SHARD,
         processed_files=processed, runs=runs,
         sharded_vs_in_memory_batches_equal=batches)
    first = runs['auto_prefetch_2']['launches']
    check(all(first.get(k, 0) > 0 for k in DENSE_FP32),
          f'the CLI epoch launched {first}')
    check('meta.npz' in processed and 'shard_0.npz' in processed,
          f'the sharded cache: {processed}')
    return first


def charge_head_tree(F, seed=CHARGE_SEED):
    """A charge head's parameters as flax initializes them, from numpy with
    `seed`: charge_head.TorchLinear_{0,1,2} (F -> F -> F -> 1), every kernel
    and bias U(+-1/sqrt(fan_in)); scaler_charge scale ones, shift zeros
    (119, 1); float32 numpy arrays in a flax-named tree."""
    import numpy as np
    rs = np.random.RandomState(seed)
    head = {}
    for i, (fan_in, out) in enumerate(((F, F), (F, F), (F, 1))):
        b = fan_in ** -0.5
        head[f'TorchLinear_{i}'] = {
            'kernel': rs.uniform(-b, b, (fan_in, out)).astype(np.float32),
            'bias': rs.uniform(-b, b, (out,)).astype(np.float32)}
    return {'charge_head': head, 'scaler_charge': {
        'scale': np.ones((119, 1), np.float32),
        'shift': np.zeros((119, 1), np.float32)}}


def with_charge_head(torch, base, output_properties, device='cuda',
                     **changes):
    """A model of base's configuration with `output_properties` (charge
    and/or bec among them) and `changes`: base's weights and
    charge_head_tree's charge head."""
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_from_flax, \
        params_to_flax
    model = NewtonNet(**{**base.config_dict(),
                         'output_properties': list(output_properties),
                         **changes}, device=device)
    tree = params_to_flax(base.core)['params']
    tree.update(charge_head_tree(base.n_features))
    params_from_flax({'params': {k: v for k, v in tree.items()
                                 if hasattr(model.core, k)}},
                     core=model.core)
    return model.requires_grad_(False).eval()


def charged_box_model(torch, base_cfg, device='cuda', outputs=None):
    """Phase 13b's model: box_model's newton3 box (F=128, 3 interactions,
    box_weights, half-list capacity BOX_N3_K_MAX, float32) with
    charge_head_tree's head and CHARGE_BOX_OUTPUTS (or `outputs`)."""
    base = box_model(torch, base_cfg, '', ['energy', 'gradient_force'],
                     device=device, newton3=True, k_max=BOX_N3_K_MAX)
    return with_charge_head(torch, base, outputs or CHARGE_BOX_OUTPUTS,
                            device=device)


def charged_lj_model(torch, device='cuda', bec=False):
    """Phase 13c's model: the trained newton3 LJ checkpoint (F=48, 2
    interactions, k_max 16) with charge_head_tree's head, its outputs plus
    charge (and bec)."""
    from newtonnet_tpu_torch import load_model
    base = load_model(LJ_CKPT, device=device)
    return with_charge_head(torch, base, base.output_properties + (
        ['charge', 'bec'] if bec else ['charge']), device=device)


def write_charged_lj_checkpoint(torch, root):
    """charged_lj_model (without bec) written by the port, in the JAX
    package's format, as root/lj_charged.msgpack. -> its path."""
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    path = os.path.join(root, 'lj_charged.msgpack')
    save_model(path, charged_lj_model(torch, device='cpu'))
    return path


def check_charge_aspirin(np, out, ref):
    """Phase 13a's outputs (numpy, a batch whose first CHARGE_FRAMES frames
    are the pinned ones) against CHARGE_REF: energies at E_ATOL, forces
    and charges at CHARGE_BAR, BEC at CHARGE_BAR of its largest magnitude.
    -> {output: (max |diff|, bar)}."""
    res = {}
    for key, name in CHARGE_ASPIRIN_KEYS.items():
        want = ref[f'JAX_CHARGE_ASPIRIN_{name}'].astype(np.float64)
        got = np.asarray(out[key][:CHARGE_FRAMES], np.float64)
        bar = {'energy': E_ATOL,
               'bec': CHARGE_BAR * float(np.abs(want).max())}.get(
                   key, CHARGE_BAR)
        res[key] = (float(np.abs(got - want).max()), bar)
        check(got.shape == want.shape and res[key][0] <= bar,
              f'13a {key} against the JAX package: {res[key]}')
    return res


def sum_rule(torch, bec, charge):
    """|sum_i Z*_i - (sum_i q_i) I| / sum_i |Z*_i| (Frobenius norms) of
    bec (N, 3, 3) and charge (N,), in float64."""
    bec, charge = bec.double(), charge.double()
    eye = torch.eye(3, dtype=bec.dtype, device=bec.device)
    resid = bec.sum(0) - charge.sum() * eye
    return float(torch.linalg.norm(resid)
                 / torch.linalg.norm(bec, dim=(1, 2)).sum())


def phase_charge_aspirin(torch, batches, samples, to_dev):
    """Phase 13a: the trained kernel='xla' aspirin checkpoint (XLA_CKPT:
    F=128, 20 basis, 3 interactions, cutoff 5, ewald_mode 'auto') with
    CHARGE_OUTPUTS and charge_head_tree's head serves the 500 test frames
    in batches of 100 through forward (both Ewald branches, 'auto'); the
    first CHARGE_FRAMES frames against the JAX package's (CHARGE_REF,
    check_charge_aspirin); 20 calculator requests (energy, forces,
    charges, bec), resolved to 'aperiodic', against the batches; the
    device time of the Ewald term (its forward and backward in charges
    and positions) and of the BEC's three reverse passes as shares of a
    batch's."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.ops.ewald import ewald_energy
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    base = load_model(XLA_CKPT)
    model = with_charge_head(torch, base, CHARGE_OUTPUTS)
    ref = dict(np.load(CHARGE_REF))
    model(*to_dev(batches[0]))
    served, batch_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(*to_dev(b))
        host = {k: out[k].cpu().numpy() for k in CHARGE_OUTPUTS}
        batch_s.append(time.perf_counter() - t)
        served.append(host)
    for h in served:
        check(all(np.isfinite(v).all() for v in h.values()),
              '13a: a served output is not finite')
        check(h['bec'].shape == (100, 21, 3, 3)
              and h['charge'].shape == (100, 21), '13a: output shapes')
    vs_jax = check_charge_aspirin(np, served[0], ref)
    e_mae = float(np.mean([np.abs(h['energy'] - b['energy']).mean()
                           for h, b in zip(served, batches)]))
    f_mae = float(np.mean([np.abs(h['gradient_force'] - b['force']).mean()
                           for h, b in zip(served, batches)]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'charged.msgpack')
        save_model(path, model)
        calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                     'charges', 'bec'])
    resolved = f'{calc.model.ewald_mode} -> {calc.model_for(None).ewald_mode}'
    lat, worst = [], {k: 0.0 for k in ('energy', 'forces', 'charges', 'bec')}
    first = served[0]
    for k in range(20):
        t = time.perf_counter()
        r = calc.calculate(numbers=samples[k]['z'],
                           positions=samples[k]['pos'])
        lat.append(time.perf_counter() - t)
        for key, want in (('energy', first['energy'][k]),
                          ('forces', first['gradient_force'][k]),
                          ('charges', first['charge'][k]),
                          ('bec', first['bec'][k])):
            worst[key] = max(worst[key], float(np.abs(r[key] - want).max()))
    b0 = to_dev(batches[0])
    nobec = with_charge_head(torch, base, ('energy', 'gradient_force',
                                           'charge'))
    q = torch.from_numpy(first['charge']).cuda().requires_grad_(True)
    pos = b0[1].clone().requires_grad_(True)

    def ewald():
        with torch.enable_grad():
            e = ewald_energy(q, pos, b0[2], b0[0] > 0,
                             sigma=model.ewald_sigma, n_k=model.ewald_n_k,
                             mode=model.ewald_mode)
            torch.autograd.grad(e.sum(), (q, pos))
    times = {'batch_ms': device_ms(torch, lambda: model(*b0)),
             'batch_without_bec_ms': device_ms(torch, lambda: nobec(*b0)),
             'batch_without_charge_head_ms': device_ms(
                 torch, lambda: base(*b0)),
             'ewald_forward_backward_ms': device_ms(torch, ewald)}
    times['ewald_share'] = times['ewald_forward_backward_ms'] \
        / times['batch_ms']
    times['bec_share'] = (times['batch_ms'] - times['batch_without_bec_ms']) \
        / times['batch_ms']
    emit('charge_aspirin', checkpoint=XLA_CKPT[len(ROOT) + 1:],
         outputs=CHARGE_OUTPUTS, ewald_mode=model.ewald_mode,
         frames=500, batch=100, vs_jax_first_frames=vs_jax,
         energy_mae=e_mae, force_mae=f_mae,
         batch_ms_median=1e3 * statistics.median(batch_s),
         calculator_ewald_mode=resolved, requests=20,
         requests_vs_batch_max_abs_diff=worst,
         request_ms_median=1e3 * statistics.median(lat),
         device_times=times)
    check(resolved == 'auto -> aperiodic', f'13a calculator: {resolved}')
    check(worst['energy'] <= E_ATOL and worst['forces'] <= F_ATOL
          and worst['charges'] <= F_ATOL
          and worst['bec'] <= CHARGE_BAR * float(np.abs(first['bec']).max()),
          f'13a requests against the batch: {worst}')


def phase_charge_box(torch, rg, xcfg):
    """Phase 13b: charged_box_model through the calculator over newton3
    half lists. The BOX_REF_ATOMS box (energy, forces, stress, charges;
    resolved 'auto -> periodic') against the JAX package's calculator
    (CHARGE_REF; phase 8a's bars: 1e-5 of the energy, 1e-4 of the largest
    magnitude of forces, stress and charges). The BOX_ATOMS box with bec:
    K9 and K12 launched (counted per request), the plain row gather giving
    the same bits for every output, every output finite, the acoustic sum
    rule at SUM_RULE_BAR, with a control that must fail it (the cross term
    weighted by the differentiating atom's own position, r_i (x) d(sum_j
    q_j)/dr_i), and the request times with bec and of the same weights
    without it. -> K9 launches per request, with and without bec."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.models.xla_stack import apply_core_xla
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    ref = dict(np.load(CHARGE_REF))
    model = charged_box_model(torch, xcfg)
    props = ['energy', 'forces', 'stress', 'charges']
    nobec = charged_box_model(torch, xcfg, outputs=[
        k for k in CHARGE_BOX_OUTPUTS if k != 'bec'])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'box.msgpack')
        save_model(path, model)
        calc = NewtonNetCalculator(path, properties=props + ['bec'])
        save_model(path, nobec)
        calc_nobec = NewtonNetCalculator(path, properties=props)
    del nobec
    z5, p5, c5, _, _ = box_system(BOX_REF_ATOMS)
    resolved = f'{calc.model.ewald_mode} -> ' \
        f'{calc.model_for(c5[0]).ewald_mode}'
    r5 = calc.calculate(numbers=z5[0], positions=p5[0], cell=c5[0])
    vs_jax = {}
    for key, name in CHARGE_BOX_KEYS.items():
        want = np.asarray(ref[f'JAX_CHARGE_BOX_{name}'], np.float64)
        diff = float(np.abs(np.asarray(r5[key], np.float64) - want).max())
        bar = (1e-5 if key == 'energy' else 1e-4) * float(np.abs(want).max())
        vs_jax[key] = (diff, bar)
    zb, pb, cb, _, _ = box_system()
    req = dict(numbers=zb[0], positions=pb[0], cell=cb[0])
    res, lat, launches, repeats = timed_requests(torch, rg, calc, req)
    _, lat_nobec, launches_nobec, _ = timed_requests(torch, rg, calc_nobec,
                                                     req)
    served = calc.model_for(cb[0])
    tz, tpos, tcell = [torch.from_numpy(a).cuda() for a in (zb, pb, cb)]
    nl = host_symmetric_nlist(served, tz, tpos, tcell, skin=0.0)
    out = served(tz, tpos, tcell, nlist=nl)
    plain = served(tz, tpos, tcell, nlist=nl, plain=True)
    outs = ('energy', 'gradient_force', 'stress', 'charge', 'bec')
    bitwise = all(exact(torch, out[k], plain[k]) for k in outs)
    finite = all(bool(torch.isfinite(out[k]).all()) for k in outs)
    del plain
    rule = sum_rule(torch, out['bec'][0], out['charge'][0])
    with torch.enable_grad():
        p = tpos.clone().requires_grad_(True)
        q = apply_core_xla(served, tz, p, tcell, nlist=nl)['charge']
        (g,) = torch.autograd.grad(q.sum(), p)
    eye = torch.eye(3, device='cuda')
    control = q.detach()[0, :, None, None] * eye + torch.einsum(
        'ia,ib->iab', p.detach()[0], g[0])
    rule_control = sum_rule(torch, control, q.detach()[0])
    torch.cuda.empty_cache()
    emit('charge_box', outputs=CHARGE_BOX_OUTPUTS, k_max_half=BOX_N3_K_MAX,
         calculator_ewald_mode=resolved, ref_atoms=BOX_REF_ATOMS,
         vs_jax=vs_jax, atoms=BOX_ATOMS,
         launches_per_request=launches,
         launches_per_request_without_bec=launches_nobec,
         kernel_vs_plain_bitwise=bitwise, outputs_finite=finite,
         requests_repeat_their_bits=repeats,
         sum_rule=rule, sum_rule_bar=SUM_RULE_BAR,
         sum_rule_control_own_position=rule_control,
         total_charge=float(out['charge'].sum()),
         request_ms_median=1e3 * statistics.median(lat),
         request_without_bec_ms_median=1e3 * statistics.median(lat_nobec))
    check(resolved == 'auto -> periodic', f'13b calculator: {resolved}')
    for key, (diff, bar) in vs_jax.items():
        check(diff <= bar, f'13b {key} against the JAX package: {diff}')
    check(launches['row_gather'] > 0 and launches['row_gather_b1'] > 0,
          f'13b: K9/K12 not launched: {launches}')
    check(bitwise, '13b: kernel and plain gathers differ')
    check(finite and repeats, '13b: outputs not finite or not repeated')
    check(rule <= SUM_RULE_BAR, f'13b sum rule: {rule}')
    check(rule_control > SUM_RULE_BAR,
          f'13b: the sum rule control passes ({rule_control})')
    return {'per_charge_box_request': launches,
            'per_charge_box_request_without_bec': launches_nobec}


def phase_charge_lj(torch, fd, rg):
    """Phase 13c: charged_lj_model over newton3 half lists. Its BEC and
    charges on lj_box's first LJ_CHARGE_FRAMES frames against the JAX
    package's (CHARGE_REF; BEC at CHARGE_BAR of its largest magnitude,
    charges at CHARGE_BAR). Then write_charged_lj_checkpoint's file
    fine-tuned by LJ_CONFIG (prefetch 0) on write_lj_dataset's frames over
    precompute_nlist mode newton3: 10 standard steps (the batches the
    Trainer trains on when it is given the loader; it is given them, and
    resolves ewald_mode from them and prints it) against
    the JAX package's (JAX_LJ_CHARGE_STEP_*, phase 8b's bars); step 1 by
    fast_grad True against the standard step 1 at FASTGRAD_CHARGE_BAR
    (relative norm), and as a control the same with fastgrad's energies
    without E_lr (the sum of the atomic energies), which must miss it.
    -> K9 launches (BEC frames, 10 steps)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import yaml
    from newtonnet_tpu_torch import Trainer, load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    ref = dict(np.load(CHARGE_REF))
    lj = charged_lj_model(torch, bec=True)
    z, pos, cell, _, _ = lj_box(n_frames=LJ_CHARGE_FRAMES)
    tz, tpos, tcell = (torch.from_numpy(z).cuda(),
                       torch.from_numpy(pos).float().cuda(),
                       torch.from_numpy(cell).float().cuda())
    rg.reset_launch_counts()
    out = lj(tz, tpos, tcell, nlist=host_symmetric_nlist(
        lj, tz, tpos, tcell, skin=0.0))
    bec_launches = dict(rg.LAUNCHES)
    want_bec = ref['JAX_LJ_CHARGE_BEC'].astype(np.float64)
    bec_diff = float(np.abs(out['bec'].double().cpu().numpy()
                            - want_bec).max())
    bec_bar = CHARGE_BAR * float(np.abs(want_bec).max())
    q_diff = float(np.abs(out['charge'].double().cpu().numpy()
                          - ref['JAX_LJ_CHARGE_CHARGE']).max())
    del lj
    with open(LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    main_loss = get_loss_by_string(cfg['training']['loss'])
    lr = cfg['training']['optimizer']['adam']['lr']
    with tempfile.TemporaryDirectory() as root:
        write_lj_dataset(root)
        ckpt = write_charged_lj_checkpoint(torch, root)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **lj_data_settings(root))
        # the batches a Trainer given this loader trains on: its peek at
        # the first batch (ewald_mode 'auto') draws one shuffle first, as
        # the JAX Trainer's does
        check(Trainer._peek_periodicity(train_gen) == 'periodic',
              '13c: the LJ batches are not periodic')
        it = iter(train_gen)
        batches = [next(it) for _ in range(10)]
        starts = []
        for _ in range(4):
            model = load_model(ckpt)
            set_scalers(model.core, model.output_properties, stats,
                        {'energy': dict(cfg['training']['fit_scalers'])})
            starts.append(model.requires_grad_(True))
    dbatches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()}
                for b in batches]
    said = io.StringIO()
    rg.reset_launch_counts()
    with contextlib.redirect_stdout(said):
        losses, norms, step_s, grads1, _, trainer = xla_steps(
            torch, starts[0], main_loss, dbatches, 'auto', lr=lr,
            clip=cfg['training']['clip_grad'], train_generator=batches)
    step_launches = dict(rg.LAUNCHES)
    said = [ln for ln in said.getvalue().splitlines()
            if ln.startswith('ewald_mode:')]
    nl0 = trainer._batch_nlist(dbatches[0])
    loss64, ulp_term = float64_loss(fd, main_loss[0], dbatches[0],
                                    starts[1], nlist=nl0)
    bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
    rel_loss, rel_gn = check_jax_steps(
        'charged LJ', losses, norms, JAX_LJ_CHARGE_STEP_LOSS,
        JAX_LJ_CHARGE_STEP_GRAD_NORM, loss64, bar1)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, fast1, _, _ = xla_steps(
            torch, starts[2], main_loss, dbatches[:1], True, lr=lr,
            clip=cfg['training']['clip_grad'], train_generator=batches)
    rel_fast = rel_norm(fast1, grads1)

    def short_range(model, batch, pos, pair_op=None, nlist=None,
                    plain=False):
        out = model._energy_and_aux(batch['z'], pos, None, batch['cell'],
                                    nlist=nlist, plain=plain)[1]
        return out['atomic_energy'][..., 0].sum(-1)
    kept = fastgrad._energies
    fastgrad._energies = short_range
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, _, _, ctl1, _, _ = xla_steps(
                torch, starts[3], main_loss, dbatches[:1], True, lr=lr,
                clip=cfg['training']['clip_grad'], train_generator=batches)
    finally:
        fastgrad._energies = kept
    rel_ctl = rel_norm(ctl1, grads1)
    emit('charge_lj', checkpoint=LJ_CKPT[len(ROOT) + 1:],
         frames=LJ_CHARGE_FRAMES, bec_vs_jax=(bec_diff, bec_bar),
         charges_vs_jax=(q_diff, CHARGE_BAR), bec_launches=bec_launches,
         trainer_said=said, loss=losses, grad_norm=norms,
         jax_loss=JAX_LJ_CHARGE_STEP_LOSS,
         jax_grad_norm=JAX_LJ_CHARGE_STEP_GRAD_NORM, rel_loss=rel_loss,
         rel_grad_norm=rel_gn, loss64=loss64, step1_loss_bar=bar1,
         fastgrad_step1_rel_norm=rel_fast,
         fastgrad_without_ewald_step1_rel_norm=rel_ctl,
         fastgrad_bar=FASTGRAD_CHARGE_BAR,
         step_ms_median=1e3 * statistics.median(step_s[1:]),
         launches_10_steps=step_launches)
    check(bec_diff <= bec_bar and q_diff <= CHARGE_BAR,
          f'13c BEC / charges against the JAX package: {bec_diff}, {q_diff}')
    check(said == ['ewald_mode: auto -> periodic (from the first training '
                   'batch)'], f'13c: the Trainer said {said}')
    check(rel_fast <= FASTGRAD_CHARGE_BAR, f'13c fast_grad: {rel_fast}')
    check(rel_ctl > FASTGRAD_CHARGE_BAR,
          f'13c: the control meets the fast_grad bar ({rel_ctl})')
    check(bec_launches['row_gather'] > 0 and step_launches['row_gather'] > 0,
          f'13c: K9 not launched: {bec_launches}, {step_launches}')
    return {'charged_lj_bec_4_frames': bec_launches,
            'charged_lj_10_steps': step_launches}


def direct_force_tree(F, seed=DIRECT_SEED):
    """A direct-force head's parameters from numpy with `seed`:
    direct_force_head.TorchLinear_{0,1,2} (F -> F -> F -> F), every kernel
    and bias U(+-1/sqrt(fan_in)) as flax initializes them, and
    scaler_direct_force's scale (119, 1) U(0.5, 1.5) (it has no shift);
    float32 numpy arrays in a flax-named tree."""
    import numpy as np
    rs = np.random.RandomState(seed)
    head = {}
    for i in range(3):
        b = F ** -0.5
        head[f'TorchLinear_{i}'] = {
            'kernel': rs.uniform(-b, b, (F, F)).astype(np.float32),
            'bias': rs.uniform(-b, b, (F,)).astype(np.float32)}
    return {'direct_force_head': head, 'scaler_direct_force': {
        'scale': rs.uniform(0.5, 1.5, (119, 1)).astype(np.float32)}}


def with_direct_force_head(torch, base, device='cuda'):
    """base's configuration and weights with direct_force added to its
    outputs and direct_force_tree's head."""
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_from_flax, \
        params_to_flax
    model = NewtonNet(**{**base.config_dict(), 'output_properties':
                         list(base.output_properties) + ['direct_force']},
                      device=device)
    tree = params_to_flax(base.core)['params']
    tree.update(direct_force_tree(base.n_features))
    params_from_flax({'params': tree}, core=model.core)
    return model.requires_grad_(False).eval()


def mass_weighted(np, h, z):
    """The (3n, 3n) mass-weighted Hessian H_ij / sqrt(m_i m_j) of h (n, 3,
    n, 3), float64, masses from MASSES by atomic number."""
    n = len(z)
    m = np.repeat(np.array([MASSES[int(a)] for a in z]), 3)
    return np.asarray(h, np.float64).reshape(3 * n, 3 * n) \
        / np.sqrt(np.outer(m, m))


def harmonic_eigenvalues(np, h, z):
    """The eigenvalues (eV / (A^2 u), ascending) of the symmetrized
    mass-weighted Hessian: the squared harmonic frequencies."""
    a = mass_weighted(np, h, z)
    return np.linalg.eigvalsh(0.5 * (a + a.T))


def hessian_bar(ref):
    """14a's bar: HESSIAN_SPREAD_FACTOR times the JAX package's float32-to-
    float64 spread of the aspirin Hessians in `ref`."""
    import numpy as np
    return HESSIAN_SPREAD_FACTOR * float(np.abs(
        ref['JAX_ASPIRIN_HESSIAN'].astype(np.float64)
        - ref['JAX_ASPIRIN_HESSIAN_FP64']).max())


def phase_hessian_aspirin(torch, rg):
    """Phase 14a: the aspirin checkpoint's Hessian through the calculator
    (HESSIAN_PROPS; 21 atoms padded to 24, 72 lanes at once): the first
    HESSIAN_FRAMES test frames against the JAX calculator's float32
    Hessians at hessian_bar, symmetric at that bar; frame 0's mass-weighted
    eigenvalues against the JAX float64 ones at HESSIAN_SPREAD_FACTOR
    times the spectral norm of the JAX package's float32 error (Weyl's
    bound); the model at 21 atoms with hessian_block HESSIAN_ASPIRIN_BLOCK
    (63 lanes: three blocks and a ragged one) against it unblocked; one
    request under torch.profiler. -> launches per request."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, \
        load_model
    from newtonnet_tpu_torch.data.loader import parse_xyz
    ref = dict(np.load(HESSIAN_REF))
    bar = hessian_bar(ref)
    samples = parse_xyz(XYZ)[:HESSIAN_FRAMES]
    calc = NewtonNetCalculator(XLA_CKPT, properties=HESSIAN_PROPS)
    calc.calculate(numbers=samples[0]['z'], positions=samples[0]['pos'])
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    lat, hs = [], []
    for s in samples:
        t = time.perf_counter()
        hs.append(calc.calculate(numbers=s['z'],
                                 positions=s['pos'])['hessian'])
        lat.append(time.perf_counter() - t)
    launches = {k: v // HESSIAN_FRAMES for k, v in rg.LAUNCHES.items()}
    prof = profile_call(torch, lambda: calc.calculate(
        numbers=samples[0]['z'], positions=samples[0]['pos']))
    got = np.stack(hs).astype(np.float64)
    want = ref['JAX_ASPIRIN_HESSIAN'].astype(np.float64)
    check(got.shape == want.shape == (HESSIAN_FRAMES, 21, 3, 21, 3)
          and np.isfinite(got).all(), f'14a: Hessian shape {got.shape}')
    diff = float(np.abs(got - want).max())
    sym = float(np.abs(got - got.transpose(0, 3, 4, 1, 2)).max())
    z0 = samples[0]['z']
    eig = harmonic_eigenvalues(np, got[0], z0)
    eig_diff = float(np.abs(eig - ref['JAX_ASPIRIN_FREQS']).max())
    eig_bar = HESSIAN_SPREAD_FACTOR * float(np.linalg.norm(mass_weighted(
        np, ref['JAX_ASPIRIN_HESSIAN'][0].astype(np.float64)
        - ref['JAX_ASPIRIN_HESSIAN_FP64'][0], z0), 2))
    base = load_model(XLA_CKPT)
    s0 = samples[0]
    z = torch.as_tensor(s0['z'])[None].cuda()
    pos = torch.as_tensor(s0['pos'], dtype=torch.float32)[None].cuda()
    cell = torch.zeros((1, 3, 3)).cuda()
    blocked = {}
    for block in (0, HESSIAN_ASPIRIN_BLOCK):
        m = NewtonNet(**dict(base.config_dict(), hessian_block=block,
                             output_properties=['energy', 'hessian']),
                      device='cuda')
        m.load_state_dict(base.state_dict())
        rg.reset_launch_counts()
        blocked[block] = m.requires_grad_(False)(z, pos, cell)['hessian'][0]
    block_diff = float((blocked[HESSIAN_ASPIRIN_BLOCK] - blocked[0]).abs()
                       .max())
    emit('hessian_aspirin', checkpoint=XLA_CKPT[len(ROOT) + 1:],
         frames=HESSIAN_FRAMES, lanes=3 * 24, vs_jax=(diff, bar),
         jax_fp32_to_fp64_spread=bar / HESSIAN_SPREAD_FACTOR,
         symmetry=(sym, bar), eigenvalues_vs_jax_fp64=(eig_diff, eig_bar),
         eigenvalues_frame0=eig.tolist(),
         blocked_vs_unblocked=dict(block=HESSIAN_ASPIRIN_BLOCK, lanes=63,
                                   max_abs_diff=block_diff, bar=bar),
         request_ms=[1e3 * t for t in lat], launches_per_request=launches,
         profile=prof)
    check(diff <= bar, f'14a Hessian against the JAX package: {diff} > {bar}')
    check(sym <= bar, f'14a Hessian symmetry: {sym} > {bar}')
    check(eig_diff <= eig_bar, f'14a eigenvalues: {eig_diff} > {eig_bar}')
    check(block_diff <= bar, f'14a hessian_block: {block_diff} > {bar}')
    return {'aspirin_per_request': launches}


def lj_hessian_calculator(torch, root, block):
    """The newton3 LJ checkpoint with the Hessian in its outputs and
    hessian_block `block`, written by the port as a user would configure
    it, served by a calculator with HESSIAN_PROPS."""
    from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, \
        load_model
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    base = load_model(LJ_CKPT)
    model = NewtonNet(**dict(base.config_dict(), hessian_block=block,
                             output_properties=list(base.output_properties)
                             + ['hessian']), device='cuda')
    model.load_state_dict(base.state_dict())
    path = os.path.join(root, f'lj_hessian_{block}.msgpack')
    save_model(path, model)
    return NewtonNetCalculator(path, properties=HESSIAN_PROPS)


def sum_rule_residual(np, h):
    """max_{i,a,b} |sum_j H[i,a,j,b]| / max |H| of h (n, 3, n, 3)."""
    h = np.asarray(h, np.float64)
    return float(np.abs(h.sum(axis=2)).max() / np.abs(h).max())


def phase_hessian_lj(torch, rg):
    """Phase 14b: the newton3 LJ checkpoint (F=48, 2 interactions, k_max
    16) on lj_box(LJ_HESSIAN_ATOMS) through the calculator (its half lists
    built on the host once per request), at each hessian_block of
    LJ_HESSIAN_BLOCKS (1536 lanes): the columns of the atoms
    LJ_HESSIAN_ATOMS_PICKED against the JAX package's HVPs at
    HESSIAN_SPREAD_FACTOR times its float32-to-float64 spread; the
    model's plain row gather giving the same bits; K9's folded launches
    doubling with the blocks and the others growing by blocks, not lanes;
    the translational sum rule at HESSIAN_SUM_BAR, with one block's lanes
    shifted by one as a control that fails it; request time and peak
    memory per block size, and unblocked where the two blocked peaks,
    extended linearly in the lanes, say it fits; one request at the first
    block size under torch.profiler. -> (launches per request, K9's
    folded shape (lanes, atoms, row width, rows))."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    ref = dict(np.load(HESSIAN_REF))
    z, pos, cell, _, _ = lj_box(n_atoms=LJ_HESSIAN_ATOMS)
    pos, cell = pos.astype(np.float32), cell.astype(np.float32)
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    n, lanes = LJ_HESSIAN_ATOMS, 3 * LJ_HESSIAN_ATOMS
    res = {}
    with tempfile.TemporaryDirectory() as root:
        for i, block in enumerate(LJ_HESSIAN_BLOCKS):
            calc = lj_hessian_calculator(torch, root, block)
            if i == 0:
                calc.calculate(**req)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rg.reset_launch_counts()
            t = time.perf_counter()
            r = calc.calculate(**req)
            res[block] = dict(
                ms=1e3 * (time.perf_counter() - t),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=dict(rg.LAUNCHES), hessian=r['hessian'])
            if i == 0:
                model = calc.model
                tz, tpos, tcell = (torch.from_numpy(a).cuda()
                                   for a in (z.astype(np.int64), pos, cell))
                nl = host_symmetric_nlist(model, tz, tpos, tcell, skin=0.0)
                plain = model(tz, tpos, tcell, nlist=nl, plain=True)[
                    'hessian'][0].cpu().numpy()
                same_bits = bool(np.array_equal(plain, r['hessian']))
                k_slots = int(nl[2].shape[1])
                del plain
                prof = profile_call(torch, lambda: calc.calculate(**req))
            del calc, r
        b0, b1 = LJ_HESSIAN_BLOCKS
        slope = (res[b0]['peak_gib'] - res[b1]['peak_gib']) / (b0 - b1)
        unblocked_gib = res[b1]['peak_gib'] + slope * (lanes - b1)
        total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        unblocked = {'predicted_peak_gib': unblocked_gib}
        if unblocked_gib < 0.8 * total_gib:
            calc = lj_hessian_calculator(torch, root, 0)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            r = calc.calculate(**req)
            unblocked.update(
                ms=1e3 * (time.perf_counter() - t),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                max_abs_diff_to_blocked=float(np.abs(
                    r['hessian'] - res[b0]['hessian']).max()))
            del calc, r
    torch.cuda.empty_cache()
    rows32 = ref['JAX_LJ_HESSIAN_ROWS'].astype(np.float64)
    rows_bar = HESSIAN_SPREAD_FACTOR * float(np.abs(
        rows32 - ref['JAX_LJ_HESSIAN_ROWS_FP64']).max())
    cols = [(a, d) for a in LJ_HESSIAN_ATOMS_PICKED for d in range(3)]
    out = {}
    for block, r in res.items():
        h = r['hessian']
        check(h.shape == (n, 3, n, 3) and np.isfinite(h).all(),
              f'14b: Hessian shape {h.shape} at block {block}')
        got = np.stack([h[:, :, a, d] for a, d in cols]).astype(np.float64)
        ctl = h.reshape(lanes, lanes).copy()
        ctl[:, b0:2 * b0] = np.roll(ctl[:, b0:2 * b0], 1, axis=1)
        n_blocks = -(-lanes // block)
        out[block] = dict(
            blocks=n_blocks, request_ms=r['ms'], peak_gib=r['peak_gib'],
            launches=r['launches'],
            vs_jax_rows=float(np.abs(got - rows32).max()),
            sum_rule=sum_rule_residual(np, h),
            sum_rule_control=sum_rule_residual(
                np, ctl.reshape(n, 3, n, 3)))
    jax_sum = float(np.abs(rows32.sum(axis=1)).max() / np.abs(rows32).max())
    (l0, l1) = (res[b]['launches'] for b in LJ_HESSIAN_BLOCKS)
    n0, n1 = (out[b]['blocks'] for b in LJ_HESSIAN_BLOCKS)
    flat0 = l0['row_gather'] - l0['row_gather_folded']
    flat1 = l1['row_gather'] - l1['row_gather_folded']
    per_block = (flat1 - flat0) / (n1 - n0)
    energy_pass = flat0 - n0 * per_block
    emit('hessian_lj', checkpoint=LJ_CKPT[len(ROOT) + 1:], atoms=n,
         lanes=lanes, half_list_slots=k_slots, per_block_size=out,
         unblocked=unblocked, profile_first_block=prof, jax_rows_bar=rows_bar,
         jax_rows_sum_rule=jax_sum, sum_rule_bar=HESSIAN_SUM_BAR,
         plain_row_gather_same_bits=same_bits,
         unfolded_launches=dict(per_block=per_block,
                                energy_pass=energy_pass))
    for block, o in out.items():
        check(o['vs_jax_rows'] <= rows_bar,
              f'14b columns against the JAX package at block {block}: '
              f'{o["vs_jax_rows"]} > {rows_bar}')
        check(o['sum_rule'] <= HESSIAN_SUM_BAR,
              f'14b sum rule at block {block}: {o["sum_rule"]}')
        check(o['sum_rule_control'] > HESSIAN_SUM_BAR,
              f'14b: the sum-rule control passes ({o["sum_rule_control"]})')
    check(same_bits, '14b: the plain row gather gives other bits')
    check(l0['row_gather_folded'] > 0 and l1['row_gather_folded']
          == l0['row_gather_folded'] * n1 // n0,
          f'14b: folded K9 launches do not follow the blocks: {l0}, {l1}')
    check(per_block > 0 and energy_pass >= 0
          and per_block == int(per_block),
          f'14b: K9 launches do not grow by blocks: {l0}, {l1}')
    shape = (b0, n, 4 * model.n_features, k_slots * n)
    return ({f'lj_per_request_block_{b}': res[b]['launches']
             for b in LJ_HESSIAN_BLOCKS}, shape)


def hessian_folded_timing(torch, rg, shape, launches):
    """K9 at 14b's largest folded shape (the second layer's gather of
    [message | 3 x force] rows over the half list, at L lanes of one
    graph): CUDA-event times of the kernel, its plain version and
    torch.gather, each checked bitwise against the plain result; the
    bound: bytes written, the indices and one read of the source over the
    memory rate."""
    L, n, F4, R = shape
    g = torch.Generator(device='cuda').manual_seed(51)
    x = torch.randn((L, n, F4), generator=g, device='cuda')
    idx = torch.randint(0, n, (L, R), generator=g, device='cuda')
    want = rg.row_gather_ref(x, idx)
    got = rg.row_gather(x, idx)
    lib = torch.gather(x, 1, idx[..., None].expand(L, R, F4))
    err = float((got - want).abs().max())
    check(torch.equal(got, want) and torch.equal(lib, want),
          '14: K9 at the folded Hessian shape is not bitwise')
    del got, want, lib
    plain1 = time_ms(torch, lambda: rg.row_gather_ref(x, idx), inner=3)
    ms = time_ms(torch, lambda: rg.row_gather(x, idx), inner=3)
    ms2 = time_ms(torch, lambda: rg.row_gather(x, idx), inner=3)
    plain2 = time_ms(torch, lambda: rg.row_gather_ref(x, idx), inner=3)
    lib_ms = time_ms(torch, lambda: torch.gather(
        x, 1, idx[..., None].expand(L, R, F4)), inner=3)
    nbytes = L * R * F4 * 4 + L * R * 8 + L * n * F4 * 4
    return {'shape': f'x ({L}, {n}, {F4}) fp32, idx ({L}, {R})',
            'launches': launches, 'max_abs_err': err,
            'ms': statistics.median([ms, ms2]),
            'plain_ms': statistics.median([plain1, plain2]),
            'bound_ms': 1e3 * nbytes / PEAK_BYTES_PER_S, 'bound_by': 'bytes',
            'library_ms': lib_ms, 'bytes': nbytes, 'ms_runs': [ms, ms2],
            'plain_ms_runs': [plain1, plain2]}


def phase_direct_force(torch, fd):
    """Phase 14c: the aspirin checkpoint with direct_force_tree's head.
    The first DIRECT_FRAMES test frames' direct forces against the JAX
    package's (HESSIAN_REF) at CHARGE_BAR; 10 standard fine-tuning steps
    with DIRECT_LOSS ('auto' resolves to the standard step for this
    kernel='xla' model, as in the JAX Trainer) on the batches of phase
    7f against JAX_DIRECT_STEP_* (phase 13c's bars); fast_grad True
    refused with the JAX Trainer's ValueError."""
    import numpy as np
    from newtonnet_tpu_torch import Trainer, load_model
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    ref = dict(np.load(HESSIAN_REF))
    model = with_direct_force_head(torch, load_model(XLA_CKPT))
    batch = collate(parse_xyz(XYZ)[:DIRECT_FRAMES], n_pad=21)
    out = model(*(torch.from_numpy(batch[k]).cuda()
                  for k in ('z', 'pos', 'cell')))
    got = out['direct_force'].double().cpu().numpy()
    want = ref['JAX_DIRECT_FORCES'].astype(np.float64)
    diff = float(np.abs(got - want).max())
    check(got.shape == want.shape and np.isfinite(got).all(),
          f'14c: direct forces {got.shape}')
    cfg = xla_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]

    def start():
        m = with_direct_force_head(torch, load_model(XLA_CKPT))
        set_scalers(m.core, m.output_properties, stats,
                    {'energy': dict(cfg['training']['fit_scalers'])})
        return m.requires_grad_(True)
    loss_fns = get_loss_by_string(DIRECT_LOSS)
    losses, norms, step_s, _, _, trainer = xla_steps(
        torch, start(), loss_fns, batches, 'auto')
    loss64, ulp_term = float64_loss(fd, loss_fns[0], batches[0], start())
    bar1 = max(ulp_term / loss64, LJ_STEP1_REL)
    rel_loss, rel_gn = check_jax_steps(
        'direct force', losses, norms, JAX_DIRECT_STEP_LOSS,
        JAX_DIRECT_STEP_GRAD_NORM, loss64, bar1)
    refused = None
    try:
        Trainer(start(), loss_fns=loss_fns, fast_grad=True)
    except ValueError as exc:
        refused = str(exc)
    emit('direct_force', checkpoint=XLA_CKPT[len(ROOT) + 1:],
         frames=DIRECT_FRAMES, vs_jax=(diff, CHARGE_BAR), loss=losses,
         grad_norm=norms, jax_loss=JAX_DIRECT_STEP_LOSS,
         jax_grad_norm=JAX_DIRECT_STEP_GRAD_NORM, rel_loss=rel_loss,
         rel_grad_norm=rel_gn, loss64=loss64, step1_loss_bar=bar1,
         standard_step=not trainer.fast_grad,
         fast_grad_true_refused=refused,
         step_ms_median=1e3 * statistics.median(step_s[1:]))
    check(diff <= CHARGE_BAR, f'14c direct forces against JAX: {diff}')
    check(not trainer.fast_grad, "14c: 'auto' did not take the standard "
          'step')
    check(refused is not None and 'fast_grad requires losses' in refused,
          f'14c: fast_grad True not refused: {refused}')


def phase_ensemble(torch):
    """Phase 14d: the ENSEMBLE_CKPTS checkpoints as one calculator (a list
    model_path): the first ENSEMBLE_MAE_FRAMES test frames as single
    requests, the first ENSEMBLE_REQUESTS against the JAX ensemble
    calculator's energies and forces (HESSIAN_REF) at E_ATOL / F_ATOL,
    and the ensemble's energy and force MAE against the JAX ensemble's
    over all of them at ENSEMBLE_MAE_BARS; request time beside one
    member's."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.data.loader import parse_xyz
    ref = dict(np.load(HESSIAN_REF))
    samples = parse_xyz(XYZ)[:ENSEMBLE_MAE_FRAMES]
    calc = NewtonNetCalculator(ENSEMBLE_CKPTS)
    one = NewtonNetCalculator(ENSEMBLE_CKPTS[0])
    check(len(calc.members) == len(ENSEMBLE_CKPTS), '14d: members')
    energy, forces, lat, lat1 = [], [], [], []
    for s in samples:
        req = dict(numbers=s['z'], positions=s['pos'])
        t = time.perf_counter()
        r = calc.calculate(**req)
        lat.append(time.perf_counter() - t)
        energy.append(r['energy'])
        forces.append(r['forces'])
        if len(lat1) < ENSEMBLE_REQUESTS:
            t = time.perf_counter()
            one.calculate(**req)
            lat1.append(time.perf_counter() - t)
    energy, forces = np.asarray(energy), np.stack(forces)
    k = ENSEMBLE_REQUESTS
    e_diff = float(np.abs(energy[:k] - ref['JAX_ENSEMBLE_ENERGY'][:k]).max())
    f_diff = float(np.abs(forces[:k] - ref['JAX_ENSEMBLE_FORCES'][:k]).max())
    labels_e = np.array([s['energy'] for s in samples], np.float64)
    labels_f = np.stack([s['force'] for s in samples])
    mae = {'energy': float(np.abs(energy - labels_e).mean()),
           'forces': float(np.abs(forces - labels_f).mean())}
    jax_mae = {'energy': float(np.abs(ref['JAX_ENSEMBLE_ENERGY']
                                      - labels_e).mean()),
               'forces': float(np.abs(ref['JAX_ENSEMBLE_FORCES']
                                      - labels_f).mean())}
    emit('ensemble', checkpoints=[c[len(ROOT) + 1:] for c in ENSEMBLE_CKPTS],
         requests_vs_jax=dict(energy=(e_diff, E_ATOL),
                              forces=(f_diff, F_ATOL)),
         frames=len(samples), mae=mae, jax_mae=jax_mae,
         mae_bars=ENSEMBLE_MAE_BARS,
         request_ms_median=1e3 * statistics.median(lat),
         one_member_request_ms_median=1e3 * statistics.median(lat1))
    check(e_diff <= E_ATOL and f_diff <= F_ATOL,
          f'14d requests against the JAX ensemble: {e_diff}, {f_diff}')
    for key, bar in ENSEMBLE_MAE_BARS.items():
        check(abs(mae[key] - jax_mae[key]) <= bar,
              f'14d {key} MAE {mae[key]} against the JAX ensemble\'s '
              f'{jax_mae[key]}')


@functools.lru_cache(maxsize=None)
def card_name():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else 'nvidia-smi gave nothing'


def md_emit(phase, **fields):
    """emit with the card beside phase 15's times."""
    emit(phase, card=card_name(), **fields)


def md_record(np, path=MD_LOG):
    """An md.log's columns: time (ps), Epot (eV), T (K)."""
    a = np.loadtxt(path, skiprows=1, ndmin=2)
    return a[:, 0], a[:, 2], a[:, 4]


def window_mean(np, t, x, window):
    sel = (t >= window[0]) & (t < window[1])
    return x[sel].mean(axis=0)


def syncs_per_step(torch, step, steps=10):
    """Host syncs per call of `step` over `steps` calls (after one warm
    call), as torch.cuda.set_sync_debug_mode('warn') reports them, with
    the source lines that made them."""
    import collections
    import warnings
    step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            for _ in range(steps):
                step()
            seen = list(caught)  # not the mode switch's own
        finally:
            torch.cuda.set_sync_debug_mode('default')
    where = collections.Counter(
        f'{os.path.relpath(w.filename, ROOT)}:{w.lineno}' for w in seen
        if 'synchroniz' in str(w.message))
    return sum(where.values()) / steps, dict(where.most_common(6))


def md_step_fn(torch, model, z, masses, cell, pos, nlist=None):
    """One Langevin step of md/driver as the driver takes it (noise drawn on
    the card, then driver.langevin_step) at a fixed list, for counting
    syncs. -> a function of no arguments."""
    from newtonnet_tpu_torch.data.units import fs, kB
    from newtonnet_tpu_torch.md import driver
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.no_grad():
        _, f = driver._energy_forces(model, z, pos, cell, nlist)
    state = [(pos, torch.zeros_like(pos), f)]

    def step():
        with torch.no_grad():
            noise = [torch.randn(pos.shape, generator=gen, device='cuda')
                     for _ in range(2)]
            state[0] = driver.langevin_step(
                model, z, masses, cell, state[0], *noise, dt=0.5 * fs,
                temp=kB * 300.0, friction=1 / (500 * fs), nlist=nlist)[0]
    return step


def padded_batch(torch, systems):
    """(z, masses, cell, pos) of md/driver's padded replica batch, on the
    card."""
    import numpy as np
    from newtonnet_tpu_torch.md import driver
    z, pos, _, masses, cell = driver._pad_systems(systems, np.float32)
    return [torch.from_numpy(a).cuda() for a in (z, masses, cell, pos)]


def aspirin_systems(n=MD_REPLICAS, temperature=None):
    """n copies of the first test frame (XYZ), at rest or with
    Maxwell-Boltzmann momenta at `temperature` (default_rng(k) for copy
    k)."""
    import numpy as np
    from newtonnet_tpu_torch.data.xyz import read_extxyz
    from newtonnet_tpu_torch.md import System, maxwell_boltzmann
    frame = read_extxyz(XYZ)[0]
    out = []
    for k in range(n):
        s = System.from_frame(frame)
        if temperature is not None:
            maxwell_boltzmann(s, temperature, rng=np.random.default_rng(k))
        out.append(s)
    return out


def phase_md_aspirin(torch):
    """Phase 15a: XLA_CKPT's MD_REPLICAS replicas of MD_LOG's run through
    run_langevin_on_device against the record (MD_T_BAR, MD_EPOT_BAR over
    MD_WINDOW, the control window failing the temperature bar), with the
    standard errors of both means; then the entry point `python -m
    newtonnet_tpu_torch.md.simulate --on-device` writing an md.log in
    the record's format."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.md.driver import run_langevin_on_device
    model = load_model(XLA_CKPT)
    dt = 0.5 * units.fs
    t_ref, e_ref, temp_ref = md_record(np)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, log = run_langevin_on_device(
        model, None, aspirin_systems(), timestep=dt, temperature_K=300.0,
        friction=1 / (500 * units.fs), n_steps=MD_ASPIRIN_STEPS,
        log_every=MD_LOG_EVERY, seed=0)
    seconds = time.perf_counter() - t0
    t = np.arange(len(log['epot'])) * MD_LOG_EVERY * dt / units.ps
    check(np.isfinite(log['epot']).all() and np.isfinite(log['ekin']).all(),
          '15a: the trajectory is not finite')
    temp, epot = log['temperature'], log['epot'].astype(np.float64)
    means = {'T': window_mean(np, t, temp, MD_WINDOW),
             'Epot': window_mean(np, t, epot, MD_WINDOW)}  # (M,) each
    ref = {'T': window_mean(np, t_ref, temp_ref, MD_REF_WINDOW),
           'Epot': window_mean(np, t_ref, e_ref, MD_REF_WINDOW)}
    # the record's standard error from 1 ps blocks; the port's from the
    # spread of the replicas' window means
    blocks = np.arange(MD_REF_WINDOW[0], MD_REF_WINDOW[1], 1.0)
    out = {}
    for key, bar in (('T', MD_T_BAR), ('Epot', MD_EPOT_BAR)):
        col = temp_ref if key == 'T' else e_ref
        b = [window_mean(np, t_ref, col, (lo, lo + 1.0)) for lo in blocks]
        se_ref = float(np.std(b, ddof=1) / np.sqrt(len(b)))
        se = float(np.std(means[key], ddof=1) / np.sqrt(len(means[key])))
        out[key] = dict(port=float(means[key].mean()), record=float(ref[key]),
                        diff=float(means[key].mean() - ref[key]), bar=bar,
                        port_se=se, record_se=se_ref,
                        combined_se=float(np.hypot(se, se_ref)))
    control = float(window_mean(np, t, temp, MD_CONTROL_WINDOW).mean())
    control_ref = float(window_mean(np, t_ref, temp_ref, MD_CONTROL_WINDOW))
    md_emit('md_aspirin', checkpoint=XLA_CKPT[len(ROOT) + 1:],
         replicas=MD_REPLICAS, steps=MD_ASPIRIN_STEPS, window_ps=MD_WINDOW,
         record_window_ps=MD_REF_WINDOW, vs_record=out,
         control_window_ps=MD_CONTROL_WINDOW, control_T=control,
         control_record_T=control_ref,
         control_fails_the_bar=bool(abs(control - ref['T']) > MD_T_BAR),
         seconds=seconds, steps_per_s=MD_ASPIRIN_STEPS / seconds,
         counters=[log['nlist_overflow'], log['skin_violations']])
    for key, o in out.items():
        check(abs(o['diff']) <= o['bar'], f'15a: mean {key} {o}')
    check(abs(control - ref['T']) > MD_T_BAR,
          f'15a: the control window passes the T bar: {control}')
    sysm = padded_batch(torch, aspirin_systems())
    rate, where = syncs_per_step(torch, md_step_fn(
        torch, model, *sysm))
    md_emit('md_syncs', path='15a dense XLA aspirin, 8 replicas',
         syncs_per_step=rate, where=where)

    out_dir = tempfile.mkdtemp(prefix='md_simulate_')
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, '-m', 'newtonnet_tpu_torch.md.simulate',
         '--on-device', '--steps', str(MD_SIMULATE_STEPS), '--out', out_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f'15a: simulate failed: {run.stderr[-2000:]}')
    with open(os.path.join(out_dir, 'md.log')) as f:
        lines = f.read().splitlines()
    with open(MD_LOG) as f:
        header = f.readline().rstrip('\n')
    n_lines = MD_SIMULATE_STEPS // 100
    ok = lines[0] == header and len(lines) == n_lines + 1
    for line in lines[1:]:
        v = [float(x) for x in line.split()]
        ok = ok and len(v) == 5 and np.isfinite(v).all() and line == (
            f'{v[0]:<10.4f} {v[1]:12.4f} {v[2]:12.4f} {v[3]:12.4f} '
            f'{v[4]:6.1f}')
    md_emit('md_simulate', steps=MD_SIMULATE_STEPS, lines=lines,
         seconds=time.perf_counter() - t0, format_ok=bool(ok))
    check(ok, f'15a: simulate md.log: {lines}')


def nhc_drift(np, log):
    """The largest |conserved(t) - conserved(0)| over the replicas."""
    c = log['conserved'].astype(np.float64)
    return float(np.abs(c - c[:1]).max())


def phase_md_pallas(torch, fd):
    """Phase 15b: CKPT (K1/K2) through run_nhc_on_device, MD_REPLICAS
    replicas at 300 K: the conserved quantity's drift over MD_NHC_STEPS
    within MD_DRIFT_BAR, a run at 4x the timestep missing it; peak memory
    after MD_NHC_STEPS steps equal to that after 10; MD_NVE_STEPS
    friction-0 Langevin steps on the card against the same run with the
    model on the CPU (plain versions) within MD_TRAJ_BAR.
    -> {K1/K2 key: launches per step}."""
    import numpy as np
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.md.driver import (run_langevin_on_device,
                                               run_nhc_on_device)
    model = load_model(CKPT)
    kw = dict(temperature_K=300.0, tdamp=50 * units.fs)
    run_nhc_on_device(model, None, aspirin_systems(2, 300.0),
                      timestep=0.5 * units.fs, n_steps=2, log_every=1, **kw)
    torch.cuda.synchronize()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    _, log = run_nhc_on_device(model, None, aspirin_systems(temperature=300.0),
                               timestep=0.5 * units.fs, n_steps=MD_NHC_STEPS,
                               log_every=MD_LOG_EVERY, **kw)
    seconds = time.perf_counter() - t0
    launches = {k: v / (MD_NHC_STEPS + 1)
                for k, v in fd.LAUNCHES.items() if v}
    parts = {}
    t0 = time.perf_counter()
    # the control covers the same simulated time in a quarter of the steps
    _, control = run_nhc_on_device(
        model, None, aspirin_systems(temperature=300.0),
        timestep=2.0 * units.fs, n_steps=MD_NHC_STEPS // 4,
        log_every=MD_LOG_EVERY // 4, **kw)
    parts['control'] = time.perf_counter() - t0
    drift, drift_control = nhc_drift(np, log), nhc_drift(np, control)
    t0 = time.perf_counter()
    peaks = {}
    for n in (10, MD_NHC_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_nhc_on_device(model, None, aspirin_systems(temperature=300.0),
                          timestep=0.5 * units.fs, n_steps=n, log_every=n,
                          **kw)
        peaks[n] = torch.cuda.max_memory_allocated()
    parts['memory'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nve = dict(timestep=0.5 * units.fs, temperature_K=300.0, friction=0.0,
               n_steps=MD_NVE_STEPS, log_every=1)
    card, log_card = run_langevin_on_device(
        model, None, aspirin_systems(temperature=300.0), **nve)
    cpu, log_cpu = run_langevin_on_device(
        load_model(CKPT, device='cpu'), None,
        aspirin_systems(temperature=300.0), **nve)
    parts['nve_card_and_cpu'] = time.perf_counter() - t0
    traj_diff = max(float(np.abs(a.positions - b.positions).max())
                    for a, b in zip(card, cpu))
    epot_diff = float(np.abs(log_card['epot'] - log_cpu['epot']).max())
    md_emit('md_pallas_nhc', checkpoint=CKPT[len(ROOT) + 1:],
         replicas=MD_REPLICAS, steps=MD_NHC_STEPS,
         conserved_drift_eV=drift, drift_bar=MD_DRIFT_BAR,
         control_drift_eV_at_2fs=drift_control,
         control_fails_the_bar=bool(drift_control > MD_DRIFT_BAR),
         mean_T=float(log['temperature'].mean()), seconds=seconds,
         other_seconds=parts,
         steps_per_s=MD_NHC_STEPS / seconds,
         k1_k2_launches_per_step=launches,
         peak_bytes_after_steps={str(k): v for k, v in peaks.items()},
         nve_steps=MD_NVE_STEPS, card_vs_cpu_positions=traj_diff,
         card_vs_cpu_epot=epot_diff, positions_bar=MD_TRAJ_BAR)
    check(np.isfinite(log['conserved']).all(), '15b: NHC not finite')
    check(drift <= MD_DRIFT_BAR, f'15b: conserved drift {drift}')
    check(drift_control > MD_DRIFT_BAR,
          f'15b: the 2 fs control passes the drift bar: {drift_control}')
    check(peaks[10] == peaks[MD_NHC_STEPS], f'15b: peak memory {peaks}')
    check(all(launches.get(k, 0) > 0 for k in
              ('pair_fwd', 'pair_fwd_first', 'pair_bwd', 'pair_bwd_first')),
          f'15b: K1/K2 not launched on the MD path: {launches}')
    check(traj_diff <= MD_TRAJ_BAR, f'15b: card vs CPU {traj_diff}')
    sysm = padded_batch(torch, aspirin_systems())
    md = load_model(CKPT)
    rate, where = syncs_per_step(torch, md_step_fn(torch, md, *sysm))
    md_emit('md_syncs', path='15b dense pallas aspirin (K1/K2), 8 replicas',
         syncs_per_step=rate, where=where)
    return launches


def lj_md_start():
    """Phase 15c's start (and the JAX run's, tests/test_torch_md_driver.py
    lj-newton3): lj_box's MD_LJ['atoms']-atom frame with Maxwell-Boltzmann
    momenta at MD_LJ['temperature'] (default_rng(0)). -> (numbers,
    positions, cell, momenta), float64 numpy."""
    import numpy as np
    from newtonnet_tpu_torch.md.system import System, maxwell_boltzmann
    z, pos, cell, _, _ = lj_box(MD_LJ['atoms'])
    s = System(z[0], pos[0], cell=cell[0], pbc=[True] * 3)
    maxwell_boltzmann(s, MD_LJ['temperature'], rng=np.random.default_rng(0))
    return s.numbers, s.positions, s.cell, s.momenta


def held_list(torch, model, numbers, pos, cell, skin=MD_LJ['skin']):
    """One frame on the card as md/driver holds it between rebuilds, for
    md_step_fn: (z, masses, cell, pos, nlist), the list built as the
    driver builds it for the model's layout (on the host for newton3 and
    the staircase, whose order the frame takes; on the device
    otherwise)."""
    import numpy as np
    from newtonnet_tpu_torch.md import driver
    z, p, c = (torch.from_numpy(np.asarray(a)[None]).cuda()
               for a in (numbers, pos.astype(np.float32),
                         cell.astype(np.float32)))
    z = z.long()
    if model.newton3_compact:
        nlist, perm = driver.host_staircase_nlist(model, z, p, c, skin, {})
        perm = torch.from_numpy(perm).cuda()
        z = torch.take_along_dim(z, perm, dim=1)
        p = torch.take_along_dim(p, perm[..., None], dim=1)
    elif model.newton3 or model.inverse_lists:
        nlist = driver.host_symmetric_nlist(model, z, p, c, skin=skin)
    else:
        grid, cap = driver._grid_for(model, c.cpu().numpy(), z.shape[1], 2,
                                     skin)
        nlist = driver._make_nlist_builder(model, z, c, skin, grid, cap)(p)[0]
    return z, torch.ones_like(p[..., 0]), c, p, nlist


def phase_md_lj(torch, fk, rg):
    """Phase 15c: LJ_CKPT's MD_LJ run in three layouts (newton3 over host
    rebuilds, K9/K12; newton3_compact over the staircase with its
    re-sorts; a kernel='pallas' K-list model, K5/K6, over on-device
    rebuilds) against the JAX package's newton3 run (MD_LJ_REF) at
    MD_LJ_BAR, both counters 0. -> {layout: launches per step}."""
    import numpy as np
    from newtonnet_tpu_torch import NewtonNet, load_model
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.md import System
    from newtonnet_tpu_torch.md.driver import run_langevin_on_device
    ref = dict(np.load(MD_LJ_REF))
    numbers, pos, cell, mom = lj_md_start()
    base = load_model(LJ_CKPT)
    layouts = {'newton3': {},
               'staircase': dict(newton3=False, newton3_compact=True),
               'klist_pallas': dict(LJ_PALLAS, k_max=MD_LJ_K_MAX)}
    per_step = {}
    for name, change in layouts.items():
        model = NewtonNet(**dict(base.config_dict(), **change),
                          device='cuda')
        model.load_state_dict(base.state_dict())
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        rg.reset_launch_counts()
        t0 = time.perf_counter()
        s, log = run_langevin_on_device(
            model, None, System(numbers, pos, cell=cell, momenta=mom),
            timestep=MD_LJ['timestep_fs'] * units.fs,
            temperature_K=MD_LJ['temperature'], friction=0.0,
            n_steps=MD_LJ['steps'], log_every=1,
            nlist_every=MD_LJ['nlist_every'], skin=MD_LJ['skin'])
        seconds = time.perf_counter() - t0
        counts = {**{k: v for k, v in fk.LAUNCHES.items() if v},
                  **{k: v for k, v in rg.LAUNCHES.items() if v}}
        per_step[name] = {k: v / (MD_LJ['steps'] + 1)
                          for k, v in counts.items()}
        pos_diff = float(np.abs(s.positions
                                - ref['JAX_MD_LJ_NEWTON3_POS']).max())
        epot_diff = float(np.abs(log['epot']
                                 - ref['JAX_MD_LJ_NEWTON3_EPOT']).max())
        rate, where = syncs_per_step(torch, md_step_fn(
            torch, model, *held_list(torch, model, numbers, pos, cell)))
        md_emit('md_lj', layout=name, atoms=MD_LJ['atoms'], md=MD_LJ,
             vs_jax_newton3=dict(positions=pos_diff, epot=epot_diff,
                                 bar=MD_LJ_BAR),
             counters=[log['nlist_overflow'], log['skin_violations']],
             launches_per_step=per_step[name], seconds=seconds,
             syncs_per_step=rate, syncs_where=where)
        check(pos_diff <= MD_LJ_BAR and epot_diff <= MD_LJ_BAR,
              f'15c {name}: against the JAX run {pos_diff}, {epot_diff}')
        check(log['nlist_overflow'] == 0 and log['skin_violations'] == 0,
              f'15c {name}: counters')
        want = (('klist_fwd', 'klist_fwd_first', 'klist_bwd',
                 'klist_bwd_first') if name == 'klist_pallas' else
                ('row_gather', 'row_gather_b1'))
        check(all(counts.get(k, 0) > 0 for k in want),
              f'15c {name}: {want} not launched: {counts}')
    return per_step


def device_busy(torch, fn):
    """One call of fn under torch.profiler, device activity only (a
    10-step staircase chunk launches about 40,000 kernels; with the host's
    operators as well the trace takes minutes to read): wall ms (host
    clock, ending in a synchronise), device busy ms and share, K9's ms and
    the three longest kernel families."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    dev = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()]
    busy = sum(ms for _, ms, _ in dev)
    top = sorted(dev, key=lambda d: -d[1])[:3]
    return {'wall_ms': wall, 'device_busy_ms': busy,
            'device_busy_share': busy / wall,
            'k9_ms': sum(ms for k, ms, _ in dev if 'row_gather_kernel' in k),
            'kernels': sum(n for _, _, n in dev),
            'top_device_ms': [[k[:60], ms, n] for k, ms, n in top]}


def md_box_system():
    """tools/demo_large_md.py's box (numpy RandomState(0): positions, then
    numbers from {1, 1, 8}; momenta at 300 K from default_rng(0)): the
    System of phases 15d and 18d."""
    import numpy as np
    from newtonnet_tpu_torch.md import System, maxwell_boltzmann
    rs = np.random.RandomState(0)
    L = (MD_BOX_ATOMS / 0.1) ** (1 / 3)
    cell = np.diag([L, L, L])
    pos = rs.rand(MD_BOX_ATOMS, 3) @ cell
    numbers = rs.choice([1, 1, 8], size=MD_BOX_ATOMS)
    system = System(numbers, pos, cell=cell, pbc=[True] * 3)
    maxwell_boltzmann(system, 300.0, rng=np.random.default_rng(0))
    return system


def md_box(torch, xcfg, mode):
    """Phase 15d's model and System: md_box_system and the checkpoint's
    widths over half lists (mode 'newton3' or 'newton3c', the staircase)
    at MD_BOX_K_MAX, bf16 stack, box_weights scaled by 0.1."""
    system = md_box_system()
    model = box_model(torch, xcfg, 'bfloat16', ['energy', 'gradient_force'],
                      k_max=MD_BOX_K_MAX, newton3=mode == 'newton3',
                      newton3_compact=mode == 'newton3c')
    with torch.no_grad():
        for p in model.core.parameters():
            p.mul_(0.1)
    return model, system


def phase_md_box(torch, rg, xcfg):
    """Phase 15d: MD_BOX_STEPS Langevin steps of md_box in both half-list
    modes (host rebuilds every MD_BOX_EVERY): steps/s, the host rebuild's
    ms, the device's busy share over one chunk (torch.profiler), K9/K12
    launches per step and host syncs per step; both counters 0, the state
    finite. -> {mode: launches per step}."""
    import numpy as np
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.md import driver
    per_step = {}
    for mode in ('newton3c', 'newton3'):
        model, system = md_box(torch, xcfg, mode)
        plan = {}
        kw = dict(timestep=0.5 * units.fs, temperature_K=300.0,
                  friction=1 / (100 * units.fs), nlist_every=MD_BOX_EVERY,
                  stair_plan=plan)
        system, _ = driver.run_langevin_on_device(
            model, None, system, n_steps=MD_BOX_EVERY, log_every=1, **kw)
        torch.cuda.synchronize()
        rg.reset_launch_counts()
        t0 = time.perf_counter()
        system, log = driver.run_langevin_on_device(
            model, None, system, n_steps=MD_BOX_STEPS, log_every=10, **kw)
        seconds = time.perf_counter() - t0
        per_step[mode] = {k: v / (MD_BOX_STEPS + 1)
                          for k, v in rg.LAUNCHES.items() if v}
        z = system.numbers[None]
        p, c = system.positions[None], system.cell[None]
        rebuild_ms = []
        for _ in range(3):
            t = time.perf_counter()
            if mode == 'newton3c':
                driver.host_staircase_nlist(model, z, p, c, 1.0, dict(plan))
            else:
                driver.host_symmetric_nlist(model, z, p, c, skin=1.0)
            torch.cuda.synchronize()
            rebuild_ms.append(1e3 * (time.perf_counter() - t))
        prof = device_busy(torch, lambda: driver.run_langevin_on_device(
            model, None, system, n_steps=MD_BOX_EVERY, log_every=1, **kw))
        rate, where = syncs_per_step(torch, md_step_fn(
            torch, model, *held_list(torch, model, system.numbers,
                                     system.positions, system.cell)),
            steps=5)
        md_emit('md_box', mode=mode, atoms=MD_BOX_ATOMS, k_max=MD_BOX_K_MAX,
             steps=MD_BOX_STEPS, nlist_every=MD_BOX_EVERY, seconds=seconds,
             steps_per_s=MD_BOX_STEPS / seconds,
             host_rebuild_ms_median=statistics.median(rebuild_ms),
             chunk_profile=dict(steps=MD_BOX_EVERY, **prof),
             k9_k12_launches_per_step=per_step[mode],
             syncs_per_step=rate, syncs_where=where,
             counters=[log['nlist_overflow'], log['skin_violations']])
        check(np.isfinite(log['epot']).all()
              and np.isfinite(system.positions).all(), f'15d {mode} finite')
        check(log['nlist_overflow'] == 0 and log['skin_violations'] == 0,
              f'15d {mode}: counters')
        check(per_step[mode].get('row_gather', 0) > 0
              and per_step[mode].get('row_gather_b1', 0) > 0,
              f'15d {mode}: K9/K12 not launched')
        del model
        torch.cuda.empty_cache()
    return per_step


def phase_md(torch, fd, fk, rg, xcfg):
    """Phase 15 (15a-15d) with its own wall time. 15a runs in a process of
    its own (md_aspirin_main) beside 15b and 15c: its 6000 steps wait on
    the host's launches far more than on the card, so the two overlap;
    15d's timings run alone after both. -> {path: launches per step}."""
    import tempfile
    t15 = time.perf_counter()
    out, err = tempfile.TemporaryFile('w+'), tempfile.TemporaryFile('w+')
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              'md-aspirin'], cwd=ROOT, stdout=out,
                             stderr=err, text=True)
    marks = {}
    try:
        launches = {'nhc_dense_aspirin': phase_md_pallas(torch, fd)}
        marks['15b'] = time.perf_counter()
        launches.update({f'lj_{k}': v
                         for k, v in phase_md_lj(torch, fk, rg).items()})
        marks['15c'] = time.perf_counter()
        child.wait(timeout=900)
        marks['15a'] = time.perf_counter()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out.seek(0)
    err.seek(0)
    sys.stdout.write(out.read())
    sys.stdout.flush()
    check(child.returncode == 0, f'15a failed: {err.read()[-3000:]}')
    launches.update({f'box_{k}': v
                     for k, v in phase_md_box(torch, rg, xcfg).items()})
    torch.cuda.empty_cache()
    marks['15d'] = time.perf_counter()
    ends = {k: v - t15 for k, v in marks.items()}
    md_emit('md_phase', seconds=time.perf_counter() - t15,
         seconds_at_end_of=ends, launches_per_step=launches)
    return launches


# --------------------------------------------------------------------- #
# 16. export: artifacts captured here, replayed in a fresh process
EXPORT_BATCH = 100
EXPORT_REQUESTS = 20
# the XLA checkpoint's newton3 variant (half-list capacity: aspirin's 21
# atoms have at most 20 neighbours in range) and its plain-list variant
EXPORT_N3_K_MAX = 24
EXPORT_PLAIN_K_MAX = 48
EXPORT_BOX = 30.0  # the periodic cell of 16c's aspirin requests (A)
# 16c: the float32 bars of phase 8's newton3 requests (against_fp32_box): 1e-5
# of the energy, 1e-4 of the largest force (and stress component)
EXPORT_E_REL, EXPORT_F_REL = 1e-5, 1e-4
REPLAY_TIMEOUT = 300
# 16b's A/B of the plain-list transpose's overflow path (ROADMAP.md C17):
# the K-list artifact against one exported with the path taken out (the
# pad before the repair), replayed alternately (a, b, b, a, ...)
EXPORT_AB_ROUNDS = 20


def pad_atoms(np, arrays, n_pad):
    """z (..., N) and pos (..., N, 3) zero-padded to n_pad atoms."""
    z, pos = arrays
    extra = n_pad - z.shape[-1]
    zp = np.pad(z, [(0, 0)] * (z.ndim - 1) + [(0, extra)])
    pp = np.pad(pos, [(0, 0)] * (pos.ndim - 2) + [(0, extra), (0, 0)])
    return zp, pp


def export_to(path, model, **kw):
    """export_inference + save_serving_artifact of `model` (its own
    weights) -> what the header says and the export's time and size."""
    from newtonnet_tpu_torch.utils.export import export_inference, \
        save_serving_artifact
    t = time.perf_counter()
    header, blob = export_inference(model, None, **kw)
    save_serving_artifact(path, header, blob)
    return {'export_s': time.perf_counter() - t,
            'bytes': os.path.getsize(path), 'n_pad': header['n_pad'],
            'batch': header['batch_size'],
            'properties': header['properties']}


def replay_main(plan_path):
    """`python3 chip_smoke.py replay PLAN`: the fresh process of phase 16.
    Imports the port's export module and op modules only, replays each
    job's artifact on its inputs (one warm-up call, then one call per
    input batch, timed to a synchronize), counts the kernels' launches per
    call and the host syncs per call over three (syncs_per_step) and the
    peak of the card's memory above what was allocated before a call,
    times single-system requests through ServedModel.__call__, checks the
    refusal of a request with more atoms than the artifact holds, times
    the plan's A/B pairs of artifacts on their first input batch, called
    alternately, then profiles one call of each (device_busy) and counts
    the operator calls of its program, and writes the outputs and a
    report."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    from newtonnet_tpu_torch.ops import row_gather as rg
    from newtonnet_tpu_torch.utils.export import ServedModel
    # a caller's TF32 setting, which the replay must not take
    torch.backends.cuda.matmul.allow_tf32 = True
    with open(plan_path) as f:
        plan = json.load(f)
    report, kept = {}, {}

    def timed_call(served, z, pos, cell):
        # -> (outputs, seconds, peak bytes above the allocation before)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = served.call_raw(z, pos, cell)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t,
                torch.cuda.max_memory_allocated() - base)

    ab_names = {n for pair in plan.get('ab', []) for n in pair}
    for job in plan['jobs']:
        t = time.perf_counter()
        served = ServedModel(job['artifact'])
        load_s = time.perf_counter() - t
        with np.load(job['inputs']) as f:
            z, pos, cell = (torch.from_numpy(f[k]).cuda()
                            for k in ('z', 'pos', 'cell'))
        t = time.perf_counter()
        served.call_raw(z[0], pos[0], cell[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        for mod in (fd, fk, rg):
            mod.reset_launch_counts()
        outs, call_s, peak = [], [], 0
        for c in range(z.shape[0]):
            out, dt, pk = timed_call(served, z[c], pos[c], cell[c])
            call_s.append(dt)
            peak = max(peak, pk)
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        launches = {k: v / z.shape[0] for mod in (fd, fk, rg)
                    for k, v in mod.LAUNCHES.items() if v}
        syncs, sync_at = syncs_per_step(
            torch, lambda: served.call_raw(z[0], pos[0], cell[0]), steps=3)
        request_s = []
        if job.get('requests'):
            with np.load(job['requests']) as f:
                reqs = {k: f[k] for k in f.files}
            for k in range(len(reqs['numbers'])):
                t = time.perf_counter()
                served(reqs['numbers'][k], reqs['positions'][k])
                request_s.append(time.perf_counter() - t)
        try:
            served(np.ones(served.n_pad + 1, np.int64),
                   np.zeros((served.n_pad + 1, 3), np.float32))
            too_many = 'served'
        except ValueError as exc:
            too_many = str(exc)
        np.savez(job['out'], **{k: np.stack([o[k] for o in outs])
                                for k in served.properties})
        report[job['name']] = {
            'load_s': load_s, 'first_call_s': first_s,
            'call_ms': [1e3 * s for s in call_s],
            'launches_per_call': launches, 'syncs_per_call': syncs,
            'sync_at': sync_at, 'request_ms': [1e3 * s for s in request_s],
            'call_peak_bytes': peak, 'too_many_atoms': too_many}
        if job['name'] in ab_names:
            kept[job['name']] = (served, z[0], pos[0], cell[0])
    for a, b in plan.get('ab', []):
        ms = {a: [], b: []}
        peaks = {a: 0, b: 0}
        for r in range(EXPORT_AB_ROUNDS):
            for name in ((a, b) if r % 2 == 0 else (b, a)):
                _, dt, pk = timed_call(*kept[name])
                ms[name].append(1e3 * dt)
                peaks[name] = max(peaks[name], pk)
        # one more call of each under the profiler: how much of the call
        # the card is busy, and with how many kernels
        busy = {name: device_busy(torch, lambda s=kept[name]: s[0].call_raw(
            *s[1:])) for name in (a, b)}
        report[f'ab_{a}_{b}'] = {
            name: {'call_ms_median': statistics.median(ms[name]),
                   'call_ms': ms[name], 'call_peak_bytes': peaks[name],
                   'profiled': busy[name],
                   'graph_calls': sum(
                       n.op == 'call_function'
                       for n in kept[name][0]._program.graph.nodes)}
            for name in (a, b)}
    report['modules'] = sorted(
        m for m in sys.modules
        if m.startswith('newtonnet_tpu_torch.models')
        or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'newtonnet_tpu'))
    report['matmul_allow_tf32_after'] = \
        torch.backends.cuda.matmul.allow_tf32
    with open(plan['report'], 'w') as f:
        json.dump(report, f)
    return 0


def replay(jobs, tmp, ab=()):
    """Run replay_main in a fresh process over `jobs` (and the A/B pairs
    of job names `ab`) -> its report."""
    plan = os.path.join(tmp, 'plan.json')
    report = os.path.join(tmp, 'report.json')
    with open(plan, 'w') as f:
        json.dump({'jobs': jobs, 'report': report, 'ab': list(ab)}, f)
    t = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          'replay', plan], capture_output=True, text=True,
                         timeout=REPLAY_TIMEOUT)
    check(out.returncode == 0, f'16: the replay process failed:\n'
          f'{out.stdout[-3000:]}\n{out.stderr[-3000:]}')
    with open(report) as f:
        rep = json.load(f)
    rep['process_s'] = time.perf_counter() - t
    return rep


def max_diff(np, a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def phase_export(torch, fd, fk, rg, batches, samples, to_dev):
    """Phase 16: serving artifacts (utils/export.py) captured here and
    replayed in a fresh process (replay_main) that imports no model
    module.
    a. the aspirin kernel='pallas' checkpoint dense at n_atoms 21 (n_pad
       24), batch 100, energy and forces: the 500 test frames within phase
       4's MAE bars, against the eager batches (21 atoms) at E_ATOL /
       F_ATOL, K1/K2 launches per call equal to the eager batch's; and at
       batch 1, 20 requests timed beside the eager calculator's;
    b. the same checkpoint over K-lists (K5/K6) at the same bars;
    c. the kernel='xla' checkpoint as a newton3 model and the LJ newton3
       checkpoint, exported through the plain list (K9/K12), periodic
       requests against the eager newton3 calculator at 1e-5 of the
       energy and 1e-4 of the largest force and stress component; no host
       sync in a replayed call;
    d. the XLA checkpoint's Hessian over the plain list (4 frames) against
       the eager calculator's and the JAX package's at phase 14a's bar,
       K9 launches counted;
    refusals: a JAX package artifact, a request with more atoms than the
    artifact holds. The plain-list transpose's overflow path (ROADMAP.md
    C17): its transient bytes per call of each list artifact, from the
    shapes its calls were traced at, and the K-list artifact against one
    exported without it (the pad before the repair), replayed alternately:
    the same bits, its ms and peak memory per call. -> K1/K2, K5/K6, K9/K12
    launches per replayed call."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.ops import nlist as tnl
    from newtonnet_tpu_torch.utils.export import JAX_FORMAT, ServedModel
    t16 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    jobs, exports, overflow = [], {}, {}
    traced_overflow = tnl._overflow_rows

    def add_job(name, model, inputs, requests=None, **kw):
        path = os.path.join(tmp, f'{name}.npz')
        calls = overflow.setdefault(name, [])

        def recorded(rows, idx, mask, n_nodes, D):
            # the path's tensors of one call (freed after it): the sorted
            # rows behind a zero row and their float64 prefix; per slot
            # the order, the sorted keys and the rank, and behind a zero
            # slot the order and the mask kept; per node the bounds, the
            # two read positions, the two prefix reads and their
            # difference (float64)
            B, S, F = rows.shape
            calls.append(B * (S + 1) * F * (rows.element_size() + 8)
                         + B * S * 3 * 8 + B * (S + 1) * (8 + 1)
                         + B * (n_nodes + 1) * 8 + B * 2 * n_nodes * 8
                         + B * 3 * n_nodes * F * 8)
            return traced_overflow(rows, idx, mask, n_nodes, D)
        tnl._overflow_rows = recorded
        try:
            exports[name] = export_to(path, model, **kw)
        finally:
            tnl._overflow_rows = traced_overflow
        np.savez(os.path.join(tmp, f'{name}_in.npz'), **inputs)
        job = {'name': name, 'artifact': path,
               'inputs': os.path.join(tmp, f'{name}_in.npz'),
               'out': os.path.join(tmp, f'{name}_out.npz')}
        if requests is not None:
            job['requests'] = os.path.join(tmp, f'{name}_req.npz')
            np.savez(job['requests'], **requests)
        jobs.append(job)

    # 16a. + 16b. the pallas checkpoint, dense and over K-lists
    base = load_model(CKPT)
    kl = klist_model(torch, base)
    n_pad = 24
    zs, ps = pad_atoms(np, (np.stack([b['z'] for b in batches]),
                            np.stack([b['pos'] for b in batches])), n_pad)
    asp_in = {'z': zs.astype(np.int64), 'pos': ps,
              'cell': np.stack([b['cell'] for b in batches])}
    add_job('dense', base, asp_in, n_atoms=21, batch_size=EXPORT_BATCH)
    add_job('klist', kl, asp_in, n_atoms=21, batch_size=EXPORT_BATCH)
    # the control of 16b's A/B: the overflow path taken out (exact zeros
    # in its place, as the pad before the repair dropped the slots)
    tnl._overflow_rows = lambda rows, idx, mask, n_nodes, D: rows.new_zeros(
        (rows.shape[0], n_nodes, rows.shape[2]), dtype=torch.float64)
    try:
        path = os.path.join(tmp, 'klist_old_pad.npz')
        exports['klist_old_pad'] = export_to(
            path, kl, n_atoms=21, batch_size=EXPORT_BATCH)
    finally:
        tnl._overflow_rows = traced_overflow
    jobs.append(dict(jobs[-1], name='klist_old_pad', artifact=path,
                     out=os.path.join(tmp, 'klist_old_pad_out.npz')))
    reqs = samples[:EXPORT_REQUESTS]
    z1, p1 = pad_atoms(np, (np.stack([s['z'] for s in reqs]),
                            np.stack([s['pos'] for s in reqs])), n_pad)
    add_job('dense_b1', base, {'z': z1[:, None].astype(np.int64),
                               'pos': p1[:, None].astype(np.float32),
                               'cell': np.zeros((len(reqs), 1, 3, 3),
                                                np.float32)},
            requests={'numbers': np.stack([s['z'] for s in reqs]),
                      'positions': np.stack([s['pos'] for s in reqs])},
            n_atoms=21, batch_size=1)
    eager = {}
    for name, model, mod in (('dense', base, fd), ('klist', kl, fk)):
        model(*to_dev(batches[0]))
        torch.cuda.synchronize()
        mod.reset_launch_counts()
        outs, batch_s = [], []
        for b in batches:
            t = time.perf_counter()
            out = model(*to_dev(b))
            outs.append((out['energy'].cpu().numpy(),
                         out['gradient_force'].cpu().numpy()))
            batch_s.append(time.perf_counter() - t)
        eager[name] = (outs, batch_s, {k: v / len(batches) for k, v in
                                       mod.LAUNCHES.items() if v})
    calc = NewtonNetCalculator(CKPT)
    calc.calculate(numbers=reqs[0]['z'], positions=reqs[0]['pos'])
    calc_s = []
    for s in reqs:
        t = time.perf_counter()
        calc.calculate(numbers=s['z'], positions=s['pos'])
        calc_s.append(time.perf_counter() - t)
    del calc

    # 16c. the XLA checkpoint (newton3 variant) and the LJ checkpoint over
    # the plain list; periodic requests
    outs3 = ['energy', 'gradient_force', 'stress']
    xbase = load_model(XLA_CKPT)
    n3 = xla_model(torch, xbase, graph_mode='neighborlist', newton3=True,
                   k_max=EXPORT_N3_K_MAX, output_properties=outs3)
    hreq = samples[:HESSIAN_FRAMES]
    zc, pc = pad_atoms(np, (np.stack([s['z'] for s in hreq]),
                            np.stack([s['pos'] for s in hreq])), n_pad)
    box = EXPORT_BOX * np.eye(3, dtype=np.float32)
    add_job('xla_newton3', n3, {
        'z': zc[:, None].astype(np.int64), 'pos': pc[:, None],
        'cell': np.broadcast_to(box, (len(hreq), 1, 3, 3)).copy()},
        n_atoms=21, batch_size=1)
    lj = load_model(LJ_CKPT)
    lj3 = xla_model(torch, lj, output_properties=outs3)
    lz, lpos, lcell, _, _ = lj_box()
    add_job('lj_newton3', lj3, {'z': lz[:, None].astype(np.int64),
                                'pos': lpos[:, None].astype(np.float32),
                                'cell': lcell[:, None].astype(np.float32)},
            n_atoms=lz.shape[1], batch_size=1)
    # 16d. the Hessian over the plain list
    hm = xla_model(torch, xbase, graph_mode='neighborlist',
                   k_max=EXPORT_PLAIN_K_MAX, hessian_block=0,
                   output_properties=['energy', 'gradient_force',
                                      'hessian'])
    add_job('hessian', hm, {'z': zc[None].astype(np.int64),
                            'pos': pc[None],
                            'cell': np.zeros((1, len(hreq), 3, 3),
                                             np.float32)},
            n_atoms=21, batch_size=len(hreq))
    export_s = time.perf_counter() - t16
    del hm, n3, lj3
    torch.cuda.empty_cache()

    rep = replay(jobs, tmp, ab=[('klist', 'klist_old_pad')])

    def result(name):
        with np.load(os.path.join(tmp, f'{name}_out.npz')) as f:
            return {k: f[k] for k in f.files}

    fields = {}
    for name in ('dense', 'klist'):
        got = result(name)
        outs, batch_s, eager_launches = eager[name]
        e_rep, f_rep = got['energy'], got['gradient_force'][:, :, :21]
        ae = sum(np.abs(e_rep[c] - b['energy']).astype(np.float64).sum()
                 for c, b in enumerate(batches))
        af = sum(np.abs(f_rep[c] - b['force']).astype(np.float64).sum()
                 for c, b in enumerate(batches))
        e_mae, f_mae = ae / 500, af / (500 * 21 * 3)
        e_diff = max(max_diff(np, e_rep[c], e) for c, (e, _) in
                     enumerate(outs))
        f_diff = max(max_diff(np, f_rep[c], f) for c, (_, f) in
                     enumerate(outs))
        r = rep[name]
        kernel_keys = [k for k in eager_launches if k.startswith(
            ('pair_', 'klist_'))]
        fields[name] = dict(
            energy_mae=e_mae, force_mae=f_mae,
            energy_max_abs_diff_vs_eager=e_diff,
            force_max_abs_diff_vs_eager=f_diff,
            diffs_are_zero=e_diff == 0.0 and f_diff == 0.0,
            replay_launches_per_call=r['launches_per_call'],
            eager_launches_per_batch=eager_launches,
            replay_call_ms_median=statistics.median(r['call_ms']),
            eager_batch_ms_median=1e3 * statistics.median(batch_s),
            syncs_per_call=r['syncs_per_call'], sync_at=r['sync_at'],
            **exports[name])
        check(abs(e_mae - JAX_ENERGY_MAE) <= 5e-4,
              f'16 {name}: replayed energy MAE {e_mae}')
        check(abs(f_mae - JAX_FORCE_MAE) <= 5e-5,
              f'16 {name}: replayed force MAE {f_mae}')
        check(e_diff <= E_ATOL and f_diff <= F_ATOL,
              f'16 {name}: replay vs eager {e_diff} {f_diff}')
        check(kernel_keys and all(
            r['launches_per_call'].get(k) == eager_launches[k]
            for k in kernel_keys),
            f'16 {name}: replayed launches {r["launches_per_call"]} vs '
            f'eager {eager_launches}')
    # C17: the overflow path adds exact zeros where no atom overflows
    old_pad = result('klist_old_pad')
    same_bits = all(np.array_equal(v, old_pad[k])
                    for k, v in result('klist').items())
    ab = rep['ab_klist_klist_old_pad']
    fields['overflow_path'] = dict(
        card=card_name(),
        transient_bytes_per_call={k: max(v) for k, v in overflow.items()
                                  if v},
        traced_calls={k: len(v) for k, v in overflow.items()},
        klist_vs_old_pad_same_bits=same_bits,
        klist_call_ms_median=ab['klist']['call_ms_median'],
        old_pad_call_ms_median=ab['klist_old_pad']['call_ms_median'],
        klist_call_peak_bytes=ab['klist']['call_peak_bytes'],
        old_pad_call_peak_bytes=ab['klist_old_pad']['call_peak_bytes'],
        klist_profiled=ab['klist']['profiled'],
        old_pad_profiled=ab['klist_old_pad']['profiled'],
        klist_graph_calls=ab['klist']['graph_calls'],
        old_pad_graph_calls=ab['klist_old_pad']['graph_calls'],
        call_peak_bytes={j['name']: rep[j['name']]['call_peak_bytes']
                         for j in jobs},
        old_pad_launches_per_call=rep['klist_old_pad'][
            'launches_per_call'])
    check(same_bits, '16b: the overflow path moved the K-list replay')
    check(all(overflow[k] for k in ('klist', 'xla_newton3', 'lj_newton3',
                                    'hessian')),
          f'16: a list artifact traced no overflow path: '
          f'{fields["overflow_path"]["traced_calls"]}')
    r = rep['dense_b1']
    fields['latency'] = dict(
        card=card_name(),
        batch_1_replay_request_ms_median=statistics.median(
            r['request_ms']),
        batch_1_eager_calculator_ms_median=1e3 * statistics.median(
            calc_s),
        batch_100_replay_call_ms_median=fields['dense'][
            'replay_call_ms_median'],
        batch_100_eager_ms_median=fields['dense']['eager_batch_ms_median'])

    # 16c against the eager newton3 calculators
    n3_calc = box_calculator(torch, xla_model(
        torch, xbase, graph_mode='neighborlist', newton3=True,
        k_max=EXPORT_N3_K_MAX, output_properties=outs3))
    lj_calc = NewtonNetCalculator(LJ_CKPT, properties=['energy', 'forces',
                                                       'stress'])
    voigt = ([0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1])
    # the eager plain list the artifacts were captured over: the fixed
    # degree of the capture against the largest degree read on the host
    plain = {'xla_newton3': xla_model(
        torch, xbase, graph_mode='neighborlist', k_max=2 * EXPORT_N3_K_MAX
        + 8, output_properties=outs3),
        'lj_newton3': xla_model(torch, lj, newton3=False, k_max=2 * lj.k_max
                                + 8, output_properties=outs3)}
    plain_in = {'xla_newton3': (zc, pc, np.broadcast_to(
        box, (len(hreq), 3, 3))), 'lj_newton3': (lz, lpos, lcell)}
    for name, calc, frames in (
            ('xla_newton3', n3_calc,
             [(s['z'], s['pos'], box) for s in hreq]),
            ('lj_newton3', lj_calc, [(lz[0], lpos[0], lcell[0])])):
        got = result(name)
        vs_plain = {k: 0.0 for k in outs3}
        for c, frame in enumerate(zip(*plain_in[name])):
            t = [torch.as_tensor(np.asarray(a)[None]).cuda()
                 for a in frame]
            out = plain[name](t[0].long(), t[1].float(), t[2].float())
            for k in outs3:
                vs_plain[k] = max(vs_plain[k], max_diff(
                    np, got[k][c, 0], out[k][0].cpu().numpy()))
        frame_diffs, frame_bars = [], []
        for c, (zz, pp, cc) in enumerate(frames):
            want = calc.calculate(numbers=zz, positions=pp, cell=cc)
            n = len(zz)
            diffs = {
                'energy': abs(float(got['energy'][c, 0]) - want['energy']),
                'forces': max_diff(np, got['gradient_force'][c, 0, :n],
                                   want['forces']),
                'stress': max_diff(np, got['stress'][c, 0][voigt],
                                   want['stress'])}
            bars = {'energy': EXPORT_E_REL * abs(want['energy']),
                    'forces': EXPORT_F_REL * float(np.abs(
                        want['forces']).max()),
                    'stress': EXPORT_F_REL * float(np.abs(
                        want['stress']).max())}
            frame_diffs.append(diffs)
            frame_bars.append(bars)
            for k in diffs:
                check(diffs[k] <= bars[k],
                      f'16c {name} frame {c} {k}: {diffs[k]} > {bars[k]}')
        r = rep[name]
        fields[name] = dict(
            diffs=frame_diffs, bars=frame_bars,
            vs_eager_plain_list=vs_plain,
            bitwise_vs_eager_plain_list=not any(vs_plain.values()),
            replay_launches_per_call=r[
                'launches_per_call'], syncs_per_call=r['syncs_per_call'],
            replay_call_ms_median=statistics.median(r['call_ms']),
            **exports[name])
        check(r['launches_per_call'].get('row_gather', 0) > 0,
              f'16c {name}: K9 was not launched in the replay')
        check(r['launches_per_call'].get('row_gather_b1', 0) > 0,
              f'16c {name}: K12 (B = 1) was not launched in the replay')
        check(r['syncs_per_call'] == 0,
              f'16c {name}: {r["syncs_per_call"]} host syncs per call')
    del n3_calc, lj_calc, plain

    # 16d against the eager calculator and the JAX package
    ref = dict(np.load(HESSIAN_REF))
    bar = hessian_bar(ref)
    hcalc = NewtonNetCalculator(XLA_CKPT, properties=HESSIAN_PROPS)
    eager_h = np.stack([hcalc.calculate(numbers=s['z'], positions=s['pos'])
                        ['hessian'] for s in hreq])
    del hcalc
    got_h = result('hessian')['hessian'][0][:, :21, :, :21, :]
    h_eager = max_diff(np, got_h, eager_h)
    h_jax = max_diff(np, got_h, ref['JAX_ASPIRIN_HESSIAN'])
    r = rep['hessian']
    fields['hessian'] = dict(
        vs_eager=(h_eager, bar), vs_jax=(h_jax, bar),
        replay_launches_per_call=r['launches_per_call'],
        syncs_per_call=r['syncs_per_call'],
        replay_call_ms=r['call_ms'], **exports['hessian'])
    check(h_eager <= bar and h_jax <= bar,
          f'16d Hessian: {h_eager} / {h_jax} > {bar}')
    check(r['launches_per_call'].get('row_gather', 0) > 0,
          '16d: K9 was not launched in the Hessian replay')

    # refusals: a JAX package artifact, more atoms than the artifact holds
    jax_art = os.path.join(tmp, 'jax_format.npz')
    np.savez(jax_art, header=np.asarray(json.dumps(
        {'format': JAX_FORMAT, 'version': 1})),
        blob=np.zeros(8, np.uint8))
    try:
        ServedModel(jax_art)
        jax_refusal = None
    except ValueError as exc:
        jax_refusal = str(exc)
    too_many = rep['dense']['too_many_atoms']
    emit('export', seconds=time.perf_counter() - t16, export_s=export_s,
         replay_process_s=rep['process_s'],
         replay_load_s={j['name']: rep[j['name']]['load_s'] for j in jobs},
         replay_first_call_s={j['name']: rep[j['name']]['first_call_s']
                              for j in jobs},
         replay_modules=rep['modules'],
         replay_tf32_left_on=rep['matmul_allow_tf32_after'],
         jax_artifact_refusal=jax_refusal, too_many_atoms=too_many,
         **fields)
    check(rep['modules'] == [], f'16: the replay imported {rep["modules"]}')
    check(jax_refusal is not None and 'newtonnet-tpu-serving' in
          jax_refusal and 'newtonnet-tpu-torch-serving' in jax_refusal,
          f'16: a JAX artifact was not refused by name: {jax_refusal}')
    check('exported capacity' in too_many,
          f'16: a request with too many atoms: {too_many}')
    tmp_dir.cleanup()
    return {name: rep[name]['launches_per_call']
            for name in ('dense', 'klist', 'dense_b1', 'xla_newton3',
                         'lj_newton3', 'hessian')}


def export_main():
    """`python3 chip_smoke.py export`: phase 16 alone (the build of its
    libraries, the aspirin frames, the phase)."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np  # noqa: F401
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    from newtonnet_tpu_torch.ops import row_gather as rg
    emit('env', device=torch.cuda.get_device_name(0), nvidia_smi=card_name(),
         torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    _build.build_all(names=('fused_dense', 'fused_klist', 'row_gather'),
                     widths=(128,))
    emit('build', seconds=time.perf_counter() - t)
    samples = parse_xyz(XYZ)
    batches = [collate(samples[k:k + 100], n_pad=21)
               for k in range(0, 500, 100)]

    def to_dev(b):
        return [torch.from_numpy(b[k]).cuda() for k in ('z', 'pos', 'cell')]
    emit('export_launches', **phase_export(torch, fd, fk, rg, batches,
                                           samples, to_dev))
    return 0


# --------------------------------------------------------------------- #
# 17. parallel: data-parallel fine-tuning and graph-parallel dense serving,
# each rank a process on this card (parallel/launch.py, gloo)
PAR_STEPS = 10
PAR_CLI_DATA = dict(train_size=100, val_size=50, test_size=100,
                    train_batch_size=10, val_batch_size=50,
                    test_batch_size=100)
# the aperiodic cluster of 17b: CLUSTER_ATOMS atoms on a jittered cubic
# lattice of CLUSTER_SPACING A (H, C, O), big enough that the one-process
# dense request peaks above CLUSTER_PEAK_GIB
CLUSTER_ATOMS, CLUSTER_SPACING, CLUSTER_PEAK_GIB = 1728, 1.6, 20.0
CLUSTER_E_REL, CLUSTER_F_REL = 1e-5, 1e-4
# 17a's gradient bars: the bf16 duals (dense, K3/K4) and the fp32 K-list
# duals (K7/K8); steps 2-10 losses
PAR_GRAD_BAR = {'dense': DUAL_BF16_BAR, 'klist': 1e-4}
PAR_LOSS_BAR = 1e-3
# 17a's optimizers, each with the global-norm clip 1.0. 'sgd', SGD with
# momentum, whose update is linear in the gradient (the optimizer of the
# port's parity tests): steps 2-10 are held to the one-process run on whole
# batches at PAR_LOSS_BAR, and the CLI epoch runs it. 'adam', the CLI's
# (scripts/config_md17_pallas.yml): Adam's first steps (m / sqrt(v)) turn
# a sum-order difference in a near-zero gradient component into an update
# of the learning rate, and one float32 ulp of every energy moves this loss
# by 1.3e-3, so the same function summed in another order drifts past
# PAR_LOSS_BAR; its ranks are held bit for bit to their own arithmetic in
# one process (par_halves) at every step and to the whole batch at step 1,
# and both drifts from the whole batch (the ranks' and the one-process
# halves', with no collective) are reported.
PAR_OPTIMIZERS = {'sgd': ('sgd', dict(lr=1e-3, momentum=0.9)),
                  'adam': ('adam', dict(lr=1e-3))}
# 17a's runs: (layout, optimizer) -> the key of its results
PAR_RUNS = {(layout, opt): layout if opt == 'sgd' else f'{layout}_{opt}'
            for layout in ('dense', 'klist') for opt in PAR_OPTIMIZERS}
PAR_LOG_REL = 1e-5
PAR_TIMING_COLUMNS = ('epoch_seconds', 'steps_per_s', 'edges_per_s')
PAR_TIMEOUT = 600


def cluster_frame(np, seed):
    """(z, pos, cell) of one aperiodic cluster: CLUSTER_ATOMS atoms on the
    first sites of a jittered cubic lattice, numbers drawn from H, C, O."""
    rs = np.random.RandomState(seed)
    side = int(np.ceil(CLUSTER_ATOMS ** (1 / 3)))
    sites = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing='ij'),
                     -1).reshape(-1, 3)[:CLUSTER_ATOMS]
    pos = (sites + rs.uniform(-0.2, 0.2, sites.shape)) * CLUSTER_SPACING
    z = rs.choice([1, 6, 8], size=CLUSTER_ATOMS)
    return (z[None].astype(np.int64), pos[None].astype(np.float32),
            np.zeros((1, 3, 3), np.float32))


def cluster_model(torch, seed=0):
    """The XLA checkpoint's widths (F=128, 3 interactions, dense) with
    box_weights: the trained weights are not finite far from aspirin's
    geometries (ROADMAP.md C3)."""
    from newtonnet_tpu_torch import NewtonNet, load_model
    cfg = load_model(XLA_CKPT).config_dict()
    model = NewtonNet(**cfg, device='cuda')
    box_weights(torch, model.core, seed)
    return model.requires_grad_(False).eval()


def par_settings(output, parallel=None):
    """Phase 7c's CLI settings at PAR_CLI_DATA's sizes with
    PAR_OPTIMIZERS['sgd'], one epoch, with training.parallel."""
    cfg = md17_settings(output, 1)
    cfg['data'].update(PAR_CLI_DATA)
    name, kw = PAR_OPTIMIZERS['sgd']
    cfg['training']['optimizer'] = {name: dict(kw)}
    if parallel:
        cfg['training']['parallel'] = parallel
    return cfg


def par_trainer(torch, stats, cfg, mesh=None, opt='sgd', **changes):
    """The fine-tuning start of phase 7a (7d with changes) in a Trainer
    with PAR_OPTIMIZERS[opt]."""
    from newtonnet_tpu_torch import NewtonNet, Trainer, load_model
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    base = load_model(CKPT)
    model = NewtonNet(**dict(base.config_dict(), **changes), device='cuda')
    model.load_state_dict(base.state_dict())
    set_scalers(model.core, model.output_properties, stats,
                {'energy': dict(cfg['training']['fit_scalers'])})
    name, kw = PAR_OPTIMIZERS[opt]
    return Trainer(model, loss_fns=get_loss_by_string(
        cfg['training']['loss']), optimizer=get_optimizer_by_string(
            name, model.core, clip_grad=1.0, **kw), mesh=mesh)


def par_batches():
    """The PAR_STEPS global batches (B=10) of phase 7a's seeded loader,
    and the data statistics."""
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    cfg = md17_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    it = iter(train_gen)
    return [next(it) for _ in range(PAR_STEPS)], stats, cfg


def par_gradient(torch, t, batch):
    """Trainer t's global loss and flat parameter gradient for a numpy
    batch, nothing stepped: this rank's rows, its loss and gradient, both
    summed over the data group as train_step sums the gradient."""
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.parallel import collectives
    with fp32_matmuls():
        loss, _ = t.loss_and_grad(t._to_device(t._shard(batch)))
        t.reduce_gradients()
    return (collectives.all_reduce_sum(loss, t._data_group()),
            torch.cat([p.grad.reshape(-1) for p in t.model.core.parameters()
                       if p.grad is not None]))


def par_steps(torch, fd, fdd, fk, mesh, layout, opt='sgd'):
    """17a on this process's rank(s): with 'sgd', step 1's global loss and
    gradient (and, with a mesh, this rank's gradient without the
    all-reduce, the control); then PAR_STEPS steps with PAR_OPTIMIZERS[opt]
    from the same start: losses, step ms, launches, collectives and (with
    'sgd') host syncs per step."""
    from newtonnet_tpu_torch.parallel import collectives
    batches, stats, cfg = par_batches()
    changes = {'graph_mode': 'neighborlist'} if layout == 'klist' else {}
    group = None if mesh is None else mesh.group('data')
    out = {}
    if opt == 'sgd':
        t = par_trainer(torch, stats, cfg, mesh, **changes)
        loss1, grad1 = par_gradient(torch, t, batches[0])
        out.update(loss1=float(loss1), grad1=grad1.cpu().numpy())
        if group is not None:
            t.loss_and_grad(t._to_device(t._shard(batches[0])))
            out['grad1_no_allreduce'] = torch.cat(
                [p.grad.reshape(-1) for p in t.model.core.parameters()
                 if p.grad is not None]).cpu().numpy()
    t = par_trainer(torch, stats, cfg, mesh, opt, **changes)
    torch.cuda.synchronize()
    reset_counts(fd, fdd, fk)
    collectives.reset_stats()
    partial, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        partial.append(t.train_step(b)['loss'].double())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = lj_counts(fd, fdd, fk)
    stats = dict(collectives.STATS)  # the steps' own, not the check's
    losses = collectives.all_reduce_sum(torch.stack(partial), group)
    out.update(
        losses=losses.tolist(), step_ms=[1e3 * s for s in step_s],
        steps_per_s=1.0 / statistics.median(step_s[1:]),
        launches_per_step={k: v / PAR_STEPS for k, v in counts.items()
                           if v},
        collective_ms_per_step=1e3 * stats['seconds'] / PAR_STEPS,
        collectives_per_step=stats['calls'] / PAR_STEPS)
    if opt == 'sgd':
        out['syncs_per_step'], out['sync_sites'] = syncs_per_step(
            torch, lambda: t.train_step(batches[1]), steps=3)
    return out



def par_halves(torch, fd, fdd, fk, layout, opt='sgd'):
    """The two ranks' arithmetic in this process: each global batch's two
    halves (global_data_batch's rows and counts of data index 0 and 1),
    their gradients summed in fp32 as the all-reduce sums them, then
    PAR_OPTIMIZERS[opt]: -> step 1's gradient and the PAR_STEPS losses.
    Against the one-process run on whole batches this is the same function
    summed in another order, with no collective."""
    import numpy as np
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.parallel.distributed import global_data_batch
    from newtonnet_tpu_torch.parallel.mesh import Mesh
    batches, stats, cfg = par_batches()
    changes = {'graph_mode': 'neighborlist'} if layout == 'klist' else {}
    t = par_trainer(torch, stats, cfg, None, opt, **changes)
    params = list(t.model.core.parameters())
    halves = [Mesh(np.arange(2)[:, None], {'data': None, 'graph': None}, d)
              for d in range(2)]
    losses, grad1 = [], None
    for b in batches:
        total, acc = 0.0, None
        with fp32_matmuls():
            for mesh in halves:
                loss, _ = t.loss_and_grad(
                    t._to_device(global_data_batch(mesh, b)))
                total = total + loss.double()
                g = [None if p.grad is None else p.grad.clone()
                     for p in params]
                acc = g if acc is None else [
                    None if a is None else a + x for a, x in zip(acc, g)]
            for p, a in zip(params, acc):
                p.grad = a
            if grad1 is None:
                grad1 = torch.cat([a.reshape(-1) for a in acc
                                   if a is not None]).cpu().numpy()
            t.optimizer.step()
        losses.append(float(total))
    return grad1, losses

def par_aspirin(torch, fn, to_dev, batches):
    """The 500 aspirin test frames through fn (batches of 100): -> (energy
    MAE, force MAE, ms per batch)."""
    import numpy as np
    ae = af = 0.0
    ms = []
    for b in batches:
        z, pos, cell = to_dev(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e, f = fn(z, pos, cell)
        e, f = e.cpu().numpy(), f.cpu().numpy()[:, :21]
        ms.append(1e3 * (time.perf_counter() - t0))
        ae += np.abs(e - b['energy']).astype(np.float64).sum()
        af += np.abs(f - b['force']).astype(np.float64).sum()
    return ae / 500, af / (500 * 21 * 3), ms


def par_cluster(torch, fn, frames):
    """One request of the clusters `frames` (stacked) through fn: ->
    (energies, forces, peak GiB of this process, ms of a second call)."""
    import numpy as np
    z, pos, cell = (torch.from_numpy(np.concatenate(a)).cuda()
                    for a in zip(*frames))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e, f = fn(z, pos, cell)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    fn(z, pos, cell)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return e.cpu().numpy(), f.cpu().numpy(), peak, ms


def parallel_rank_main(work, what):
    """`python3 chip_smoke.py parallel-rank WORK {dp|gp}`: one rank of
    phase 17, started by parallel/launch.py; writes WORK/<what>_rank<r>.npz
    (and the chief's results as JSON)."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_dual as fdd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    from newtonnet_tpu_torch.parallel import collectives, distributed
    from newtonnet_tpu_torch.parallel.graph_parallel import (
        make_sharded_energy_force_fn,
        pad_atoms_to_multiple,
    )
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    from newtonnet_tpu_torch.train.cli import train_from_settings
    check(distributed.maybe_initialize_from_env('cuda'),
          'rank started without NEWTONNET_DIST_* variables')
    rank, size = distributed.world()
    res, arrays = {'rank': rank, 'world': size,
                   'backend': distributed.backend(),
                   'describe': distributed.describe(
                       torch.device('cuda', torch.cuda.current_device()))}, {}

    def sharded(model, mesh):
        fn = make_sharded_energy_force_fn(model, mesh)

        def call(z, pos, cell):
            zp, posp = pad_atoms_to_multiple(z, pos, mesh.shape['graph'])
            return fn(zp, posp, cell)
        return call

    if what == 'dp':
        mesh = make_mesh(data=2)
        for (layout, opt), key in PAR_RUNS.items():
            got = par_steps(torch, fd, fdd, fk, mesh, layout, opt)
            for k in ('grad1', 'grad1_no_allreduce'):
                if k in got:
                    arrays[f'{key}_{k}'] = got.pop(k)
            res[key] = got
        # one CLI epoch, data 2 (the chief writes into WORK/cli_mp)
        collectives.reset_stats()
        t0 = time.perf_counter()
        train_from_settings(par_settings(os.path.join(work, 'cli_mp'),
                                         {'data': 2}))
        res['cli_seconds'] = time.perf_counter() - t0
        res['cli_collectives'] = dict(collectives.STATS)
        # 17b at (1, 2): the aspirin frames, then the cluster
        mesh = make_mesh(data=1, graph=2)
        samples = parse_xyz(XYZ)
        batches = [collate(samples[k:k + 100], n_pad=21)
                   for k in range(0, 500, 100)]

        def to_dev(b):
            return [torch.from_numpy(b[k]).cuda()
                    for k in ('z', 'pos', 'cell')]
        collectives.reset_stats()
        e_mae, f_mae, ms = par_aspirin(
            torch, sharded(load_model(XLA_CKPT), mesh), to_dev, batches)
        res['aspirin'] = dict(energy_mae=e_mae, force_mae=f_mae,
                              batch_ms=ms, collectives=dict(
                                  collectives.STATS))
        frames = [cluster_frame(np, 0)]
    else:
        mesh = make_mesh(data=2, graph=2)
        frames = [cluster_frame(np, 0), cluster_frame(np, 1)]
    collectives.reset_stats()
    e, f, peak, ms = par_cluster(torch, sharded(cluster_model(torch), mesh),
                                 frames)
    arrays['cluster_energy'], arrays['cluster_forces'] = e, f
    res['cluster'] = dict(mesh=mesh.shape, peak_gib=peak, request_ms=ms,
                          collectives=dict(collectives.STATS))
    np.savez(os.path.join(work, f'{what}_rank{rank}.npz'), **arrays)
    with open(os.path.join(work, f'{what}_rank{rank}.json'), 'w') as fh:
        json.dump(res, fh)
    return 0


def launch_ranks(work, what, nprocs, mode='parallel-rank', phase='17',
                 timeout=PAR_TIMEOUT):
    """Run `nprocs` ranks of `python3 chip_smoke.py mode WORK what`
    (parallel_rank_main, or halo_rank_main for mode 'halo-rank') through
    parallel/launch.py; a failed rank fails the phase (with its log's
    tail)."""
    logs = os.path.join(work, f'logs_{what}')
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, '-m', 'newtonnet_tpu_torch.parallel.launch',
         '--nprocs', str(nprocs), '--log-dir', logs, '--timeout',
         str(timeout), '--', sys.executable, os.path.abspath(__file__),
         mode, work, what], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout + 60)
    tails = ''
    for r in range(nprocs):
        path = os.path.join(logs, f'proc_{r}.log')
        if os.path.exists(path):
            with open(path) as fh:
                tails += f'--- rank {r} ---\n' + fh.read()[-2500:]
    check(run.returncode == 0,
          f'{phase} {what}: a rank failed ({run.returncode}): '
          f'{run.stderr}{tails}')
    import numpy as np
    return ([json.load(open(os.path.join(work, f'{what}_rank{r}.json')))
             for r in range(nprocs)],
            [dict(np.load(os.path.join(work, f'{what}_rank{r}.npz')))
             for r in range(nprocs)], time.perf_counter() - t0)


def par_log(path):
    import csv
    with open(os.path.join(path, 'log.csv')) as fh:
        return list(csv.DictReader(fh))


def phase_parallel(torch, fd, fdd, fk):
    """Phase 17 (see the module docstring): the one-process references in
    this process, then two launches of ranks on this card. -> {'dense':
    {kernel: launches per rank per step}, 'klist': ...}."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.train.cli import train_from_settings
    t17 = time.perf_counter()
    card = card_name()
    work = tempfile.mkdtemp(prefix='phase17_')
    # one process: 17a's steps, the CLI epoch, 17b's requests
    one = {key: par_steps(torch, fd, fdd, fk, None, layout, opt)
           for (layout, opt), key in PAR_RUNS.items()}
    batches, stats, cfg = par_batches()
    b0 = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    main_loss = par_trainer(torch, stats, cfg).main_loss
    start = par_trainer(torch, stats, cfg).model
    loss64, ulp_term = float64_loss(fd, main_loss, b0, start)
    bar1 = ulp_term / loss64
    del start
    train_from_settings(par_settings(os.path.join(work, 'cli_sp')))
    samples = parse_xyz(XYZ)
    asp = [collate(samples[k:k + 100], n_pad=21) for k in range(0, 500, 100)]
    xla = load_model(XLA_CKPT)

    def whole(z, pos, cell):
        out = xla(z, pos, cell)
        return out['energy'], out['gradient_force']

    def to_dev(b):
        return [torch.from_numpy(b[k]).cuda() for k in ('z', 'pos', 'cell')]
    e_mae1, f_mae1, asp_ms1 = par_aspirin(torch, whole, to_dev, asp)
    del xla
    model = cluster_model(torch)

    def request(z, pos, cell):
        out = model(z, pos, cell)
        return out['energy'], out['gradient_force']
    clusters = [cluster_frame(np, 0), cluster_frame(np, 1)]
    ref = [par_cluster(torch, request, [c]) for c in clusters]
    del model
    torch.cuda.empty_cache()
    # the ranks: 17a and 17b at (1, 2), then 17b at (2, 2)
    dp, dp_arr, dp_s = launch_ranks(work, 'dp', 2)
    gp, gp_arr, gp_s = launch_ranks(work, 'gp', 4)

    # 17a: the steps against the one-process run on whole batches (step 1,
    # and with SGD every step) and on the ranks' halves (every step, bit
    # for bit), and the control
    halves = {key: par_halves(torch, fd, fdd, fk, layout, opt)
              for (layout, opt), key in PAR_RUNS.items()}

    def rel_to(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def rel_steps(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    rows, fails = {}, []
    for (layout, opt), key in PAR_RUNS.items():
        o = one[key]
        h_grad1, h_losses = halves[key]
        bar = PAR_GRAD_BAR[layout]
        need = DENSE_FP32 if layout == 'dense' else KLIST_NAMES
        for r, (res, arr) in enumerate(zip(dp, dp_arr)):
            got = res[key]
            rel1 = abs(got['losses'][0] - o['losses'][0]) / abs(
                o['losses'][0])
            whole = rel_steps(got['losses'], o['losses'])
            row = dict(optimizer=opt, loss1_rel=rel1, loss1_bar=bar1,
                       steps_rel_vs_halves=rel_steps(got['losses'],
                                                     h_losses),
                       steps_rel_vs_whole=whole,
                       halves_vs_whole=rel_steps(h_losses, o['losses']))
            checks = [
                (rel1 <= bar1, f'{key} rank {r}: step 1 loss'),
                (got['losses'] == h_losses,
                 f'{key} rank {r}: steps not bit for bit the halves'),
                (all(got['launches_per_step'].get(k, 0) > 0 for k in need),
                 f'{key} rank {r}: a kernel was not launched: '
                 f'{got["launches_per_step"]}')]
            if opt == 'sgd':
                g1 = rel_to(arr[f'{key}_grad1'], o['grad1'])
                ctl = rel_to(arr[f'{key}_grad1_no_allreduce'], o['grad1'])
                g1h = rel_to(arr[f'{key}_grad1'], h_grad1)
                row.update(grad1_rel_norm=g1, grad1_bar=bar,
                           control_no_allreduce_rel_norm=ctl,
                           grad1_rel_norm_vs_halves=g1h,
                           steps_bar=PAR_LOSS_BAR)
                checks += [
                    (g1 <= bar, f'{key} rank {r}: step 1 gradient'),
                    (g1h == 0.0,
                     f'{key} rank {r}: step 1 gradient vs the halves'),
                    (ctl > bar, f'{key} rank {r}: the control without the '
                     'all-reduce passed the gradient bar'),
                    (max(whole[1:]) <= PAR_LOSS_BAR,
                     f'{key} rank {r}: steps 2-10')]
            rows[f'{key}_rank{r}'] = row
            fails += [what for ok, what in checks if not ok]
    emit('parallel_steps', card=card, backend=dp[0]['backend'],
         describe=[r['describe'] for r in dp], checks=rows,
         one_process={k: {x: v[x] for x in (
             'steps_per_s', 'step_ms', 'launches_per_step',
             'syncs_per_step') if x in v} for k, v in one.items()},
         ranks={f'{key}_rank{r}': {x: res[key][x] for x in (
             'steps_per_s', 'step_ms', 'launches_per_step',
             'collective_ms_per_step', 'collectives_per_step',
             'syncs_per_step', 'sync_sites') if x in res[key]}
             for key in PAR_RUNS.values()
             for r, res in enumerate(dp)})
    check(not fails, f'17a: {fails}')
    # the CLI epoch, data 2 against data 1
    mp_dirs = sorted(os.listdir(os.path.join(work, 'cli_mp')))
    check(mp_dirs == ['training_1'], f'17a CLI run directories {mp_dirs}')
    mp = par_log(os.path.join(work, 'cli_mp', 'training_1'))
    sp = par_log(os.path.join(work, 'cli_sp', 'training_1'))
    check([r['epoch'] for r in mp] == [r['epoch'] for r in sp],
          f'17a CLI rows {[r["epoch"] for r in mp]}')
    worst, same = 0.0, []
    for a, b in zip(mp, sp):
        for key, value in b.items():
            if key in PAR_TIMING_COLUMNS or key == 'epoch':
                continue
            try:
                worst = max(worst, abs(float(a[key]) - float(value))
                            / max(abs(float(value)), 1e-30))
            except ValueError:  # best_model
                same.append(a[key] == value)
    emit('parallel_cli', card=card, rows=[r['epoch'] for r in mp],
         worst_rel=worst, bar=PAR_LOG_REL, flags_equal=all(same),
         seconds_2_ranks=dp[0]['cli_seconds'],
         collectives_2_ranks=dp[0]['cli_collectives'],
         epoch_seconds={'1': sp[0]['epoch_seconds'],
                        '2': mp[0]['epoch_seconds']})
    check(all(same), '17a CLI best_model flags')
    check(worst <= PAR_LOG_REL, f'17a CLI log.csv {worst}')
    # 17b: the aspirin frames at (1, 2)
    a = dp[0]['aspirin']
    emit('parallel_aspirin', card=card, mesh={'data': 1, 'graph': 2},
         energy_mae=a['energy_mae'], force_mae=a['force_mae'],
         one_process=[e_mae1, f_mae1],
         jax=[JAX_XLA_ENERGY_MAE, JAX_XLA_FORCE_MAE],
         batch_ms=a['batch_ms'], one_process_batch_ms=asp_ms1,
         collectives=a['collectives'])
    check(abs(a['energy_mae'] - JAX_XLA_ENERGY_MAE) <= 5e-4,
          f'17b energy MAE {a["energy_mae"]}')
    check(abs(a['force_mae'] - JAX_XLA_FORCE_MAE) <= 5e-5,
          f'17b force MAE {a["force_mae"]}')
    # 17b: the cluster at (1, 2) and (2, 2)
    e_ref = np.concatenate([r[0] for r in ref])
    f_ref = np.concatenate([r[1] for r in ref])
    peak1 = min(r[2] for r in ref)
    out = {}
    for what, ranks, arrs in (('1x2', dp, dp_arr), ('2x2', gp, gp_arr)):
        n = len(arrs[0]['cluster_energy'])
        e_rel = max(float(np.abs(arr['cluster_energy'] - e_ref[:n]).max()
                          / np.abs(e_ref[:n]).max()) for arr in arrs)
        f_rel = max(float(np.abs(arr['cluster_forces'] - f_ref[:n]).max()
                          / np.abs(f_ref[:n]).max()) for arr in arrs)
        out[what] = dict(energy_rel=e_rel, force_rel=f_rel,
                         peak_gib_per_rank=[r['cluster']['peak_gib']
                                            for r in ranks],
                         request_ms=[r['cluster']['request_ms']
                                     for r in ranks],
                         collectives=[r['cluster']['collectives']
                                      for r in ranks])
    emit('parallel_cluster', card=card, atoms=CLUSTER_ATOMS,
         one_process_peak_gib=[r[2] for r in ref],
         one_process_request_ms=[r[3] for r in ref],
         bars=[CLUSTER_E_REL, CLUSTER_F_REL], **out)
    for what, o in out.items():
        check(np.isfinite(o['energy_rel']) and np.isfinite(o['force_rel'])
              and o['energy_rel'] <= CLUSTER_E_REL
              and o['force_rel'] <= CLUSTER_F_REL,
              f'17b {what}: energy {o["energy_rel"]}, forces '
              f'{o["force_rel"]}')
    check(peak1 > CLUSTER_PEAK_GIB,
          f'17b one-process cluster peak {peak1} GiB')
    emit('parallel_phase', card=card, seconds=time.perf_counter() - t17,
         launch_seconds={'dp': dp_s, 'gp': gp_s},
         gap='ranks share one card: gloo through host memory; NCCL, '
             'NVLink and scaling across cards are not exercised, and no '
             'time here is a scaling result')
    shutil.rmtree(work, ignore_errors=True)
    return {layout: dp[0][layout]['launches_per_step']
            for layout in ('dense', 'klist')}


def parallel_main():
    """`python3 chip_smoke.py parallel`: phase 17 alone (the build of its
    libraries at the checkpoints' width, then the phase)."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_dual as fdd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    emit('env', device=torch.cuda.get_device_name(0), nvidia_smi=card_name(),
         torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    _build.build_all(names=('fused_dense', 'fused_dual', 'fused_klist',
                            'row_gather'), widths=(128,))
    emit('build', seconds=time.perf_counter() - t)
    emit('parallel_launches', **phase_parallel(torch, fd, fdd, fk))
    return 0


# 18. halo: halo-exchange graph parallelism (parallel/halo.py) on the large
# periodic box, ranks as processes on this card (gloo through host memory,
# as phase 17's). n_halo from check_halo_capacity on the seeded boxes
# (numpy): at cutoff 5 A the 4096-atom box needs 614 at (1, 2) and 644 at
# (1, 4) (frames of seeds 0-3 at most 649), at cutoff + skin = 6 A (MD) 744
# and 746 (md_box's positions); 16,384 atoms at (1, 4) need 1570, 8192
# atoms 992.
HALO_N, HALO_MD_N = 704, 768
HALO_BIG_ATOMS, HALO_BIG_N = 16384, 1600
HALO_SMALL_ATOMS, HALO_SMALL_N = 8192, 1024
# the same float32 function with its sums in another order (the slabs'
# energies added over the ranks, each node's slots summed on its rank then
# with the neighbours' returned halo cotangents): phase 17b's bars, and
# the stress at the forces' bar
HALO_E_REL, HALO_F_REL, HALO_S_REL = 1e-5, 1e-4, 1e-4
# 18c: step 1's loss (its energy term dominates: 1e-5 is 170 float32
# ulps of it), its gradient (relative norm, phase 17a's K-list bar), and
# steps 2-3 and the CLI epoch's log.csv under the CLI's Adam, whose m/sqrt(v)
# turns the sums' order into parameter steps of lr (phase 17: 3.3e-3 by
# step 10 on aspirin; 1e-3 here, after 2 or 3 steps)
HALO_LOSS_REL, HALO_GRAD_REL, HALO_STEPS_REL, HALO_CLI_REL = \
    1e-5, 1e-4, 1e-3, 1e-3
HALO_STEPS = 3
HALO_LOSSES = {'ef': {'energy': {'weight': 1.0, 'mode': 'mse'},
                      'gradient_force': {'weight': 50.0, 'mode': 'mse'}},
               'stress': {'energy': {'weight': 1.0, 'mode': 'mse'},
                          'gradient_force': {'weight': 50.0, 'mode': 'mse'},
                          'stress': {'weight': 100.0, 'mode': 'mse'}}}
# 18d: float32 state on the ranks against the host loop's float64 numpy
# state (float32 forces both): a position stored in float32 at 35 A moves
# by up to 4e-6 A per step, about 2e-5 A over 20 steps, which moves the
# energy by about sqrt(N) * |F| * 2e-5: bars 1e-3 A and 1e-5 eV per atom
HALO_MD_STEPS, HALO_MD_EVERY = 20, 10
HALO_MD_POS_ATOL, HALO_MD_EPOT_PER_ATOM = 1e-3, 1e-5
HALO_MD_UNDERSIZED = 64
HALO_REPS = 5
HALO_CLI_SEEDS = (0, 1, 2, 3)
HALO_TIMEOUT = 900


def halo_box_model(torch, xcfg, outputs=('energy', 'gradient_force'),
                   charge=False, scale=1.0):
    """The large box's model (box_model: the XLA checkpoint's widths over
    plain lists at k_max BOX_K_MAX, float32, box_weights) with `outputs`;
    charge: charge_head_tree's head and ewald_mode 'periodic'; scale:
    the weights times it (md_box's 0.1)."""
    model = box_model(torch, xcfg, '', list(outputs))
    if charge:
        model = with_charge_head(torch, model, ['charge'] + list(outputs),
                                 ewald_mode='periodic')
    if scale != 1.0:
        with torch.no_grad():
            for p in model.core.parameters():
                p.mul_(scale)
    return model


def halo_frame(np, n_atoms, n_shards, seed=0):
    """box_system's frame sorted along x for n_shards slabs (spatial_sort),
    with box_stress's label: a batch dict of numpy arrays."""
    from newtonnet_tpu_torch.parallel.halo import spatial_sort
    z, pos, cell, energy, force = box_system(n_atoms, seed)
    z, pos, extra = spatial_sort(z, pos, cell, extra={'force': force},
                                 n_shards=n_shards)
    return {'z': z.astype(np.int64), 'pos': pos, 'cell': cell,
            'energy': energy, 'force': extra['force'],
            'stress': box_stress(seed), 'graph_mask': np.ones(1, bool)}


def write_box_dataset(root):
    """box_system's frames of HALO_CLI_SEEDS as root/raw/box.extxyz
    (positions and forces to 8 decimals, an energy label from numpy)."""
    import numpy as np
    os.makedirs(os.path.join(root, 'raw'), exist_ok=True)
    names = {1: 'H', 8: 'O'}
    with open(os.path.join(root, 'raw', 'box.extxyz'), 'w') as f:
        for seed in HALO_CLI_SEEDS:
            z, pos, cell, _, force = box_system(BOX_ATOMS, seed)
            L = cell[0, 0, 0]
            energy = float(np.random.RandomState(100 + seed).randn()) * 10.0
            f.write(f'{BOX_ATOMS}\nLattice="{L} 0 0 0 {L} 0 0 0 {L}" '
                    f'Properties=species:S:1:pos:R:3:forces:R:3 '
                    f'energy={energy:.10f} pbc="T T T"\n')
            for a, p, fo in zip(z[0], pos[0], force[0]):
                f.write(f'{names[int(a)]} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} '
                        f'{fo[0]:.8f} {fo[1]:.8f} {fo[2]:.8f}\n')
    return root


def halo_cli_settings(output, root, halo):
    """One CLI epoch on write_box_dataset's frames (2 / 1 / 1, batch 1,
    spatially sorted) with the box's widths, the CLI's Adam; halo: at
    (data, graph) = (1, 2) with n_halo HALO_N."""
    from newtonnet_tpu_torch import load_model
    cfg = load_model(XLA_CKPT).config_dict()
    model = {k: cfg[k] for k in ('cutoff', 'n_features', 'n_basis',
                                 'n_interactions', 'activation')}
    model.update(graph_mode='neighborlist', k_max=BOX_K_MAX,
                 output_properties=['energy', 'gradient_force'])
    settings = {
        'general': {'device': 'cuda', 'output': output,
                    'precision': 'float32', 'seed': 0},
        'data': {'train_root': root, 'test_root': None, 'train_size': 2,
                 'val_size': 1, 'test_size': 1, 'train_batch_size': 1,
                 'val_batch_size': 1, 'test_batch_size': 1,
                 'spatial_sort': True},
        'model': model,
        'training': {'epochs': 1, 'loss': HALO_LOSSES['ef'],
                     'checkpoint': {'check_val': 1, 'check_test': 1,
                                    'check_log': 1}},
    }
    if halo:
        settings['training'].update(parallel={'data': 1, 'graph': 2},
                                    halo={'n_halo': HALO_N})
    return settings


def halo_request(torch, rg, fn, batch, reps=HALO_REPS):
    """fn(z, pos, cell) on batch's tensors: -> (outputs as numpy, K9
    launches per request, ms of `reps` more calls, and collectives.STATS
    over those calls: the exchanges' payloads, and the host-clock seconds
    inside exchanges and collectives, the peers' waits included)."""
    from newtonnet_tpu_torch.parallel import collectives
    z, pos, cell = (torch.from_numpy(batch[k]).cuda()
                    for k in ('z', 'pos', 'cell'))
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    out = fn(z, pos, cell)
    torch.cuda.synchronize()
    launches = rg.LAUNCHES['row_gather']
    collectives.reset_stats()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(z, pos, cell)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return [o.cpu().numpy() for o in out], launches, ms, \
        dict(collectives.STATS)


def one_request(model, compute_stress=False):
    """The one-process request as the halo function's: (energy, forces[,
    stress])."""
    def fn(z, pos, cell):
        out = model(z, pos, cell)
        got = (out['energy'], out['gradient_force'])
        return got + ((out['stress'],) if compute_stress else ())
    return fn


def halo_payload_ok(stats, n_halo):
    """Every exchange sent 2 n_halo rows of its own width."""
    return (stats['halo_calls'] > 0
            and stats['halo_rows_max'] == 2 * n_halo
            and stats['halo_rows'] == 2 * n_halo * stats['halo_calls']
            and stats['halo_bytes'] == 2 * n_halo * stats['halo_row_bytes'])


def halo_steps(torch, rg, model, batch, key, step_fn):
    """HALO_STEPS steps of step_fn(batch) -> loss (with the gradient left
    in the parameters) then the CLI's Adam: step 1's loss and flat
    gradient, every step's loss, ms and K9 launches per step, and the
    collectives per step after step 1 (its first use) with their
    host-clock ms, the peers' waits included."""
    from newtonnet_tpu_torch.parallel import collectives
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    opt = get_optimizer_by_string('adam', model.core)
    losses, ms, grad1 = [], [], None
    rg.reset_launch_counts()
    for step in range(HALO_STEPS):
        if step == 1:
            collectives.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(batch)
        if grad1 is None:
            grad1 = torch.cat([
                (torch.zeros_like(p) if p.grad is None else p.grad)
                .reshape(-1) for p in model.core.parameters()]).cpu().numpy()
        opt.step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    later = HALO_STEPS - 1
    return dict(losses=losses, grad1=grad1, step_ms=ms,
                k9_per_step=rg.LAUNCHES['row_gather'] / HALO_STEPS,
                collectives_per_step=collectives.STATS['calls'] / later,
                collective_ms_per_step=1e3 * collectives.STATS['seconds']
                / later)


def halo_md(torch, rg, mesh, model, n_halo, **kw):
    """run_md_halo of md_box_system: -> (final System, log, ms per step,
    K9 launches per force call)."""
    from newtonnet_tpu_torch.md.halo_md import run_md_halo
    system = md_box_system()
    torch.cuda.synchronize()
    rg.reset_launch_counts()
    t0 = time.perf_counter()
    system, log = run_md_halo(model, None, system, mesh, n_halo, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # each chunk computes its starting forces once more
    calls = kw['n_steps'] + kw['n_steps'] // kw['resort_every']
    return system, log, 1e3 * seconds / kw['n_steps'], \
        rg.LAUNCHES['row_gather'] / calls


def halo_rank_main(work, what):
    """`python3 chip_smoke.py halo-rank WORK {g2|g4}`: one rank of phase
    18, started by parallel/launch.py; writes WORK/<what>_rank<r>.npz and
    .json."""
    import torch
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.ops import row_gather as rg
    from newtonnet_tpu_torch.parallel import distributed
    from newtonnet_tpu_torch.parallel.halo import (
        make_halo_energy_force_fn,
        make_halo_grads_fn,
        shard_halo_batch,
    )
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    from newtonnet_tpu_torch.train.cli import train_from_settings
    check(distributed.maybe_initialize_from_env('cuda'),
          'rank started without NEWTONNET_DIST_* variables')
    rank, size = distributed.world()
    xcfg = load_model(XLA_CKPT).config_dict()
    mesh = make_mesh(data=1, graph=size)
    res, arrays = {'rank': rank, 'world': size,
                   'backend': distributed.backend()}, {}

    def serve(model, batch, n_halo, key, stress=False, reps=HALO_REPS):
        fn = make_halo_energy_force_fn(model, mesh, n_halo,
                                       compute_stress=stress)
        out, k9, ms, stats = halo_request(torch, rg, fn, batch, reps)
        for name, a in zip(('energy', 'forces', 'stress'), out):
            arrays[f'{key}_{name}'] = a
        res[key] = dict(k9_per_request=k9, request_ms=ms,
                        payload_ok=halo_payload_ok(stats, n_halo),
                        stats=stats)

    batch = halo_frame(np, BOX_ATOMS, size)
    serve(halo_box_model(torch, xcfg, ['energy', 'gradient_force',
                                       'stress']),
          batch, HALO_N, 'box', stress=True)
    serve(halo_box_model(torch, xcfg, charge=True), batch, HALO_N,
          'charged')
    if what == 'g4':
        with open(os.path.join(work, 'big.json')) as fh:
            n_atoms, n_halo = json.load(fh)
        big = halo_frame(np, n_atoms, size)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        serve(halo_box_model(torch, xcfg), big, n_halo, 'big', reps=2)
        res['big']['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        res['big']['atoms'], res['big']['n_halo'] = n_atoms, n_halo
    else:
        # 18c: steps on a frame of seed 1, then one CLI epoch
        for key, losses in HALO_LOSSES.items():
            model = halo_box_model(torch, xcfg, list(losses))
            model.requires_grad_(True)
            fn = make_halo_grads_fn(model, mesh, HALO_N, loss_config=losses)
            frame = shard_halo_batch(halo_frame(np, BOX_ATOMS, size, 1),
                                     mesh)
            got = halo_steps(torch, rg, model, frame, key,
                             lambda b: fn(b)['loss'])
            arrays[f'step_{key}_grad1'] = got.pop('grad1')
            res[f'step_{key}'] = got
            del model
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_from_settings(halo_cli_settings(
            os.path.join(work, 'cli_halo'), os.path.join(work, 'box_data'),
            True))
        res['cli_seconds'] = time.perf_counter() - t0
        # 18d: NVE against the host loop, a Langevin chunk, an undersized
        # n_halo
        model = halo_box_model(torch, xcfg, scale=0.1)
        system, log, ms, k9 = halo_md(
            torch, rg, mesh, model, HALO_MD_N, timestep=0.5 * units.fs,
            n_steps=HALO_MD_STEPS, resort_every=HALO_MD_EVERY,
            integrator='nve')
        arrays['md_positions'], arrays['md_epot'] = \
            system.positions, log['epot']
        res['md_nve'] = dict(step_ms=ms, k9_per_force_call=k9,
                             skin_violations=log['skin_violations'],
                             n_resorts=log['n_resorts'])
        _, log, ms, k9 = halo_md(
            torch, rg, mesh, model, HALO_MD_N, timestep=0.5 * units.fs,
            n_steps=HALO_MD_EVERY, resort_every=HALO_MD_EVERY,
            integrator='langevin', temperature_K=300.0,
            friction=1 / (100 * units.fs), seed=1)
        res['md_langevin'] = dict(
            step_ms=ms, k9_per_force_call=k9,
            skin_violations=log['skin_violations'],
            temperature=[float(t) for t in log['temperature']],
            finite=bool(np.isfinite(log['epot']).all()))
        try:
            halo_md(torch, rg, mesh, model, HALO_MD_UNDERSIZED,
                    timestep=0.5 * units.fs, n_steps=HALO_MD_EVERY,
                    resort_every=HALO_MD_EVERY, integrator='nve')
            res['md_undersized'] = ''
        except ValueError as exc:
            res['md_undersized'] = str(exc)
    np.savez(os.path.join(work, f'{what}_rank{rank}.npz'), **arrays)
    with open(os.path.join(work, f'{what}_rank{rank}.json'), 'w') as fh:
        json.dump(res, fh)
    return 0


def rel_max(np, a, b):
    """max|a - b| / max|b|."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_halo(torch, rg):
    """Phase 18 (see the module docstring): the one-process references in
    this process, then two launches of ranks on this card. -> {path: K9
    launches per rank per call}."""
    import tempfile

    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.md.integrators import VelocityVerlet
    from newtonnet_tpu_torch.train.cli import train_from_settings
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    from newtonnet_tpu_torch.utils.params import params_to_flax
    t18 = time.perf_counter()
    card = card_name()
    work = tempfile.mkdtemp(prefix='phase18_')
    write_box_dataset(os.path.join(work, 'box_data'))
    xcfg = load_model(XLA_CKPT).config_dict()
    one, one_arr = {}, {}
    # 18a: the box requests in one process (the graph is the same for any
    # slab count: one sort serves both launches' comparisons)
    batch = halo_frame(np, BOX_ATOMS, 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, k9, ms, _ = halo_request(torch, rg, one_request(halo_box_model(
        torch, xcfg, ['energy', 'gradient_force', 'stress']), True), batch)
    one['box'] = dict(k9_per_request=k9, request_ms=ms,
                      peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    one_arr['box'] = out
    out, k9, ms, _ = halo_request(torch, rg, one_request(
        halo_box_model(torch, xcfg, charge=True)), batch)
    one['charged'] = dict(k9_per_request=k9, request_ms=ms)
    one_arr['charged'] = out
    # 18b: the one-process request at HALO_BIG_ATOMS, its peak memory, and
    # the ranks' memory reckoned from it before they are launched
    big = halo_frame(np, HALO_BIG_ATOMS, 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, k9, ms, _ = halo_request(torch, rg, one_request(
        halo_box_model(torch, xcfg)), big, reps=1)
    peak_big = torch.cuda.max_memory_allocated() / 2 ** 30
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    # a rank holds its slab's rows and the exchanged halo rows of every
    # node tensor, and its own rows' edges: at most (N_loc + 2 H) / N of
    # the one-process request, with a quarter more for its own context
    per_rank = peak_big * (HALO_BIG_ATOMS / 4 + 2 * HALO_BIG_N) \
        / HALO_BIG_ATOMS * 1.25
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2 ** 30
    fits = 4 * per_rank + held + 2.0 < 0.9 * total_gib
    n_big, h_big = ((HALO_BIG_ATOMS, HALO_BIG_N) if fits
                    else (HALO_SMALL_ATOMS, HALO_SMALL_N))
    one['big'] = dict(atoms=HALO_BIG_ATOMS, k9_per_request=k9,
                      request_ms=ms, peak_gib=peak_big,
                      reckoned_gib_per_rank=per_rank, card_gib=total_gib,
                      fits=fits)
    if fits:
        one_arr['big'] = out
    else:
        out, _, _, _ = halo_request(torch, rg, one_request(
            halo_box_model(torch, xcfg)),
            halo_frame(np, HALO_SMALL_ATOMS, 4), reps=1)
        one_arr['big'] = out
    with open(os.path.join(work, 'big.json'), 'w') as fh:
        json.dump([n_big, h_big], fh)
    # 18c: the standard steps and the CLI epoch in one process
    for key, losses in HALO_LOSSES.items():
        model = halo_box_model(torch, xcfg, list(losses))
        model.requires_grad_(True)
        main_loss = get_loss_by_string(losses)[0]
        frame = {k: torch.as_tensor(v).cuda() for k, v in
                 halo_frame(np, BOX_ATOMS, 2, 1).items()}

        def standard(b, model=model, main_loss=main_loss):
            with fp32_matmuls():
                return standard_value_and_grad(model, main_loss, b)[0]
        got = halo_steps(torch, rg, model, frame, key, standard)
        one_arr[f'step_{key}_grad1'] = got.pop('grad1')
        one[f'step_{key}'] = got
        del model, frame
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_from_settings(halo_cli_settings(
        os.path.join(work, 'cli_one'), os.path.join(work, 'box_data'),
        False))
    one['cli_seconds'] = time.perf_counter() - t0
    # 18d: the host loop's velocity Verlet over the calculator
    model = halo_box_model(torch, xcfg, scale=0.1)
    system = md_box_system()
    system.calc = NewtonNetCalculator(
        model=model, params=params_to_flax(model.core),
        properties=['energy', 'forces'])
    epots = []
    md = VelocityVerlet(system, 0.5 * units.fs)
    md.attach(lambda s, t: epots.append(s.get_potential_energy()))
    rg.reset_launch_counts()
    t0 = time.perf_counter()
    md.run(HALO_MD_STEPS)
    # the forces of the start and of each step
    one['md_nve'] = dict(step_ms=1e3 * (time.perf_counter() - t0)
                         / HALO_MD_STEPS,
                         k9_per_force_call=rg.LAUNCHES['row_gather']
                         / (HALO_MD_STEPS + 1))
    one_arr['md_positions'], one_arr['md_epot'] = \
        system.positions.copy(), np.asarray(epots[1:])
    del model, system
    torch.cuda.empty_cache()
    # the ranks: (1, 2), then (1, 4)
    g2, g2_arr, g2_s = launch_ranks(work, 'g2', 2, 'halo-rank', '18',
                                    HALO_TIMEOUT)
    g4, g4_arr, g4_s = launch_ranks(work, 'g4', 4, 'halo-rank', '18',
                                    HALO_TIMEOUT)

    fails = []
    # 18a
    rows = {}
    for mesh, ranks, arrs in (('1x2', g2, g2_arr), ('1x4', g4, g4_arr)):
        for key in ('box', 'charged'):
            ref = one_arr[key]
            for r, (res, arr) in enumerate(zip(ranks, arrs)):
                d = dict(energy_rel=rel_max(np, arr[f'{key}_energy'],
                                            ref[0]),
                         force_rel=rel_max(np, arr[f'{key}_forces'], ref[1]))
                if key == 'box':
                    d['stress_rel'] = rel_max(np, arr['box_stress'], ref[2])
                d.update(k9_per_request=res[key]['k9_per_request'],
                         request_ms_median=statistics.median(
                             res[key]['request_ms']),
                         payload_ok=res[key]['payload_ok'],
                         exchanges=res[key]['stats']['halo_calls']
                         / HALO_REPS,
                         bytes_sent=res[key]['stats']['halo_bytes']
                         / HALO_REPS,
                         collective_ms=1e3 * res[key]['stats']['seconds']
                         / HALO_REPS,
                         collectives=res[key]['stats']['calls']
                         / HALO_REPS)
                rows[f'{key}_{mesh}_rank{r}'] = d
                fails += [w for ok, w in (
                    (d['energy_rel'] <= HALO_E_REL, f'{key} {mesh} energy'),
                    (d['force_rel'] <= HALO_F_REL, f'{key} {mesh} forces'),
                    (d.get('stress_rel', 0.0) <= HALO_S_REL,
                     f'{key} {mesh} stress'),
                    (d['payload_ok'], f'{key} {mesh} payload'),
                    (d['k9_per_request'] > 0, f'{key} {mesh}: K9 not '
                     'launched')) if not ok]
    emit('halo_requests', card=card, atoms=BOX_ATOMS, n_halo=HALO_N,
         bars=[HALO_E_REL, HALO_F_REL, HALO_S_REL], ranks=rows,
         one_process={k: {x: (statistics.median(v) if x == 'request_ms'
                              else v) for x, v in one[k].items()}
                      for k in ('box', 'charged')},
         gap='ranks share one card: gloo through host memory; NCCL, '
             'NVLink and scaling across cards are not exercised')
    check(not fails, f'18a: {fails}')
    # 18b
    n_cmp = len(g4_arr[0]['big_energy'])
    b_rows = {}
    for r, (res, arr) in enumerate(zip(g4, g4_arr)):
        b_rows[f'rank{r}'] = dict(
            energy_rel=rel_max(np, arr['big_energy'], one_arr['big'][0]),
            force_rel=rel_max(np, arr['big_forces'], one_arr['big'][1]),
            peak_gib=res['big']['peak_gib'],
            k9_per_request=res['big']['k9_per_request'],
            request_ms_median=statistics.median(res['big']['request_ms']),
            payload_ok=res['big']['payload_ok'])
    emit('halo_scale', card=card, atoms=n_big, n_halo=h_big,
         one_process=one['big'], ranks=b_rows, frames=n_cmp,
         note=(f'{n_big} atoms' if fits else
               f'{n_big} atoms: four ranks at {HALO_BIG_ATOMS} reckoned '
               f'{4 * per_rank:.1f} GiB'))
    for r, d in b_rows.items():
        check(d['energy_rel'] <= HALO_E_REL and d['force_rel'] <= HALO_F_REL
              and d['payload_ok'] and d['k9_per_request'] > 0,
              f'18b {r}: {d}')
    # 18c
    c_rows = {}
    for key in HALO_LOSSES:
        o = one[f'step_{key}']
        for r, (res, arr) in enumerate(zip(g2, g2_arr)):
            got = res[f'step_{key}']
            loss1 = abs(got['losses'][0] - o['losses'][0]) / abs(
                o['losses'][0])
            g1 = float(np.linalg.norm(arr[f'step_{key}_grad1']
                                      - one_arr[f'step_{key}_grad1'])
                       / np.linalg.norm(one_arr[f'step_{key}_grad1']))
            later = [abs(a - b) / abs(b) for a, b in
                     zip(got['losses'][1:], o['losses'][1:])]
            c_rows[f'{key}_rank{r}'] = dict(
                loss1_rel=loss1, grad1_rel_norm=g1, later_rel=later,
                step_ms=got['step_ms'], one_process_step_ms=o['step_ms'],
                k9_per_step=got['k9_per_step'],
                one_process_k9_per_step=o['k9_per_step'],
                collectives_per_step=got['collectives_per_step'],
                collective_ms_per_step=got['collective_ms_per_step'])
            fails += [w for ok, w in (
                (loss1 <= HALO_LOSS_REL, f'{key} rank {r}: step 1 loss'),
                (g1 <= HALO_GRAD_REL, f'{key} rank {r}: step 1 gradient'),
                (max(later) <= HALO_STEPS_REL, f'{key} rank {r}: steps'),
                (got['k9_per_step'] > 0, f'{key} rank {r}: K9')) if not ok]
    emit('halo_train', card=card, mesh={'data': 1, 'graph': 2},
         bars=[HALO_LOSS_REL, HALO_GRAD_REL, HALO_STEPS_REL], ranks=c_rows)
    check(not fails, f'18c: {fails}')
    mp = par_log(os.path.join(work, 'cli_halo', 'training_1'))
    sp = par_log(os.path.join(work, 'cli_one', 'training_1'))
    check([r['epoch'] for r in mp] == [r['epoch'] for r in sp],
          f'18c CLI rows {[r["epoch"] for r in mp]}')
    worst, same = 0.0, []
    for a, b in zip(mp, sp):
        for key, value in b.items():
            if key in PAR_TIMING_COLUMNS or key == 'epoch' or not value:
                continue
            try:
                worst = max(worst, abs(float(a[key]) - float(value))
                            / max(abs(float(value)), 1e-30))
            except ValueError:  # best_model
                same.append(a[key] == value)
    emit('halo_cli', card=card, rows=[r['epoch'] for r in mp],
         worst_rel=worst, bar=HALO_CLI_REL, flags_equal=all(same),
         seconds={'halo_1x2': g2[0]['cli_seconds'],
                  'one_process': one['cli_seconds']},
         epoch_seconds={'halo_1x2': mp[0]['epoch_seconds'],
                        'one_process': sp[0]['epoch_seconds']})
    check(all(same) and worst <= HALO_CLI_REL, f'18c CLI log.csv {worst}')
    # 18d
    d_rows = {}
    for r, (res, arr) in enumerate(zip(g2, g2_arr)):
        pos_err = float(np.abs(arr['md_positions']
                               - one_arr['md_positions']).max())
        e_err = float(np.abs(arr['md_epot'] - one_arr['md_epot']).max()
                      / MD_BOX_ATOMS)
        d_rows[f'rank{r}'] = dict(
            position_err=pos_err, epot_err_per_atom=e_err,
            nve=res['md_nve'], langevin=res['md_langevin'],
            undersized=res['md_undersized'])
        fails += [w for ok, w in (
            (pos_err <= HALO_MD_POS_ATOL, f'rank {r}: positions'),
            (e_err <= HALO_MD_EPOT_PER_ATOM, f'rank {r}: energies'),
            (res['md_nve']['n_resorts'] == 2, f'rank {r}: resorts'),
            (res['md_langevin']['finite'], f'rank {r}: Langevin'),
            (res['md_nve']['k9_per_force_call'] > 0, f'rank {r}: K9'),
            ('halo partition invalid' in res['md_undersized'],
             f'rank {r}: undersized n_halo ran')) if not ok]
    emit('halo_md', card=card, atoms=MD_BOX_ATOMS, n_halo=HALO_MD_N,
         steps=HALO_MD_STEPS, resort_every=HALO_MD_EVERY,
         bars=[HALO_MD_POS_ATOL, HALO_MD_EPOT_PER_ATOM], ranks=d_rows,
         one_process=one['md_nve'])
    check(not fails, f'18d: {fails}')
    emit('halo_phase', card=card, seconds=time.perf_counter() - t18,
         launch_seconds={'g2': g2_s, 'g4': g4_s},
         gap='ranks share one card: gloo through host memory; NCCL, '
             'NVLink and scaling across cards are not exercised, and no '
             'time here is a scaling result')
    shutil.rmtree(work, ignore_errors=True)
    launches = {}
    for r, res in enumerate(g2):
        launches.update({
            f'request_1x2_rank{r}': res['box']['k9_per_request'],
            f'charged_request_1x2_rank{r}': res['charged']['k9_per_request'],
            f'train_step_ef_1x2_rank{r}': res['step_ef']['k9_per_step'],
            f'train_step_stress_1x2_rank{r}':
                res['step_stress']['k9_per_step'],
            f'md_force_call_1x2_rank{r}':
                res['md_nve']['k9_per_force_call']})
    for r, res in enumerate(g4):
        launches.update({
            f'request_1x4_rank{r}': res['box']['k9_per_request'],
            f'request_{n_big}_1x4_rank{r}': res['big']['k9_per_request']})
    return launches


def halo_main():
    """`python3 chip_smoke.py halo`: phase 18 alone (the build of K9's
    library, then the phase)."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import row_gather as rg
    emit('env', device=torch.cuda.get_device_name(0), nvidia_smi=card_name(),
         torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    _build.load('row_gather')
    emit('build', seconds=time.perf_counter() - t)
    emit('halo_launches', k9_per_rank=phase_halo(torch, rg))
    return 0


def md_aspirin_main():
    """`python3 chip_smoke.py md-aspirin`: phase 15a alone (phase_md runs it
    so, beside 15b and 15c)."""
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_md_aspirin(torch)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, 'newtonnet_tpu_torch')):
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_dual as fdd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    from newtonnet_tpu_torch.ops import row_gather as rg
    from newtonnet_tpu_torch.ops import window as wn
    from newtonnet_tpu_torch.train import fastgrad

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else 'nvidia-smi gave nothing'
    emit('env', device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         bf16_reduced_precision_reduction=(
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction))

    # 2. build: K9-K12's libraries and K1-K8's of every width the script
    # runs (the checkpoints' 128, phase 3's 32 and 64, and phases 9a and
    # 9d's), one library per (padded width, padded), and the bf16 libraries
    # of K1/K2 and K5-K8 at phases 10 and 11's widths
    t0 = time.perf_counter()
    report = _build.build_all(widths=BUILD_WIDTHS, bf16_widths=BF16_WIDTHS)
    ptxas = {}
    for name, (_, log) in report.items():
        entry = None
        ptxas[name] = lib = {}
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                # e.g. ..._15dual_bwd_kernelILi128ELb0ELb1EE... ->
                # dual_bwd_kernel<128,0,1>
                mangled = line.split("'")[1]
                m = re.search(r'([a-z_]+_kernel)(I\w*?E)?E', mangled)
                if m is None:
                    entry = mangled
                    lib[entry] = {}
                    continue
                args = re.findall(r'L[ib](\d+)E', m.group(2) or '')
                if m.group(1).startswith(('row_gather', 'window')) \
                        and m.group(2):  # type arguments, as mangled
                    args = [m.group(2)[1:-1]]
                if 'bfloat16' in mangled:  # the K-list edge type
                    args.append('bf16')
                entry = m.group(1) + (f'<{",".join(args)}>' if args else '')
                lib[entry] = {}
            elif entry and 'registers' in line:
                lib[entry]['registers'] = int(
                    re.search(r'Used (\d+) registers', line).group(1))
            elif entry and 'spill' in line and 'registers' not in lib[entry]:
                # the entry's own properties come before its registers;
                # those after them are the out-of-line functions' it calls
                lib[entry]['spill_bytes'] = sum(
                    int(v) for v in re.findall(r'(\d+) bytes spill', line))
    emit('build', seconds=time.perf_counter() - t0,
         built={name: sec for name, (sec, _) in report.items()},
         ptxas=ptxas)

    # 3. kernels against their plain versions
    errs = phase_kernels(torch, fd)
    errs.update(phase_dual_kernels(torch, fdd))
    emit('dual_shared_memory_bytes', R=20, **{
        f'{kind} F={F} {dt}': fdd.smem_bytes(F, 20, kind, dt)
        for kind in ('fwd', 'bwd') for F in (32, 64, 128)
        for dt in ('bfloat16', 'float32')})
    errs.update(phase_klist_kernels(torch, fk))
    emit('klist_shared_memory_bytes', R=20, **{
        f'{kind} F={F}': fk.smem_bytes(F, 20, kind)
        for kind in ('fwd', 'bwd', 'dual_fwd', 'dual_bwd')
        for F in (32, 64, 128)})
    # 9a. K1-K8 at other widths against their plain versions
    width_errs = phase_width_kernels(torch, fd, fdd, fk)
    # 3e. the gathers: K9/K12 and K10/K11, and the window ops' entry point
    gather_errs, window_launches, window = phase_gather_kernels(torch, rg,
                                                                wn)

    # 4. + 5. the main path: batched serving, then calculator requests
    samples = parse_xyz(XYZ)
    check(len(samples) == 500, f'expected 500 frames, got {len(samples)}')
    model = load_model(CKPT)
    batches = [collate(samples[k:k + 100], n_pad=21)
               for k in range(0, 500, 100)]

    def to_dev(b):
        return [torch.from_numpy(b[k]).cuda() for k in ('z', 'pos', 'cell')]

    model(*to_dev(batches[0]))  # first use loads the library
    calc = NewtonNetCalculator(CKPT, properties=['energy', 'forces',
                                                 'stress', 'virial'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    served, batch_s = [], []
    for b in batches:
        t = time.perf_counter()
        out = model(*to_dev(b))
        e = out['energy'].cpu().numpy()
        f = out['gradient_force'].cpu().numpy()
        batch_s.append(time.perf_counter() - t)
        served.append((e, f))
    box = 30.0 * np.eye(3)
    requests, lat = [], []
    for k in range(20):
        s = samples[k]
        t = time.perf_counter()
        r = calc.calculate(numbers=s['z'], positions=s['pos'],
                           cell=box if k >= 10 else None)
        lat.append(time.perf_counter() - t)
        requests.append(r)
    launches = dict(fd.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    ae = af = sf = 0.0
    for b, (e, f) in zip(batches, served):
        check(np.isfinite(e).all() and np.isfinite(f).all(),
              'non-finite served output')
        check(e.shape == (100,) and f.shape == (100, 21, 3), 'output shape')
        ae += np.abs(e - b['energy']).astype(np.float64).sum()
        df = (f - b['force']).astype(np.float64)
        af += np.abs(df).sum()
        sf += (df ** 2).sum()
    e_mae, f_mae = ae / 500, af / (500 * 21 * 3)
    f_rmse = float(np.sqrt(sf / (500 * 21 * 3)))
    emit('serve', frames=500, batch=100, n_pad=21, energy_mae=e_mae,
         force_mae=f_mae, force_rmse=f_rmse,
         jax_energy_mae=JAX_ENERGY_MAE, jax_force_mae=JAX_FORCE_MAE,
         batch_ms_median=1e3 * statistics.median(batch_s),
         frames_per_s=500 / sum(batch_s), peak_mib=peak_mib)
    check(abs(e_mae - JAX_ENERGY_MAE) <= 5e-4, f'energy MAE {e_mae}')
    check(abs(f_mae - JAX_FORCE_MAE) <= 5e-5, f'force MAE {f_mae}')

    plain_s, e_err, f_err = [], 0.0, 0.0
    for b, (e, f) in zip(batches, served):
        t = time.perf_counter()
        out = model(*to_dev(b), pair_op=fd.pair_interaction_fwd_ref)
        ep = out['energy'].cpu().numpy()
        fp = out['gradient_force'].cpu().numpy()
        plain_s.append(time.perf_counter() - t)
        e_err = max(e_err, float(np.abs(e - ep).max()))
        f_err = max(f_err, float(np.abs(f - fp).max()))
    emit('serve_vs_plain', energy_max_abs_diff=e_err,
         force_max_abs_diff=f_err, energy_atol=E_ATOL, force_atol=F_ATOL,
         plain_batch_ms_median=1e3 * statistics.median(plain_s))
    check(e_err <= E_ATOL and f_err <= F_ATOL, 'kernel vs plain serving')

    e_ref, f_ref = served[0]
    r_e = r_f = r_s = 0.0
    for k, r in enumerate(requests):
        check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all()
              and np.isfinite(r['virial']).all(), f'request {k} not finite')
        r_e = max(r_e, abs(r['energy'] - float(e_ref[k])))
        r_f = max(r_f, float(np.abs(r['forces'] - f_ref[k]).max()))
        if k >= 10:  # periodic box: stress = -virial / volume
            v = -r['virial'] / 30.0 ** 3
            voigt = v[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
            r_s = max(r_s, float(np.abs(r['stress'] - voigt).max()))
    emit('requests', calls=20, n_pad=24, energy_max_abs_diff=r_e,
         force_max_abs_diff=r_f, stress_vs_virial_max_abs_diff=r_s,
         latency_ms_median=1e3 * statistics.median(lat),
         latency_ms_min=1e3 * min(lat), latency_ms_max=1e3 * max(lat))
    check(r_e <= E_ATOL and r_f <= F_ATOL, 'requests vs batched serving')
    check(r_s <= 1e-6, 'stress is not -virial / volume')
    check(all(launches[k] > 0 for k in fp32_names(fd.LAUNCHES)),
          f'a kernel was not launched on the main path: {launches}')
    emit('launches', **launches)
    tf32_pinned(torch, 'one calculator request (N=24)', calc,
                dict(numbers=samples[0]['z'], positions=samples[0]['pos']))
    emit('profile', what='one batch of 100 frames (N=21)',
         **profile_call(torch, lambda: model(*to_dev(batches[0]))))
    s = samples[0]
    emit('profile', what='one calculator request (N=24)',
         **profile_call(torch, lambda: calc.calculate(
             numbers=s['z'], positions=s['pos'])))

    # 4b. + 5b. neighbour lists: the aspirin frames, then the large box
    serve_nl_launches = phase_serve_nlist(torch, fk, model, batches, to_dev,
                                          served)
    box_launches, box_calc, box_req, klist_box = phase_box_request(
        torch, fk, model)
    # the atomic scatter-adds that gather_nodes' backward was before: 13.2
    # ms of a box request (PERF.md section 5, PR 3's run)
    emit('profile', what=f'one calculator request on the {BOX_ATOMS}-atom '
         'box', gather_nodes_backward_ms_was=13.2,
         **profile_call(torch, lambda: box_calc.calculate(**box_req)))
    del box_calc
    torch.cuda.empty_cache()

    # 4c. + 5c. kernel='xla': the aspirin frames dense and over inverse
    # lists (K9), then the box over inverse lists
    serve_xla_launches = phase_serve_xla(torch, rg, batches, samples, to_dev)
    box_xla_launches, xla_calc, xla_req, xla_t = phase_box_xla(torch, rg,
                                                               klist_box)
    emit('profile', what=f'one XLA inverse-list request on the {BOX_ATOMS}'
         '-atom box', **profile_call(torch, lambda: xla_calc.calculate(
             **xla_req)))
    tf32_pinned(torch, f'one XLA inverse-list request on the {BOX_ATOMS}'
                '-atom box', xla_calc, xla_req)
    emit('box_requests_compared', atoms=BOX_ATOMS,
         klist_latency_ms_median=klist_box['latency_ms_median'],
         xla_inverse_latency_ms_median=xla_t['latency_ms_median'],
         xla_host_list_ms_median=xla_t['host_list_ms_median'],
         xla_host_list_ms_numpy_loop_before=1050.0,
         xla_model_ms_median=xla_t['model_ms_median'])
    del xla_calc
    torch.cuda.empty_cache()

    # 7. training: the first 10 steps, the plain path, one whole epoch
    b0, tuned, opt, main_loss, step_s = phase_train_steps(torch, fd, fdd)
    train_launches = phase_train_epoch(torch, fd, fdd)

    def one_step():
        fastgrad.value_and_grad(tuned, main_loss, b0)
        opt.step()
    prof = profile_call(torch, one_step)
    step_ms = 1e3 * statistics.median(step_s[1:])
    split = {k: prof['dense_kernel_ms'].get(k, 0.0)
             for k in ('K1', 'K2', 'K3', 'K4')}
    split['rest'] = prof['device_busy_ms'] - sum(split.values())
    emit('profile', what='one training step (B=10, N=24)',
         step_ms_median_unprofiled=step_ms, device_split_ms=split,
         device_idle_share_vs_unprofiled=1.0 - prof['device_busy_ms']
         / step_ms, **prof)

    # 7d. + 7e. neighbour-list training: 10 steps against the JAX package's,
    # one epoch through the CLI's entry point, three steps on the box
    phase_train_nlist_steps(torch, fd, fk)
    train_nl_launches = phase_train_nlist_epoch(torch, fk, fd, fdd)
    box_step_launches, box_step, box_step_s = phase_box_train(torch, fk,
                                                              model)
    prof = profile_call(torch, box_step)
    step_ms = 1e3 * statistics.median(box_step_s[1:])
    split = {name: prof['kernel_ms'].get(fam, 0.0) for name, fam in (
        ('K8', 'klist_dual_bwd'), ('K7', 'klist_dual_fwd'),
        ('K6', 'klist_bwd'), ('K5', 'klist_fwd'))}
    split['gather_nodes_backward'] = prof['gather_nodes_backward_ms']
    split['rest'] = prof['device_busy_ms'] - sum(split.values())
    emit('profile', what=f'one training step on the {BOX_ATOMS}-atom box',
         step_ms_median_unprofiled=step_ms, device_split_ms=split,
         device_idle_share_vs_unprofiled=1.0 - prof['device_busy_ms']
         / step_ms, **prof)
    # 7f. + 7g. + 7h. kernel='xla' training: the checkpoint's own config by
    # both steps and one epoch; over neighbour lists; the box with stress
    b0x, x_start, x_trainer, x_step_s, x_grads1, x_e1, f64 = \
        phase_train_xla_steps(torch, fd)
    phase_train_xla_epoch(torch, rg)

    def xla_step():
        with fp32_matmuls():
            x_trainer.loss_and_grad(b0x)
            x_trainer.optimizer.step()
    prof = profile_call(torch, xla_step)
    step_ms = 1e3 * statistics.median(x_step_s[1:])
    emit('profile', what='one XLA standard training step (B=10, N=24)',
         step_ms_median_unprofiled=step_ms, device_split_ms={
             'K9': prof['k9_ms'],
             'rest': prof['device_busy_ms'] - prof['k9_ms']},
         device_idle_share_vs_unprofiled=1.0 - prof['device_busy_ms']
         / step_ms, **prof)
    xla_nlist_launches = phase_train_xla_nlist_steps(torch, rg, x_start,
                                                     x_grads1, x_e1, f64)
    del x_trainer, x_start
    torch.cuda.empty_cache()
    box_xla_launches_step, box_xla_steps, box_xla_c11 = phase_box_train_xla(
        torch, rg, load_model(XLA_CKPT).config_dict())
    for lists, (one_step, step_s) in box_xla_steps.items():
        prof = profile_call(torch, one_step)
        step_ms = 1e3 * statistics.median(step_s[1:])
        split = {'K9': prof['k9_ms'],
                 'gather_nodes_backward': prof['gather_nodes_backward_ms']}
        split['rest'] = prof['device_busy_ms'] - sum(split.values())
        emit('profile', what=f'one XLA standard training step on the '
             f'{BOX_ATOMS}-atom box over {lists}',
             step_ms_median_unprofiled=step_ms, device_split_ms=split,
             device_idle_share_vs_unprofiled=1.0 - prof['device_busy_ms']
             / step_ms, **prof)
    del box_xla_steps
    torch.cuda.empty_cache()

    # 8. the rest of the kernel='xla' path: newton3 half lists served and
    # trained, reverse lists, the cell grid, the staircase; C11's numbers
    xcfg = load_model(XLA_CKPT).config_dict()
    n3_lj_launches, n3_box_launches, n3_model, n3_result, n3_t = \
        phase_newton3_serve(torch, rg, xcfg, xla_t['fp32'])
    n3_step_launches, n3_epoch_launches = phase_newton3_train(torch, fd, rg)
    phase_revlist_cellgrid(torch, rg, xcfg, xla_t['fp32'])
    stair_launches = phase_staircase(torch, rg, xcfg, n3_model, n3_result)
    del n3_model
    torch.cuda.empty_cache()
    # 9b. + 9c. the LJ checkpoint as a kernel='pallas' model at F=48:
    # served dense and over K-lists, fine-tuned dense and over K-lists
    lj_serve_launches = phase_lj_pallas_serve(torch, fd, fdd, fk)
    lj_train_launches = phase_lj_pallas_train(torch, fd, fdd, fk)
    # 10. the bf16 mode of K1/K2 and K5/K6: the kernels against their plain
    # versions, then served: the aspirin checkpoint (dense), the LJ
    # checkpoint (dense and over K-lists), the box (over K-lists)
    bf16_errs = phase_bf16_kernels(torch, fd, fk)
    bf16_dense_launches, bf16_asp_model = phase_bf16_aspirin(
        torch, fd, fk, model, batches, to_dev, served)
    del bf16_asp_model
    bf16_lj_launches = phase_bf16_lj(torch, fd, fdd, fk)
    bf16_box_launches, bf16_box_ms = phase_bf16_box(torch, fk, model)
    emit('bf16_launches', serve_500_frames=bf16_dense_launches,
         lj_per_request=bf16_lj_launches, per_box_request=bf16_box_launches)
    torch.cuda.empty_cache()
    # 11. the bf16 mode of K7/K8 against their plain versions, then
    # fine-tuning bf16 pallas models: the aspirin checkpoint (dense, over
    # K-lists, a dense CLI epoch), the LJ checkpoint (dense, over K-lists
    # with fp32 and bf16 edges, a K-list CLI epoch), the box (three steps)
    bf16_dual_errs = phase_bf16_dual_kernels(torch, fk)
    p11 = phase_bf16_aspirin_train(torch, fd, fdd, fk)
    p11.update({f'lj_{what}': n for what, n in phase_bf16_lj_train(
        torch, fd, fdd, fk).items()})
    p11['per_box_step'], bf16_box_step, _ = phase_box_train(
        torch, fk, model, 'bfloat16')
    bf16_box_t = box_step_timings(
        torch, {'bfloat16': bf16_box_step, 'float32': box_step})
    emit('bf16_box_steps', **bf16_box_t)
    del bf16_box_step
    emit('bf16_train_launches', **p11)
    torch.cuda.empty_cache()
    # 12. the data pipeline: config_lj_hetero.yml's bucketed batches, 10 XLA
    # steps against the JAX package's, the kernel='pallas' override over
    # every bucket, one sharded, prefetched CLI epoch
    hetero_launches = phase_hetero_train(torch, fd, fdd, fk)
    hetero_cli_launches = phase_hetero_cli(torch, fd, fdd, fk)
    torch.cuda.empty_cache()
    # 13. charge heads, the latent Ewald energy and Born effective charges:
    # the aspirin checkpoint served (dense), the box over newton3 half
    # lists (K9, K12), the LJ checkpoint's BEC and fine-tuning
    t13 = time.perf_counter()
    phase_charge_aspirin(torch, batches, samples, to_dev)
    charge_launches = phase_charge_box(torch, rg,
                                       load_model(XLA_CKPT).config_dict())
    charge_launches.update(phase_charge_lj(torch, fd, rg))
    torch.cuda.empty_cache()
    emit('charge_phase', seconds=time.perf_counter() - t13)
    # 14. the Hessian (hessian_block lanes folded into K9's batch), the
    # direct-force head and calculator ensembles
    t14 = time.perf_counter()
    hessian_launches = phase_hessian_aspirin(torch, rg)
    lj_hessian_launches, folded_shape = phase_hessian_lj(torch, rg)
    hessian_launches.update(lj_hessian_launches)
    phase_direct_force(torch, fd)
    phase_ensemble(torch)
    torch.cuda.empty_cache()
    emit('hessian_phase', seconds=time.perf_counter() - t14)
    # 15. MD: the aspirin record, NHC over K1/K2, the LJ liquid in three
    # layouts (K9/K12, the staircase, K5/K6), the large box's half lists
    md_launches = phase_md(torch, fd, fk, rg,
                           load_model(XLA_CKPT).config_dict())
    # 16. export: serving artifacts replayed in a fresh process (K1/K2,
    # K5/K6, K9/K12 as custom ops in the captured programs)
    export_launches = phase_export(torch, fd, fk, rg, batches, samples,
                                   to_dev)
    # 17. parallelism: data-parallel fine-tuning (K1-K4, then K5-K8, on
    # each rank) and graph-parallel dense serving, ranks as processes on
    # this card
    par_launches = phase_parallel(torch, fd, fdd, fk)
    # 18. halo-exchange graph parallelism on the large box: requests,
    # training steps, a CLI epoch and MD, ranks as processes on this card
    # (K9 in every rank's backward)
    halo_launches = phase_halo(torch, rg)
    emit('c11', box_requests=xla_t['c11'],
         box_step_512=box_xla_c11, bars={**C11_BARS,
                                         'step': C11_STEP_SHIFTS},
         bf16_box_request_ms_median=xla_t['latency_ms_median'],
         fp32_box_model_ms_one_call=xla_t['fp32_model_ms_one_call'])

    # K5/K6 launches of the 500 aspirin frames, K7/K8 of the training epoch
    klist_launches = {k: (serve_nl_launches if 'dual' not in k
                          else train_nl_launches)[k] for k in KLIST_NAMES}
    emit('klist_launches', serve_500_frames=serve_nl_launches,
         per_box_request=box_launches, train_epoch=train_nl_launches,
         per_box_step=box_step_launches)

    # 6. timing at the batched serving shape
    B, N, F, R = 100, 21, 128, 20
    ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=0)
    rows = []
    for name in ('pair_fwd', 'pair_fwd_first', 'pair_bwd', 'pair_bwd_first'):
        first = name.endswith('first')
        if name.startswith('pair_fwd'):
            kind = 'fwd'

            def run(ref=False, first=first):
                f = fd.pair_interaction_fwd_ref if ref else \
                    fd.pair_interaction_fwd
                return f(*ins, first_layer=first)
        else:
            kind = 'bwd'

            def run(ref=False, first=first):
                f = fd.pair_interaction_bwd_ref if ref else \
                    fd.pair_interaction_bwd
                return f(*ins, dinv1, deq, first_layer=first,
                         weight_grads=False)
        plain1 = time_ms(torch, lambda: run(True))
        ms = time_ms(torch, run)
        ms2 = time_ms(torch, run)
        plain2 = time_ms(torch, lambda: run(True))
        flops, nbytes = layer_work(B, N, F, R, kind, first)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        rows.append({
            'name': name, 'route': 'cuda', 'source': SOURCES['pair'],
            'replaces': REPLACES[name], 'launches': launches[name],
            'max_abs_err': errs[name], 'ms': statistics.median([ms, ms2]),
            'plain_ms': statistics.median([plain1, plain2]),
            'bound_ms': 1e3 * max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'library_ms': None,
            'flops': flops, 'bytes': nbytes,
            'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2]})
        # K1 and K2: three tf32 products per fp32 one
        rows[-1]['tc_3xtf32_bound_ms'] = 1e3 * 3 * flops / PEAK_TF32_FLOPS
    # K1 and K2 at the training shape, where the dense epoch launches them
    # (phase 7c): the wrapper's event time, the kernels' own device time
    # and the epoch's launches
    Bt, Nt = 10, 24
    ins_t, dinv1_t, deq_t = random_inputs(torch, Bt, Nt, F, R, seed=0)
    for row in rows:
        first = row['name'].endswith('first')
        kind = 'fwd' if row['name'].startswith('pair_fwd') else 'bwd'

        def run_t(first=first, kind=kind):
            if kind == 'fwd':
                return fd.pair_interaction_fwd(*ins_t, first_layer=first)
            return fd.pair_interaction_bwd(*ins_t, dinv1_t, deq_t,
                                           first_layer=first,
                                           weight_grads=False)
        flops, nbytes = layer_work(Bt, Nt, F, R, kind, first)
        row['train_shape'] = dict(B=Bt, N=Nt, F=F, R=R)
        row['train_ms'] = time_ms(torch, run_t)
        row['train_device_ms'] = device_ms(torch, run_t)
        row['train_bound_ms'] = 1e3 * max(flops / PEAK_FP32_FLOPS,
                                          nbytes / PEAK_BYTES_PER_S)
        row['train_tc_3xtf32_bound_ms'] = 1e3 * 3 * flops / PEAK_TF32_FLOPS
        row['train_launches'] = train_launches[row['name']]
    emit('timing', shape=dict(B=B, N=N, F=F, R=R), weight_grads=False,
         peak_fp32_tflops=PEAK_FP32_FLOPS / 1e12,
         peak_tb_per_s=PEAK_BYTES_PER_S / 1e12,
         training_shape={r['name']: {k: r[k] for k in (
             'train_ms', 'train_device_ms', 'train_bound_ms',
             'train_tc_3xtf32_bound_ms', 'train_launches')} for r in rows})

    # K3/K4 at the training shape: bf16 mode (the training path's, in the
    # kernels line, bound by the bf16 tensor-core peak) and fp32 mode
    B, N, F, R = 10, 24, 128, 20
    args, cots = dual_inputs(torch, B, N, F, R, seed=0)
    fp32_rows = []
    for name in ('dual_fwd', 'dual_fwd_first', 'dual_bwd', 'dual_bwd_first'):
        first = name.endswith('first')
        kind = 'fwd' if name.startswith('dual_fwd') else 'bwd'
        for dt in ('bfloat16', 'float32'):
            def run(ref=False, first=first, kind=kind, dt=dt):
                kw = dict(first_layer=first, dot_dtype=dt)
                if kind == 'fwd':
                    f = fdd.pair_interaction_dual_fwd_ref if ref else \
                        fdd.pair_interaction_dual_fwd
                    return f(*args, **kw)
                f = fdd.pair_interaction_dual_bwd_ref if ref else \
                    fdd.pair_interaction_dual_bwd
                return f(*args, *cots, **kw)
            plain1 = time_ms(torch, lambda: run(True))
            ms = time_ms(torch, run)
            ms2 = time_ms(torch, run)
            plain2 = time_ms(torch, lambda: run(True))
            flops, nbytes = dual_work(B, N, F, R, kind, first)
            peak = PEAK_BF16_FLOPS if dt == 'bfloat16' else PEAK_FP32_FLOPS
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
            row = {
                'name': name, 'route': 'cuda', 'source': SOURCES['dual'],
                'replaces': REPLACES[name], 'launches': train_launches[name],
                'max_abs_err': errs[name],
                'ms': statistics.median([ms, ms2]),
                'plain_ms': statistics.median([plain1, plain2]),
                'bound_ms': 1e3 * max(t_ops, t_bytes),
                'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
                'library_ms': None, 'dot_dtype': dt,
                'flops': flops, 'bytes': nbytes,
                'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2]}
            # the kernels' own device time: at this shape the wrapper's
            # host work per call can outlast them
            row['device_ms'] = device_ms(torch, run)
            if dt == 'float32':  # three tf32 products per fp32 one
                row['tc_3xtf32_bound_ms'] = 1e3 * 3 * flops / PEAK_TF32_FLOPS
            (rows if dt == 'bfloat16' else fp32_rows).append(row)
    emit('timing', shape=dict(B=B, N=N, F=F, R=R), what='K3/K4',
         peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
         peak_fp32_tflops=PEAK_FP32_FLOPS / 1e12, fp32_mode_rows=fp32_rows)

    rows += klist_timing(torch, fk, errs, klist_launches, train_nl_launches)
    # 10e. K1/K2 and K5/K6 in bf16 mode beside fp32 mode; their launches
    # on phase 10's main paths (the 500 aspirin frames, one box request)
    rows += bf16_timing(torch, fd, fk, bf16_errs,
                        {**bf16_dense_launches, **bf16_box_launches})
    emit('bf16_requests', box_request_ms={'bf16': bf16_box_ms['bf16_ms'],
                                          'fp32': bf16_box_ms['fp32_ms']})
    # 11e. K7/K8 in bf16 mode beside fp32 mode; their launches on the
    # aspirin K-list fine-tuning's 10 steps (and on every phase 11 path)
    rows += bf16_dual_timing(torch, fk, bf16_dual_errs,
                             p11['train_neighborlist_10_steps'], p11)
    # 9d. K1-K8 at the LJ width beside 64 and at 256 (the prediction's
    # comparisons, 128 in the rows above) and their launches on phase 9's
    # paths
    wt = width_timing(torch, fd, fdd, fk)
    lj_launches = {**{f'serve_{gm}_per_request': n
                      for gm, n in lj_serve_launches.items()},
                   **lj_train_launches}
    family = {'pair_fwd': 'K1', 'pair_bwd': 'K2', 'dual_fwd': 'K3',
              'dual_bwd': 'K4', 'klist_fwd': 'K5', 'klist_bwd': 'K6',
              'klist_dual_fwd': 'K7', 'klist_dual_bwd': 'K8'}
    for row in rows:
        if row['name'] not in wt:
            continue
        kname = family[row['name'].replace('_first', '')]
        row['widths'] = {str(F): v for F, v in wt[row['name']].items()}
        row['widths_checked'] = {str(F): width_errs[F][kname]
                                 for F in WIDTHS_9A}
        row['lj_pallas_launches'] = {k: n.get(row['name'], 0)
                                     for k, n in lj_launches.items()}
    # K1-K4 on phase 12's bucketed paths: 12b's epoch by bucket, 12c's CLI
    # epoch
    for row in rows:
        if row['name'] in DENSE_FP32:
            row['hetero_launches'] = {
                **{f'train_epoch_n_pad_{n}': c[row['name']]
                   for n, c in hetero_launches.items()},
                'cli_epoch': hetero_cli_launches.get(row['name'], 0)}
    emit('gather_launches', serve_500_frames_xla=serve_xla_launches,
         per_box_xla_request=box_xla_launches,
         window_entry_point=window_launches)
    rows += gather_timing(torch, rg, wn, gather_errs,
                          {**box_xla_launches, **window_launches}, window)
    # K9 (and K12, its B = 1 shape) on the XLA training paths: the 10
    # list-mode fine-tuning steps of 7g, one box step of 7h per list layout
    for row in rows:
        key = {'row_gather': 'row_gather',
               'exp_row_gather': 'row_gather_b1'}.get(row['name'])
        if key:
            row['train_launches'] = {
                'xla_nlist_10_steps': xla_nlist_launches[key],
                **{f'per_box_xla_step_{lists}': n[key]
                   for lists, n in box_xla_launches_step.items()},
                'newton3_lj_10_steps': n3_step_launches[key],
                'newton3_lj_cli_epoch': n3_epoch_launches[key]}
            # the half lists' gathers and mirror sums (phase 8)
            row['newton3_launches'] = {
                'per_lj_request': n3_lj_launches[key],
                'per_box_request': n3_box_launches[key],
                'staircase_box_forward_and_forces': stair_launches[key]}
            # charge heads over half lists (phase 13)
            row['charge_launches'] = {what: n[key] for what, n in
                                      charge_launches.items()}
            # Hessian requests (phase 14): all launches, and K9's at a
            # fold of lanes into the batch
            row['hessian_launches'] = {what: n[key] for what, n in
                                       hessian_launches.items()}
            if key == 'row_gather':
                row['hessian_folded_launches'] = {
                    what: n['row_gather_folded']
                    for what, n in hessian_launches.items()}
                row['hessian_folded'] = hessian_folded_timing(
                    torch, rg, folded_shape,
                    row['hessian_folded_launches'])

    # launches per MD step (phase 15) of K1/K2, K5/K6 and K9/K12
    for row in rows:
        name = {'exp_row_gather': 'row_gather_b1'}.get(row['name'],
                                                       row['name'])
        md = {path: n[name] for path, n in md_launches.items() if name in n}
        if md:
            row['md_launches_per_step'] = md
        # launches per replayed call of each phase 16 artifact
        replayed = {what: n[name] for what, n in export_launches.items()
                    if name in n}
        if replayed:
            row['export_launches_per_call'] = replayed
        # launches per rank per data-parallel step of phase 17a
        dp = {f'{layout}_step': n[name] for layout, n in par_launches.items()
              if name in n}
        if dp:
            row['dp_launches_per_step'] = dp
        # K9 launches per rank per request, training step and MD force
        # call of phase 18 (every call there is at B = 1: K12's count too)
        if name in ('row_gather', 'row_gather_b1'):
            row['halo_launches_per_rank'] = halo_launches

    print(card, flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        modes = {'md-aspirin': md_aspirin_main, 'export': export_main,
                 'parallel': parallel_main, 'halo': halo_main}
        if sys.argv[1:2] == ['replay']:
            sys.exit(replay_main(sys.argv[2]))
        if sys.argv[1:2] == ['parallel-rank']:
            sys.exit(parallel_rank_main(sys.argv[2], sys.argv[3]))
        if sys.argv[1:2] == ['halo-rank']:
            sys.exit(halo_rank_main(sys.argv[2], sys.argv[3]))
        sys.exit(modes[sys.argv[1]]() if sys.argv[1:2] and
                 sys.argv[1] in modes else main())
    except PhaseFailed as exc:
        print(f'chip_smoke: FAILED: {exc}', file=sys.stderr, flush=True)
        sys.exit(1)
