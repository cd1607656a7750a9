#!/usr/bin/env python3
"""Serve and train PathNet with the PyTorch/CUDA port on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments,
one card; ``--cards N`` instead runs phase 21's step on ``N`` cards, see
:func:`check_cards`). Phases, each with a start and an end line:

0. device: the card's name, ``nvidia-smi`` name and power limit, versions;
1. build: ``nvcc`` compiles ``pathnet_tpu_torch/csrc/*.cu`` (one process per
   source, all at once) into ``build/pathnet_tpu_torch/<hash>/lib.so``
   (ptxas registers and spills shown, those of K4's three launches
   among them), and K3's tile (walks a block M, threads, shared bytes),
   which K4 shares, at H = 64 and H = 256, and its bf16 tensor-core tile at
   H = 64; the SASS (``cuobjdump``) of every BF16 instance of the encode and
   of K4's BPTT must hold HMMA (the tensor-core product) and that of every
   f32 instance none;
2. kernels: K1 ``cdf_walk``, K2 ``membership_dists``, the fused
   ``walk_dists`` (K1 and K2 in one launch, the sampler's path) and K3
   ``pagg_encode_fwd`` against their plain PyTorch versions on one
   8192-target request of the bgp stand-in (K1, K2, ``walk_dists`` exact;
   K3 within atol = rtol = 1e-4); each kernel timed per launch inside a
   CUDA graph (no host work between launches) and per eager wrapper call,
   each plain version per eager call, all with CUDA events; K3's two
   launches (the encode to h_n, the readout) also timed each alone; then
   ``walk_dists`` against its plain version on every node (the training
   path's grid, 63,977 starts), exact;
3. serve: the bgp stand-in (n = 63,977, F = 8, D = 25) at H = 64, nw = 40,
   wl = 4 with seeded torch-default weights: 8 requests of 8192 targets that
   cover every node, then one of 1024 targets with ``num_ensemble=4``; the
   launch counts must be what the path makes;
4. cornell at full width (F = 1703, D = 190): one request over all nodes, the
   kernels against their plain versions at its shapes, and ``predict`` on
   the card against ``predict`` on the host with the same draws;
5. training kernels on one 8192-target bgp microbatch with a seeded dropout
   mask: K3 in training mode (atol = rtol = 1e-4), K4 ``pagg_encode_bwd``
   (every gradient within 1e-4 of its plain version's largest entry;
   ``dattw``, ``dattb``, sums that cancel, of ``dh``'s if larger), K5
   ``row_gather`` (exact) and ``row_gather_bwd`` (1e-5), K5 also at the
   gather probe's shape; each of K4's three launches (the forward
   recompute with its streams, the attention backward, the BPTT) against
   its plain stage on the plain stage's inputs (within 1e-4 of each
   output's largest plain entry); ``segment_sum`` of those stages' row
   gradients into ``dh`` against its plain version (within 1e-5 of its
   largest entry, two calls bit-equal) and its grouping ``segments``
   against the plain grouping (exact); timed as in phase 2, with the
   PyTorch calls ``index_select`` and ``index_add_`` as K5's library
   yardsticks and ``index_add_`` as ``segment_sum``'s (each library call
   timed as the kernel, per call in a CUDA graph, and eagerly), K3's two
   launches each alone, and K4's three launches and its weight
   contractions each alone: the kernel ``pagg_contract`` beside the plain
   composition it replaced and each step of that composition
   (``contraction_parts``), ``pagg_contract`` timed as phase 2 times its
   kernels with that composition as its library yardstick. Wherever K4's
   launches are held against their plain stages (phases 5, 11-17),
   ``pagg_contract`` is held on the plain stages' streams against its
   plain version run in float64 (within 1e-4 of each gradient's largest
   entry, two calls bit-equal);
6. train: ``run_round`` on the bgp stand-in for 3 epochs (microbatch 8192,
   dropout 0.7, Adam, best-on-validation) with the launch counts of the path;
   then ``segment_sum`` and ``segments`` as in phase 5 on the rows of the
   last train microbatch, whose padding targets send one long run of rows
   to node 0, timed;
7. cornell at full width in training: one step on the card and on the host
   with the same walks and masks; logits and every gradient within 1e-4 of
   the host's largest entry (``attw.bias``, a sum that cancels to near 0,
   within 1e-4 of the largest entry of ``attw.weight``'s gradient); then
   ``segment_sum`` on rows of cornell's walks against its plain version;
7b. two ``run_round`` calls with one seed (cornell at full width, dropout
   0.7, 30 epochs; the bgp stand-in, microbatch 8192, 2 epochs) must give
   bit-equal validation accuracies, losses and best params;
8. the launch floor: an empty kernel's time per launch in a CUDA graph;
   gather probe: K6 ``lane_gather`` against its plain version (exact) at the
   probe's ``[512, 128]`` and at ``[63977, 64]`` (bgp rows x H), timed as in
   phase 2 with ``torch.gather`` as its library yardstick; then the probe
   (``pathnet_tpu_torch.gather_probe.main``) on the card, with its launches;
9. payloads and MERW, in a temporary ``data_root`` holding copies of
   ``data/edge_input/*.in``: ``load_dataset`` makes the cornell, Nba, texas
   and chameleon payloads from nothing (seconds and a sha256 of each array;
   cornell's and Nba's must equal ``PAYLOAD_SHA256``, the JAX package's
   arrays, which a CPU test pins); chameleon's MERW on the card; the port's
   ``merw_graph`` on the card on the bgp stand-in's structure, whose probs
   must lie within ``MERW_TOL`` of the file's; the registry's bgp SBM
   structure and the per-component MERW that ``run_protocol`` runs on the
   host for it, timed;
10. the cornell protocol through the CLI (``pathnet_tpu_torch.run``) at the
    reference defaults (``CORNELL_ROUNDS`` rounds x 1000 epochs, H = 64,
    nw = 40, wl = 4, dropout 0.7) with temporary data, results and checkpoint
    directories; each round's test accuracy must lie within 3 std of the
    JAX band 80.00 +- 5.82 (``results/results.jsonl:106``), the mean inside
    it at 10 rounds (phases 10-12 run one round each; their 10 x 1000 runs
    through ``run_protocol_cli`` on its own, PERF.md section 6);
11. Nba at H = 256: ``walk_dists`` against K1 then K2's plain versions on
    all 403 nodes (D = 442), K3 (with and without the keep mask), K4 and
    ``segment_sum`` against their plain versions, and K4's three launches
    against their plain stages, on
    all 193 train targets of round 0, timed (K3's two launches, K4's three
    and its contractions also each alone), then the protocol through the CLI for
    ``NBA_ROUNDS`` rounds x 1000 epochs at ``-hid 256``, each round's test
    accuracy within 3 std of the JAX band 58.54 +- 5.23
    (``results/results.jsonl:104``);
12. the homo variant: cora at full width (its payload made in phase 9's
    data root, n = 2,708, F = 1,433, H = 64): K3 (with and without the
    keep mask), K4 and its three launches, ``segment_sum`` and K5 against
    their homo plain versions on all 2,708 targets (the tolerances of
    phases 2 and 5), timed as in phase 5; ``predict`` on the card against
    the host; one training step on the card against the host; two seeded
    30-epoch rounds bit-equal; then the cora and citeseer protocols through
    the CLI (``CORA_ROUNDS``, ``CITESEER_ROUNDS`` rounds x 1000 epochs at
    the reference defaults), each round within 3 std of the JAX bands
    74.46 +- 2.66 and 71.94 +- 1.24 (``results/results.jsonl:55,59``) only
    when the payload's fingerprint is the band's (ec4121ed, 907bb672; else
    the phase fails);
13. bf16 compute (``compute_dtype="bfloat16"``, K3's and K4's ``BF16``
    instances): K3 bf16 against its plain version on one 8192-target bgp
    request, K3 (with and without the keep mask) and K4 bf16 with each of
    its three launches on one bgp microbatch, and the homo bf16 instances
    on cora with all 2,708 targets, each within ``BF16_TOL`` (four bf16
    ulps) of its plain version's largest entry and timed as in phase 5, its
    bound at bf16's tensor-core rate with the f32 CUDA-core bound beside
    it; the bf16 instances' times beside the f32 instances' of phases 2, 5
    and 12 (K3 and its encode launch, K4 and its launches A and C, cora),
    K3 and launches A and C required faster at bf16; ``predict`` at bf16 on
    the card against the host (cornell at full
    width, the "h" table; 1024 bgp targets, the "x" table) and one cornell
    training step, within ``BF16_TOL``; two seeded bf16 rounds bit-equal
    (as 7b); then the bgp protocol through the CLI at its band's
    configuration (``--dtype bfloat16 --microbatch 8192``, payload 276b674c,
    else the phase fails) for ``BGP_ROUNDS`` x 1000, and cora at bf16 for
    ``CORA_BF16_ROUNDS`` x 1000;
14. the GRU (``--rnn gru``, K3's and K4's ``GRU`` instances on packed
    weights) and the mean and sum readouts (``--agg mean|sum``, the ``AGG``
    branches of K3's readout and K4's attention backward): K3's GRU
    instance on one 8192-target bgp request, the mean and sum readouts of
    its ``h_n`` against their plain versions and ``torch.mean``/``torch.sum``
    (the readouts' library yardsticks), K3 (with and without the keep mask)
    and K4 with each of its three launches, GRU and LSTM-mean, on one bgp
    microbatch, the attention backward's mean and sum branches alone
    (``d h_n`` alone, rtol 1e-6, no ego-row gradient, ``dattw`` and
    ``dattb`` exact zeros; their library yardstick ``repeat_interleave``
    of ``g / nw`` or ``g``, their bound g read and d h_n written) and K4's
    whole mean and sum calls (``wl`` rows a walk into the segment sum), the homo
    GRU instances on cora with all 2,708 targets, and the bf16 instances
    under mean (the bgp microbatch) and sum (cora, homo) with their stages,
    each timed as phase 5 with its bound at the flops the GRU needs (14 H^2
    a walk step in K3, 42 in K4), the bf16 ones untimed; ``predict`` and one training step on the
    card against the host (cornell at full width, ``--rnn gru`` and ``--agg
    mean``); two seeded GRU rounds bit-equal (as 7b); then through the CLI
    the cora and citeseer ``--agg mean`` protocols (``CORA_MEAN_ROUNDS``,
    ``CITESEER_MEAN_ROUNDS`` x 1000, gated on 80.09 +- 2.11 and 75.82 +- 1.54,
    ``results/results.jsonl:73,76``, on the payloads ec4121ed and 907bb672,
    else the phase fails), cornell ``--rnn gru`` (``CORNELL_GRU_ROUNDS`` x
    1000, gated on the JAX package's host band 80.00 +- 5.30, payload
    89c32d97), and one round each of cornell ``--agg sum`` and cora ``--rnn
    gru`` (no JAX band: above chance).
15. walk length 5 (``-wl 5``, the khop distance backend): K7 (its two
    entries: ``walk_khop_dists``, the walk and its k-hop distances in one
    launch, the sampler's path; ``khop_dists``, the distances of given
    walks) exactly against their plain versions on every node of cornell,
    Nba and cora (their payloads from phase 9's data root, k-hop levels 1-5
    built on the host) at wl = 4, 5 and 6, at wl = 4 also equal to
    ``walk_dists``' K2 distances of the same walks; both timed at wl = 5 as
    phase 2 times its kernels, and ``walk_khop_dists`` beside ``walk_dists``
    on the same wl = 4 walks, beside the launch floor; the dense and host
    backends at cornell and Nba wl = 5: khop's walks and distances exactly;
    K3 (with and without the keep mask), K4 with its three launches and
    ``segment_sum`` at wl = 5 on cornell's and Nba's nodes (hetero, H = 64)
    and cora's 2,708 targets (homo), phase 5's tolerances, timed as phase
    5 beside the same targets at wl = 4; ``predict`` and one training step
    at cornell wl = 5 on the card
    against the host (phase 7's tolerances); one round of the cornell
    protocol through the CLI at ``-wl 5`` (``CORNELL_WL5_ROUNDS`` x 1000,
    payload 89c32d97, else the phase fails), its test accuracy within 3 std
    of the JAX length ablation's 79.73 +- 5.70
    (``results/ablation_length_cornell.json``);
16. the rest of the sampler: K8, the alias walk step, in its three launches
    (``alias_walk_dists`` with K2 at the bgp request and on every bgp and
    cornell node, ``alias_walk_khop_dists`` with K7 at cornell wl = 5,
    ``alias_walk`` alone) exactly against the plain versions given the same
    uniforms; every transition of one seeded bgp epoch of alias walks
    against P, pair of nodes by pair, within Bernstein's bound at a failure
    rate of 1e-6 over all pairs; uniform walks (``kind="uniform"``, the
    symmetrized graph with a self-loop a node): ``walk_dists`` on every
    node of bgp (D = 51), cornell, Nba and cora (32 lanes a walk) and the
    bgp request exactly against its plain version, K3 and K4 on cornell's
    uniform walks at phase 5's tolerances; ``alias_walk_dists`` and
    ``alias_walk`` timed as phase 2 times its kernels at the bgp request
    (the record) and on every cornell node, beside the CDF tables'
    ``walk_dists`` and ``cdf_walk`` on the same starts,
    ``alias_walk_khop_dists`` at cornell wl = 5 beside ``walk_khop_dists``,
    and ``walk_dists`` on the uniform tables of bgp and Nba; one seeded
    cornell round of 1000 epochs on alias walks within 3 std of the cornell
    band and two seeded 30-epoch alias rounds bit-equal; 20-epoch alias
    rounds through the dense backend and at wl = 5; one round of the
    cornell protocol through the CLI at ``-mk uniform``
    (``CORNELL_UNIFORM_ROUNDS`` x 1000, payload 89c32d97), within 3 std of
    the JAX CLI's own host band (``CORNELL_UNIFORM_BAND``);
17. the remaining model choices: the MLP encoder's instances of K3 and K4
    (``rnn="mlp"``: the mean of the selected rows, one product) on one bgp
    request (K3), one bgp microbatch (K3 without and with the keep mask, K4,
    its three launches and the segment sum; the attention and mean
    readouts) and cora's 2,708 targets (homo), at phase 5's tolerances and
    timed as phase 5 with the bound at the 2.5 H^2 (K3) and 7.5 H^2 (K4) a
    walk step the MLP needs; the bf16 GRU's instances at the same request,
    microbatch and on cora (homo), and the bf16 MLP's at the microbatch,
    within four bf16 ulps of their plain versions; the quirk
    (``quirk_compat``, K3 and K4 under their quirk readout on
    ``quirk_layout``'s walks) on cornell's 183 nodes at full width with the
    LSTM, the GRU and the MLP against JAX's quirk as written, phase 5's
    tolerances; ``predict`` and one training step of each choice at cornell
    full width on the card against the host (phase 7's tolerances, bf16
    13's); two seeded MLP rounds bit-equal as in 7b; one round each of
    cornell ``--rnn mlp``, ``--quirk-compat`` and ``--rnn gru --dtype
    bfloat16`` through the CLI (``REMAINING_ROUNDS`` x 1000, payload
    89c32d97), each within 3 std of the JAX CLI's own host band
    (``CORNELL_MLP_BAND``, ``CORNELL_QUIRK_BAND``,
    ``CORNELL_GRU_BF16_BAND``), and one cora ``--rnn mlp`` round above
    chance;
18. the baseline zoo (``--model``): S1 ``spmm`` (both CSR orders at F = 8,
    64 and 8 heads x 64), S2 ``edge_dot`` (8 x 64), S3 ``segment_softmax``
    and S4 ``segment_softmax_bwd`` (8 heads) on the bgp stand-in's baseline
    graphs (703,633 edges with self-loops) against their plain versions
    (1e-5 of the largest plain entry, S3 1e-6), two calls bit-equal, timed
    as phase 2 times its kernels beside ``torch.sparse``'s calls where one
    computes the same function; every model of the zoo at cornell's full
    width on the card against the host (the eval forward, one training
    step's loss, logits, gradients and running statistics, phase 7's
    tolerance) and ``label_propagation`` and ``correct_and_smooth``; GCN
    and GAT full batch on the bgp stand-in, ms and launches an epoch; two
    seeded GCN and two seeded GAT rounds at cornell bit-equal; one round
    each of cornell ``--model mlp``, ``gcn`` and ``gat`` through the CLI
    (``BASELINE_ROUNDS`` x 1000), each within 3 std of its band
    (``BASELINE_BANDS``: the mlp row of ``results/results.jsonl``, the JAX
    CLI's own host runs for GCN and GAT), and one ``--model lp`` round;
19. the bf16 zoo: the eight bf16 instances of S1-S4 against their plain
    versions on the host, on the bgp stand-in's baseline graphs
    (bit-equal where the sum is bf16 and rounded after each add), each
    timed in a CUDA graph beside its f32 instance and, where the call
    exists for bf16, ``torch.sparse.mm`` on a bf16 CSR; every model at
    bf16, card against host (``BF16_HOST_TOL``); GCN and GAT bf16 epochs
    on the bgp stand-in; two seeded bf16 GCN and GAT rounds bit-equal; one
    round each of cornell ``--model gcn`` and ``gat --dtype bfloat16``
    within 3 std of their bands (``BASELINE_BF16_BANDS``, the JAX CLI's own
    host runs) and ``--model fagcn --dtype bfloat16``, counting each bf16
    instance's launches by its C entry's type argument
    (:class:`InstanceCounts`);
20. host utilities and runners: every kernel of the hetero f32 path
    (``walk_dists``, K3 with and without the keep mask, K4 and its three
    launches, ``pagg_contract``, ``segment_sum``, K5) against its plain
    version at wl = 2 and 3 on one 8192-target bgp microbatch (timed, the
    records ``... wl2`` and ``... wl3``) and on every cornell node at full
    width, and under the sum readout on the path-pattern graph's 80 uniform
    walks a node (2,000 nodes, wl = 2 and 3; wl = 3 timed, the records
    ``... sum nw80``), phase 5's tolerances; ``merw/extras`` on cora on the
    card (f32) against the host (f64) within ``EXTRAS_TOL``; ``init_rw`` on
    cornell and cora on the card against the host (records equal,
    probabilities within ``INIT_RW_TOL``); ``utils.trace`` around one
    ``row_gather`` launch, its Chrome trace holding that kernel's event; the
    runners of
    ``pathnet_tpu_torch.experiments`` cut for time: the walk-length ablation
    on cornell (1 x ``ABLATION_EPOCHS`` a length, above chance, its
    wl = 2 and 3 rounds' launches the records'), the path-pattern ablation
    (1 x ``PATTERN_EPOCHS`` a length, above chance), the cornell comparison
    column (1 x ``COMPARISON_EPOCHS``, all 18 columns, each whose JAX mean
    is well above chance above chance), the protocol sweep
    over texas and wisconsin (1 x 1000 each within 3 std of their bands);
    then pubmed (homo, microbatch 8192), Dblp and Electronics (H = 32, bf16,
    microbatch 8192), one round each within 3 std of their bands, pubmed's
    and Electronics' K3 and K4 first held on one microbatch at that
    configuration (:func:`check_band_kernels`; Electronics' flipped
    attention scores counted);
21. the multi-device layer (``pathnet_tpu_torch/parallel``,
    :func:`check_mesh`; the ranks load the library phase 1 built and build
    nothing): one NCCL rank on the card at the bgp stand-in's full width,
    the sharded step (walks, loss, Adam, validation) with row-sharded X
    through the ``gspmd``, ``ring`` and ``sparse`` exchanges against the
    one-process step on the same parameters, walks and masks (loss within
    1e-5, gradients within atol 1e-5 + rtol 1e-4), ``make_sharded_predict``
    on an 8192-target request against ``predict``, every kernel of the
    sharded path launched (counts from 0 around the steps and the request)
    and each held against its plain version on the inputs the ring
    exchange gave it, each step and request timed; then two gloo ranks on
    the one card (staged through host memory) on cornell at full width:
    one step per exchange against each rank's own one-process step, and a
    seeded ``MESH_ROUND_EPOCHS``-epoch round with row-sharded X run twice,
    bit-equal, its test accuracy within 3 std of the cornell band.

The protocol phases gate on their band when they run 10 rounds of 1000
epochs, and on accuracy above chance when a rehearsal cuts them shorter;
the bgp rehearsal holds each round's test accuracy within 3 std of its
band, 70.30 +- 1.26 (``results/results.jsonl:96``).

The line before the last is the kernels' JSON record (launches from phase 6,
the training path, which runs ``walk_dists``, K3, K4 with ``pagg_contract``,
``segment_sum`` and K5, and launches K1 and K2 no time: ``walk_dists`` replaces them there, as
each one's ``note`` says; K6's from phase 8; the homo instances of K3 and
K4, named ``... homo``, from phase 12's cora protocol; the bf16 instances,
named ``... bf16``, from phase 13's bgp and cora protocols, each with an
``f32_bound_ms`` beside its bound at bf16's rate; the GRU instances, named
``... gru``, from phase 14's cornell and cora ``--rnn gru`` protocols; the
readouts' branches, ``pagg_readout mean|sum`` and ``pagg_attention_bwd
mean|sum``, whose launches are K3's and K4's in phase 14's ``--agg mean``
(cora) and ``--agg sum`` (cornell) protocols; K7's two entries from phase
15's wl = 5 protocol, where ``walk_khop_dists`` runs and ``khop_dists`` does
not, as its ``note`` says; K8's three entries from phase 16's alias rounds,
each from the round whose backend runs it; phase 17's MLP instances (``...
mlp``, ``... mlp homo``), bf16 GRU instances (``... gru bf16``) and quirk
readout and backward (``... quirk``) from its cornell and cora protocols;
S1-S4 from phase 18's cornell ``--model gat`` round; their bf16 instances,
named ``... bf16 ...``, from phase 19's cornell bf16 rounds, each with an
``f32_ms`` beside it; phase 20's instances at wl = 2 and 3 (``... wl2``,
``... wl3``) from its cornell ablation rounds at those lengths, and under the
sum readout at nw = 80 (``... sum nw80``) from its pattern round at wl = 3);
the last is ``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result. Without a CUDA card, or outside a checkout, it exits
non-zero.
"""
from __future__ import annotations

import faulthandler
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BGP = os.path.join(ROOT, "data", "bench_cache", "bgp_standin_63977.npz")
CORNELL = os.path.join(ROOT, "data", "edge_input", "cornell.in")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
NW, WL, HIDDEN, REQUEST, EPOCHS = 40, 4, 64, 8192, 3
K3_TOL = 1e-4
K4_TOL = 1e-4      # of each gradient's largest plain entry
K5_BWD_TOL = 1e-5  # of the largest plain entry (atomics order the sums)
KERNELS = ("cdf_walk", "membership_dists", "pagg_encode_fwd", "pagg_encode_bwd",
           "row_gather", "row_gather_bwd", "lane_gather", "segment_sum", "walk_dists",
           "khop_dists", "walk_khop_dists", "alias_walk", "alias_walk_dists",
           "alias_walk_khop_dists", "spmm", "edge_dot", "segment_softmax",
           "segment_softmax_bwd", "pagg_contract")
# the sampler's launches: K1 or K8 alone, fused with K2, fused with K7
WALK_KERNELS = ("cdf_walk", "walk_dists", "walk_khop_dists", "alias_walk", "alias_walk_dists",
                "alias_walk_khop_dists")
SEGMENT_TOL = 1e-5  # of the largest plain entry
# kernels that the main path no longer launches, and why
NOTES = {name: f"0 launches on the main path: {fused} replaces it there; still the "
               "entry of " + use
         for name, fused, use in (("cdf_walk", "walk_dists", "sample_paths"),
                                  ("membership_dists", "walk_dists",
                                   "distances of walks from elsewhere"),
                                  ("khop_dists", "walk_khop_dists",
                                   "k-hop distances of walks from elsewhere"))}
# the kernels a request launches, and those a training step adds
FORWARD_PATH = ("walk_dists", "pagg_encode_fwd", "row_gather")
BACKWARD_PATH = ("pagg_encode_bwd", "segment_sum", "row_gather_bwd", "pagg_contract")
K4_GRADS = ("dh", "dwd", "dbd", "dw_ih", "dw_hh", "db_ih", "db_hh", "dattw", "dattb")
MERW_TOL = 5e-5    # max abs against the stored bgp probs (f32 power iteration)
PAYLOADS = ("cornell", "Nba", "texas", "chameleon")
# sha256 of each payload array (dtype, shape, bytes) as the JAX package makes
# it; tests/test_torch_data_payload.py pins them against pathnet_tpu
PAYLOAD_SHA256 = {
    "cornell": {
        "src": "a2bb944d63e4bc1c953d6dc7c080ce1aa524a9be6e66b493634b36fb38180f5c",
        "dst": "e656f749b4b0d5c3844a47b244e9aff3513c151f29c7a19145f127080b2064b8",
        "prob": "e31fd02f792372e5509dfc399f8ea7383bc147e1fe696dde6e86323ebdf046d7",
        "features": "d1fc16331eb6ed2c5271afc1452f2c84c849678be82c8e6257f6b39c1d124f68",
        "labels": "e7052f43387da3ace7495e2929df4e4ee1b3f7de141395523ee1defa69120413",
    },
    "Nba": {
        "src": "70bda7ed570756633db4cea7d8dc9a36305cbf0ee7aac39d6b418e8e86800493",
        "dst": "1bdb6ee3f267ffbfc871f17e378177fe25dcc94b3a1a856b009fe0a6544be344",
        "prob": "a3b75bb678d16e3d246963b1e9e6af469b8cff171ee33066ad84c84fa82e3cc6",
        "features": "6e0d282230b44160610cffd7a564bab008d8ed6650b31e622ad941d877b05a95",
        "labels": "286c30f9f409167f46a9b244df2d90333e85d60232ba27a99c03bbdc8068c3af",
    },
}
# (mean, std) of the JAX package's 10 x 1000 test accuracy, results/results.jsonl
CORNELL_BAND = (0.8000000178813934, 0.05821799973974322)    # :106, H = 64
NBA_BAND = (0.5853658318519592, 0.05231123852817561)        # :104, H = 256
# phases 10-12 run one round each, held within 3 std of its band; the 10 x
# 1000 of each runs through run_protocol_cli on its own (PERF.md, section 6)
CORNELL_ROUNDS, NBA_ROUNDS, NBA_HIDDEN, PROTOCOL_EPOCHS = 1, 1, 256, 1000
# the homo variant's JAX bands (results/results.jsonl) and the payload each
# was run on
CORA_BAND = (0.7446494042873383, 0.02663735362741913)       # :55
CITESEER_BAND = (0.7193985044956207, 0.01236745494699046)   # :59
HOMO_PAYLOADS = {"cora": "ec4121ed", "citeseer": "907bb672"}
CORA_ROUNDS, CITESEER_ROUNDS = 1, 1
HOMO_KERNELS = ("pagg_encode_fwd", "pagg_encode_bwd")  # the kernels with a HOMO instance
# bf16 compute: K3's and K4's BF16 instances (hetero and homo), held to four
# bf16 ulps of each output's largest plain entry (the gpu tests' tolerance)
BF16_TOL = 4 * 2.0 ** -8
BF16_KERNELS = tuple(f"{n}{v} bf16" for v in ("", " homo") for n in HOMO_KERNELS)
# the bgp band (results/results.jsonl:96): bf16, H = 64, microbatch 8192, on
# payload 276b674c; a run of fewer rounds holds each round to 3 std
BGP_BAND = (0.7030006766319274, 0.004238089026796824)
BGP_PAYLOAD, BGP_ROUNDS, BGP_MICROBATCH = "276b674c", 1, 8192
CORA_BF16_ROUNDS = 1
# the GRU and the mean and sum readouts: the JAX bands of cora and citeseer
# under --agg mean (results/results.jsonl:73,76, the payloads of
# HOMO_PAYLOADS), and of cornell under --rnn gru, the JAX package's 10 x 1000
# on the host (JAX_PLATFORMS=cpu python -m pathnet_tpu.run -data cornell
# --rnn gru, payload 89c32d97; PERF.md §2). A run of fewer rounds holds each
# round to 3 std of its band.
CORA_MEAN_BAND = (0.8009224712848664, 0.02107605412287394)       # :73
CITESEER_MEAN_BAND = (0.7581954956054687, 0.015376636141646069)  # :76
CORNELL_GRU_BAND = (0.800000011920929, 0.05296194166694395)
CORNELL_PAYLOAD = "89c32d97"
CORA_MEAN_ROUNDS = CITESEER_MEAN_ROUNDS = CORNELL_GRU_ROUNDS = 1
# the records of the GRU's instances and the readouts' branches
CHOICE_KERNELS = ("pagg_encode_fwd gru", "pagg_encode_bwd gru", "pagg_encode_fwd gru homo",
                  "pagg_encode_bwd gru homo", "pagg_readout mean", "pagg_readout sum",
                  "pagg_attention_bwd mean", "pagg_attention_bwd sum")
# walk length 5 (the khop backend, K7): the JAX package's length ablation at
# the TrainConfig defaults (H = 64, f32, full batch, nw = 40), 10 x 1000
# (results/ablation_length_cornell.json, results/ablation_length_Nba.json,
# "accuracy_by_len" "5"); a run of fewer rounds holds each round to 3 std
WL5 = 5
CORNELL_WL5_BAND = (0.7972973167896271, 0.057013577308642205)
NBA_WL5_BAND = (0.5609755903482437, 0.04259572922747398)
NBA_PAYLOAD = "419bdc07"
CORNELL_WL5_ROUNDS = 1
KHOP_DATASETS = ("cornell", "Nba", "cora")
KHOP_KERNELS = ("khop_dists", "walk_khop_dists")
# uniform walks (-mk uniform, RW-PathNet): the JAX CLI's own 10 x 1000 on the
# host (JAX_PLATFORMS=cpu python -m pathnet_tpu.run -data cornell -mk uniform,
# payload 89c32d97; PERF.md, section 2); a run of fewer rounds holds each
# round to 3 std
CORNELL_UNIFORM_BAND = (0.7972973048686981, 0.05020047200611047)
CORNELL_UNIFORM_ROUNDS = 1
ALIAS_SHORT_EPOCHS = 20  # the alias rounds through the dense backend and at wl = 5
# the remaining model choices (phase 17): the JAX CLI's own 10 x 1000 of
# cornell --rnn mlp, --quirk-compat and --rnn gru --dtype bfloat16 on the host
# (JAX_PLATFORMS=cpu python -m pathnet_tpu.run -data cornell ..., payload
# 89c32d97; PERF.md, section 2); a run of fewer rounds holds each round to 3 std
CORNELL_MLP_BAND = (0.7945945978164672, 0.03243241310119629)
CORNELL_QUIRK_BAND = (0.7891891896724701, 0.0670793159279102)
CORNELL_GRU_BF16_BAND = (0.8000000059604645, 0.04554675455565366)
REMAINING_ROUNDS = 1
# their records: the MLP's instances, the bf16 GRU's, the quirk's
REMAINING_KERNELS = ("pagg_encode_fwd mlp", "pagg_encode_bwd mlp", "pagg_encode_fwd mlp homo",
                     "pagg_encode_bwd mlp homo", "pagg_encode_fwd gru bf16",
                     "pagg_encode_bwd gru bf16", "pagg_encode_fwd quirk",
                     "pagg_encode_bwd quirk")
# the baseline zoo (phase 18): S1-S4 and their launches an epoch (LP: a round)
# of each banded model through the CLI: a training forward, its backward
# (GAT: S1 for dz and for the two score gathers' VJPs a layer) and an eval
# forward
BASELINE_KERNELS = ("spmm", "edge_dot", "segment_softmax", "segment_softmax_bwd")
BASELINE_LAUNCHES = {"mlp": {}, "gcn": {"spmm": 6},
                     "gat": {"spmm": 10, "edge_dot": 2, "segment_softmax": 4,
                             "segment_softmax_bwd": 2},
                     "fagcn": {"spmm": 10, "edge_dot": 2},
                     "lp": {"spmm": 100}}
BASELINE_TOL = 1e-5   # S1, S2, S4: of the plain version's largest entry
SOFTMAX_TOL = 1e-6    # S3's outputs, absolute
# (mean, std) of the JAX package's 10 x 1000 test accuracy of each banded
# baseline, with its payload and width: --model mlp from results/results.jsonl
# (:107, :56, :105, :97); GCN and GAT the JAX CLI's own runs on the host
# (JAX_PLATFORMS=cpu python -m pathnet_tpu.run -data <name> --model <m>;
# PERF.md, section 2). A run of fewer rounds holds each round to 3 std.
BASELINE_BANDS = {
    ("cornell", "mlp"): ((0.8135135352611542, 0.04902259545490344), CORNELL_PAYLOAD, 64),
    ("cora", "mlp"): ((0.72361621260643, 0.02576163970637985), "ec4121ed", 64),
    ("Nba", "mlp"): ((0.5756097435951233, 0.05662529736005569), NBA_PAYLOAD, 256),
    ("bgp", "mlp"): ((0.6538797914981842, 0.004285084614521797), BGP_PAYLOAD, 64),
    ("cornell", "gcn"): ((0.6162162125110626, 0.07431203345711547), CORNELL_PAYLOAD, 64),
    ("cornell", "gat"): ((0.5594594538211822, 0.07744080175268676), CORNELL_PAYLOAD, 64),
    ("cora", "gcn"): ((0.8730627298355103, 0.018130060520037027), "ec4121ed", 64),
    ("cora", "gat"): ((0.8738007366657257, 0.011645563249943766), "ec4121ed", 64),
}
BASELINE_ROUNDS, BASELINE_SEEDED_EPOCHS, BGP_BASELINE_EPOCHS = 1, 30, 50
# the bf16 zoo (phase 19): the JAX CLI's own 10 x 1000 of cornell --model
# gcn|gat --dtype bfloat16 on the host (PERF.md, section 2), and the bf16
# instances of S1-S4, each keyed by its C entry and the entry's type
# argument (S1: bit 0 h bf16, bit 1 w bf16, bit 2 out bf16; S2: bit 0 h
# bf16, bit 1 g and out bf16; S3, S4: 1 for bf16)
BASELINE_BF16_BANDS = {
    "gcn": ((0.6216216146945953, 0.07047786068942424), CORNELL_PAYLOAD, 64),
    "gat": ((0.5162162095308304, 0.05465877624919281), CORNELL_PAYLOAD, 64),
}
BASELINE_BF16_INSTANCES = {
    ("pathnet_spmm", 1): "spmm bf16 rows", ("pathnet_spmm", 4): "spmm bf16 sum",
    ("pathnet_spmm", 7): "spmm bf16", ("pathnet_spmm", 5): "spmm bf16 gather",
    ("pathnet_edge_dot", 1): "edge_dot bf16 rows", ("pathnet_edge_dot", 3): "edge_dot bf16",
    ("pathnet_segment_softmax", 1): "segment_softmax bf16",
    ("pathnet_segment_softmax_bwd", 1): "segment_softmax_bwd bf16"}
BASELINE_BF16_KERNELS = tuple(BASELINE_BF16_INSTANCES.values())
# the type argument's place in each entry's arguments
INSTANCE_ARG = {"pathnet_spmm": 9, "pathnet_edge_dot": 8, "pathnet_segment_softmax": 6,
                "pathnet_segment_softmax_bwd": 7}
BF16_SUM_ULPS = 8   # a library's bf16 sum (f32 accumulation) beside a per-add one
# every bf16 model, card against host, of the host's largest entry: the bf16
# matmuls add in another order on the card, and a product that rounds the
# other way moves what follows by a bf16 ulp (measured: GAT-JK 6.0e-2 at
# cornell's full width, every other model 7.6e-3 or less)
BF16_HOST_TOL = 2.0 ** -3
# phase 20: the new shapes of the walk-length ablation (wl = 2, 3) and of the
# path-pattern task (80 uniform walks, the sum readout), each kernel's
# instance a record of its own (``instance_name``)
SHORT_WLS = (2, 3)
PATTERN_NW, PATTERN_WL, PATTERN_N = 80, 3, 2000
WL_KERNELS = ("walk_dists", "pagg_encode_fwd", "pagg_encode_bwd", "pagg_contract",
              "segment_sum")
PATTERN_KERNELS = WL_KERNELS[1:]
EXTRAS_TOL = 1e-4      # merw/extras on the card (f32) against the host's f64
INIT_RW_TOL = 5e-5     # init_rw's probabilities, card against host
# the runners at a depth cut for time (their 10 x 1000 run in full_protocols.py)
ABLATION_EPOCHS, PATTERN_EPOCHS, COMPARISON_EPOCHS = 300, 200, 100
# the cornell columns whose JAX mean (results/comparison_cornell.json, 10 x
# 1000) is near chance (1/5): link 0.276, lp 0.249; every other column's is
# 0.53 or more, so at 1 x COMPARISON_EPOCHS each of those must beat chance
COMPARISON_NEAR_CHANCE = ("link", "lp")
TEXAS_BAND = (0.7945946097373963, 0.07171081340583227)       # :108
WISCONSIN_BAND = (0.779999977350235, 0.06572669863009666)    # :110
SWEEP_BANDS = {"texas": (TEXAS_BAND, "d652c615"), "wisconsin": (WISCONSIN_BAND, "2951ae86")}
# item 14's larger bands, one round each in phase 20 and 10 x 1000 in
# full_protocols.py: (dataset, H, band, payload, dtype, microbatch)
PUBMED_BAND = (0.9040832221508026, 0.003600605275611917)       # :61
DBLP_BAND = (0.725084662437439, 0.004791932623111868)          # :92
ELECTRONICS_BAND = (0.6670053005218506, 0.005268764335488223)  # :100
BAND_PROTOCOLS = (("pubmed", HIDDEN, PUBMED_BAND, "0c262124", "float32", BGP_MICROBATCH),
                  ("Dblp", HIDDEN, DBLP_BAND, "bf54585a", "float32", None),
                  ("Electronics", 32, ELECTRONICS_BAND, "e45d6452", "bfloat16", BGP_MICROBATCH))
# the new instances each band's kernels are held at (check_band_kernels)
BAND_KERNEL_CHECKS = ("pubmed", "Electronics")

# phase 21: the multi-device layer (pathnet_tpu_torch/parallel)
EXCHANGES = ("gspmd", "ring", "sparse")
STEP_ATOL, STEP_RTOL, LOSS_TOL = 1e-5, 1e-4, 1e-5   # the CPU tests' tolerances
MESH_ROUND_EPOCHS = 400
CARDS_CLI_EPOCHS = 300      # check_cards' cornell round through the CLI
RANK_TIMEOUT_S = 420
SHARDED_PATH = ("walk_dists", "pagg_encode_fwd", "pagg_encode_bwd", "pagg_contract",
                "segment_sum", "row_gather", "row_gather_bwd")
# each wrapper's call sites on the sharded path: (record, module, attribute)
TAPS = (("walk_dists", "pathnet_tpu_torch.sample.walk", "walk_dists"),
        ("pagg_encode_fwd", "pathnet_tpu_torch.models.pagg", "pagg_encode_fwd"),
        ("pagg_encode_bwd", "pathnet_tpu_torch.models.pagg", "pagg_encode_bwd"),
        ("pagg_contract", "pathnet_tpu_torch.kernels.pagg_encode_bwd", "contractions"),
        ("segment_sum", "pathnet_tpu_torch.kernels.pagg_encode_bwd", "segment_sum"),
        ("segment_sum", "pathnet_tpu_torch.parallel.ring", "segment_sum"),
        ("row_gather", "pathnet_tpu_torch.models.pagg", "row_gather"),
        ("row_gather", "pathnet_tpu_torch.parallel.ring", "row_gather"),
        ("row_gather_bwd", "pathnet_tpu_torch.models.pagg", "row_gather_bwd"))

def walk_kernel(wl: int) -> str:
    """The sampler's launch at walk length ``wl``: the membership backend's
    ``walk_dists`` to 4, the khop backend's ``walk_khop_dists`` past it."""
    return "walk_dists" if wl <= 4 else "walk_khop_dists"


def forward_path(wl: int = WL) -> tuple:
    """The kernels a request launches at walk length ``wl``."""
    return (walk_kernel(wl),) + FORWARD_PATH[1:]


def say(msg: str) -> None:
    print(msg, flush=True)


def array_sha256(a) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() + a.tobytes()).hexdigest()


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.monotonic()
        say(f"[phase {self.name}] start")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self.t0
        state = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        say(f"[phase {self.name}] {state} after {dt:.1f} s")
        return False


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=10)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {type(e).__name__}"


def time_ms(fn, iters: int) -> float:
    """Mean ms per call: CUDA events around ``iters`` warm eager calls, host
    work between them included."""
    import torch
    for _ in range(2):
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


def graph_ms(fn, iters: int) -> float:
    """Mean ms per launch on the card: ``iters`` calls captured in one CUDA
    graph and replayed warm, so no host work lies between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes_: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """The least ms for the work: bytes over HBM's rate or operations over
    ``ops_per_s`` (f32 by default; bf16's tensor-core rate for bf16
    inputs), whichever is larger, and which."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_ops(deg, starts, paths, dists):
    """K2's compares on this data: the N1 tests of v2 and v3 against deg(s)
    slots, and the N2 test deg(v3) x deg(s) where v3 is not in N1(s)."""
    ds = deg[starts.long()].double()[:, None]
    wl = paths.shape[2]
    ops = float(((dists[:, :, 2] != 0).double() * ds).sum()) if wl > 2 else 0.0
    if wl > 3:
        dv3 = deg[paths[:, :, 3].long()].double()
        ops += float(((dists[:, :, 3] != 0).double() * ds).sum()
                     + ((dists[:, :, 3] >= 2).double() * ds * dv3).sum())
    return ops


def check_kernels(tag, ps, model, X, idx, u, rec, timed):
    """Hold K1, K2, K3 against their plain versions on one request; time them
    when ``timed``. Updates ``rec[name]`` with errors, times and bounds."""
    import torch
    from pathnet_tpu_torch import kernels as K

    smp = ps.sampler
    paths = K.cdf_walk(smp.nbr, smp.cdf, idx, u, ps.num_walks)
    paths_p = K.cdf_walk_plain(smp.nbr, smp.cdf, idx, u, ps.num_walks)
    torch.cuda.synchronize()
    if not torch.equal(paths, paths_p):
        raise AssertionError(f"{tag}: cdf_walk differs from its plain version in "
                             f"{int((paths != paths_p).sum())} entries")
    dists = K.membership_dists(smp.nbr, smp.deg, idx, paths)
    dists_p = K.membership_dists_plain(smp.nbr, smp.deg, idx, paths)
    torch.cuda.synchronize()
    if not torch.equal(dists, dists_p):
        raise AssertionError(f"{tag}: membership_dists differs from its plain "
                             f"version in {int((dists != dists_p).sum())} entries")
    check_walk_dists(tag, smp, idx, u, ps.num_walks, (paths_p, dists_p), rec)
    h, w = model.encode_inputs(X)
    agg = K.pagg_encode_fwd(h, paths, dists, *w)
    agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w)
    torch.cuda.synchronize()
    err3 = float((agg - agg_p).abs().max())
    if not torch.allclose(agg, agg_p, atol=K3_TOL, rtol=K3_TOL):
        raise AssertionError(f"{tag}: pagg_encode_fwd max abs err {err3} "
                             f"beyond atol = rtol = {K3_TOL}")
    for name, err in (("cdf_walk", 0.0), ("membership_dists", 0.0),
                      ("pagg_encode_fwd", err3)):
        rec[name]["max_abs_err"] = max(rec[name].get("max_abs_err", 0.0), err)
    say(f"  {tag}: cdf_walk exact, membership_dists exact, walk_dists exact, "
        f"pagg_encode_fwd max abs "
        f"err {err3:.3e} within atol = rtol = {K3_TOL}  (T={idx.shape[0]}, nw={ps.num_walks}, "
        f"wl={ps.walk_len}, D={smp.max_deg}, H={h.shape[1]})")
    if not timed:
        return
    S, nw, wl = paths.shape
    H = h.shape[1]
    # K1: two tables, starts, u in; walks out. One compare per slot and step.
    b1 = nbytes(smp.nbr, smp.cdf, idx, u, paths)
    o1 = S * nw * (wl - 1) * smp.max_deg
    # K2: the compares this data needs (k2_ops)
    b2 = nbytes(smp.nbr, smp.deg, idx, paths, dists)
    o2 = k2_ops(smp.deg, idx, paths, dists)
    # the fused launch: both tables, deg, starts, u in; walks and distances
    # out (the sorted rows are this design's copy of nbr, not the function's
    # input); K1's compares and K2's
    bw = nbytes(smp.nbr, smp.cdf, smp.deg, idx, u, paths, dists)
    # K3: per walk step 2H^2 (select) + 16H^2 (gates); per walk 6H (readout).
    b3 = nbytes(h, paths, dists, agg, *w)
    o3 = S * nw * (wl * 18 * H * H + 6 * H)
    runs = {
        "cdf_walk": (lambda: K.cdf_walk(smp.nbr, smp.cdf, idx, u, nw),
                     lambda: K.cdf_walk_plain(smp.nbr, smp.cdf, idx, u, nw), b1, o1),
        "membership_dists": (lambda: K.membership_dists(smp.nbr, smp.deg, idx, paths),
                             lambda: K.membership_dists_plain(smp.nbr, smp.deg, idx, paths),
                             b2, o2),
        "walk_dists": (lambda: K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, idx, u, nw),
                       lambda: K.walk_dists_plain(smp.nbr, smp.cdf, smp.deg, smp.srt, idx,
                                                  u, nw), bw, o1 + o2),
        "pagg_encode_fwd": (lambda: K.pagg_encode_fwd(h, paths, dists, *w),
                            lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w), b3, o3),
    }
    for name, (kern, plain, b, o) in runs.items():
        ms = graph_ms(kern, 50)
        call_ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        bound_ms, bound_by = bound(b, o)
        rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        say(f"  {name}: {ms:.4f} ms per launch in a CUDA graph, {call_ms:.4f} ms per "
            f"eager wrapper call (plain {plain_ms:.4f} ms eager, bound {bound_ms:.4f} ms "
            f"by {bound_by}: {b / 1e6:.1f} MB, {o / 1e9:.3f} G ops)")
    rec["pagg_encode_fwd"]["stages"] = time_k3_stages("pagg_encode_fwd", h, paths, dists, w)


def check_walk_dists(tag, smp, idx, u, nw, want, rec):
    """The fused walk-and-distance launch against K1 then K2's plain
    versions: both outputs exact."""
    import torch
    from pathnet_tpu_torch import kernels as K

    got = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, idx, u, nw)
    torch.cuda.synchronize()
    for name, a, b in zip(("paths", "dists"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: walk_dists {name} differ from the plain "
                                 f"versions' in {int((a != b).sum())} entries")
    record_err(rec, "walk_dists", 0.0)


def check_segment_sum(tag, paths, rows, n, rec, time_as=None, homo=False, agg="attention",
                      ego=None):
    """The segment sum of K4's row gradients against its plain version run
    in float64 (within SEGMENT_TOL of the plain maximum, two calls bit-equal)
    and its grouping (``segments``) against the plain grouping (exact); the
    float32 plain version's own error is printed beside it (on the card its
    ``index_add_`` adds a node's rows in the order its atomics land, which
    moves the padded microbatch's 412,000-row sum at node 0 by about
    SEGMENT_TOL of the maximum from one call to the next); timed as
    ``time_as`` when given, with ``index_add_`` as its library yardstick.
    ``homo``: the rows are the homo variant's (``wl`` a walk, in sampled
    order); ``agg`` mean or sum: hetero rows without the ego rows' (``wl``
    a walk); ``ego``: the quirk's ego nodes (``row_nodes``)."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.kernels.segment_sum import segments, segments_plain

    nodes = K.row_nodes(paths, homo, agg, ego)
    if nodes.shape[0] != rows.shape[0]:
        raise AssertionError(f"{tag}: {rows.shape[0]} row gradients, {nodes.shape[0]} nodes")
    units, offsets = segments(nodes, n)
    units_p, offsets_p = segments_plain(nodes, n)
    U = int(offsets_p[-1])
    if not (torch.equal(offsets, offsets_p) and torch.equal(units[:U], units_p[:U])):
        raise AssertionError(f"{tag}: segments differ from the plain grouping")
    got = K.segment_sum(rows, nodes, n)
    again = K.segment_sum(rows, nodes, n)
    want = K.segment_sum_plain(rows.double(), nodes, n)
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    err32 = float((K.segment_sum_plain(rows, nodes, n).double() - want).abs().max())
    if not err <= SEGMENT_TOL * float(want.abs().max()):
        raise AssertionError(f"{tag}: segment_sum max abs err {err} (the float32 plain "
                             f"version's {err32})")
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: segment_sum differs between two calls")
    record_err(rec, "segment_sum", err)
    say(f"  {tag}: segments exact ({U} units), segment_sum max abs err {err:.3e} within "
        f"{SEGMENT_TOL} x max (float32 plain {err32:.3e}), two calls bit-equal "
        f"({rows.shape[0]} rows of {rows.shape[1]} "
        f"into {n} nodes)")
    if time_as is not None:
        R, H = rows.shape
        idx_l = nodes.long()
        # the function's bytes: rows and their node ids read, dh written (the
        # units and offsets are this design's, not the function's)
        b = R * H * 4 + R * 4 + n * H * 4
        timed(rec if time_as in rec else {time_as: {}}, time_as,
              lambda: K.segment_sum(rows, nodes, n),
              lambda: K.segment_sum_plain(rows, nodes, n), b, float(R * H), 20,
              library=lambda: torch.zeros((n, H), device=rows.device).index_add_(0, idx_l,
                                                                                  rows))
        say(f"  {time_as}: its grouping alone (segments) {graph_ms(lambda: segments(nodes, n), 20):.4f} "
            "ms per call in a CUDA graph")


def timed(rec, name, kern, plain, b, o, iters=50, library=None, kern_graph=None,
          bf16=False, ops_per_s=None):
    """Time a kernel per launch in a CUDA graph and per eager call, its plain
    version per eager call and (if given) the library call as the kernel,
    per call in a CUDA graph (its ``library_ms``) and eagerly; record them.
    A library call that a CUDA graph cannot capture keeps its eager time as
    its ``library_ms``, marked ``library_eager``, to be set beside the
    wrapper's eager call (``call_ms``). ``bf16``: the bound at bf16's
    tensor-core rate, and beside it the f32 CUDA-core bound of the same
    operations (``f32_bound_ms``). ``ops_per_s``: the bound's rate of
    operations, where it is neither."""
    import torch

    ms = graph_ms(kern_graph or kern, iters)
    call_ms = time_ms(kern, max(2, iters // 3))
    plain_ms = time_ms(plain, 3)
    lib_ms, lib_text = None, "n/a"
    if library is not None:
        lib_call = time_ms(library, 20)
        try:
            lib_ms = graph_ms(library, iters)
            lib_text = f"{lib_ms:.4f} ms in a CUDA graph, eager {lib_call:.4f} ms"
        except RuntimeError as e:
            torch.cuda.synchronize()
            lib_ms = lib_call
            rec[name]["library_eager"] = True
            lib_text = (f"{lib_call:.4f} ms eager, beside the wrapper's eager "
                        f"{call_ms:.4f} ms (no CUDA graph capture: {str(e).splitlines()[0]})")
    rec[name]["call_ms"] = call_ms
    bound_ms, bound_by = bound(b, o, ops_per_s or (BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
    rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms)
    f32_note = ""
    if bf16:
        rec[name]["f32_bound_ms"] = bound(b, o)[0]
        f32_note = f", f32 CUDA-core bound {rec[name]['f32_bound_ms']:.4f} ms"
    say(f"  {name}: {ms:.4f} ms per launch in a CUDA graph, {call_ms:.4f} ms per "
        f"eager wrapper call (plain {plain_ms:.4f} ms eager, library {lib_text}"
        f", bound {bound_ms:.4f} ms by {bound_by}{' at bf16' if bf16 else ''}{f32_note}: "
        f"{b / 1e6:.1f} MB, {o / 1e9:.3f} G ops)")


def time_k3_stages(tag, h, paths, dists, w, mask_args=(None, 1.0), homo=False,
                   agg="attention", cell="lstm"):
    """Each of K3's two launches alone, per launch in a CUDA graph; returns
    their ms by launch."""
    from pathnet_tpu_torch import kernels as K

    enc = (h, paths, dists, *w[:6], *mask_args, homo, cell)
    out = K.encode_walks(*enc)
    hn, ego = out if homo else (out, None)
    enc_ms = graph_ms(lambda: K.encode_walks(*enc), 20)
    read_ms = graph_ms(lambda: K.readout(h, paths, hn, *w[6:], ego, agg), 50)
    say(f"  {tag}: K3's encode launch {enc_ms:.4f} ms, its readout launch "
        f"{read_ms:.4f} ms, per launch in a CUDA graph")
    return {"encode": enc_ms, "readout": read_ms}


def check_k4_stages(tag, g, h, paths, dists, w, mask, keep, homo=False, tol=K4_TOL,
                    agg="attention", cell="lstm", ego_paths=None, rec=None):
    """Each of K4's three launches against its plain stage, on the plain
    stage's inputs: every output within ``tol`` of its plain version's
    largest entry (``dattw``, ``dattb``, sums that cancel, of the ego rows'
    ``dh`` if larger; under mean and sum no ``dego`` and zero ``dattw``,
    ``dattb``); then the weight contractions on the plain stages' streams
    (:func:`check_contract`, recorded in ``rec``). Returns the row gradients
    that ``segment_sum`` adds
    (hetero attention: the BPTT's and the ego rows'; else the BPTT's). The
    quirk: ``paths``, ``dists`` and ``mask`` in ``quirk_layout``'s layout,
    the attention backward on its ego nodes ``ego_paths``."""
    import torch
    from pathnet_tpu_torch import kernels as K

    parts = []

    def hold(stage, names, got, want, cancel_scale=0.0):
        for name, a, b in zip(names, got, want):
            if b is None:   # no cs (the GRU, the MLP), gt or dgates (the MLP), dego
                if a is not None:
                    raise AssertionError(f"{tag}: K4's {stage} launch returned a {name}")
                continue
            err = float((a - b).abs().max())
            top = float(b.abs().max())
            scale = max(top, cancel_scale) if name in ("dattw", "dattb") else top
            if not err <= tol * scale:
                raise AssertionError(f"{tag}: K4's {stage} launch, {name} max abs err "
                                     f"{err} beyond {tol} x {scale}")
            parts.append(f"{name} {err / max(top, 1e-30):.1e}")

    enc = (h, paths, dists, *w[:6], mask, keep, homo)
    want = K.encode_walks_streams_plain(*enc, cell=cell)
    hold("recompute", ("hn", "xr", "xin", "hp", "cs", "gt", "ego"),
         K.encode_walks_streams(*enc, cell), want)
    hn, xr, xin, hp, cs, gt = want[:6]
    ego = want[6] if homo else None
    att = agg in ("attention", "quirk")
    ap = paths if ego_paths is None else ego_paths
    want = K.attention_bwd_plain(g, h, ap, hn, *w[6:], ego, agg)
    got = K.attention_bwd(g, h, ap, hn, *w[6:], ego, agg)
    if not att and (got[2].any() or got[3].any()):
        raise AssertionError(f"{tag}: K4's attention launch, dattw, dattb not zero under {agg}")
    hold("attention", ("dhn", "dego", "dattw", "dattb"), got, want,
         float(want[1 if att else 0].abs().max()))
    dhn, dego = want[0], want[1]
    bargs = (dhn, paths, dists, w[0], w[2], w[3], {"gru": hp, "mlp": None}.get(cell, cs))
    hargs = (xin, ego, dego) if homo else None
    want = K.bptt_plain(*bargs, gt, mask, keep, hargs, cell=cell)
    hold("bptt", ("drow", "dgates", "dsel"),
         K.bptt(*bargs, None if gt is None else gt.clone(), mask, keep, hargs, cell), want)
    say(f"  {tag}: K4's three launches each within {tol:.3g} of its plain stage (error "
        "over each plain max: " + ", ".join(parts) + ")")
    check_contract(tag, (xr, xin, hp, want[2], dhn if cell == "mlp" else want[1], dists,
                         homo, cell), rec)
    H = h.shape[1]
    drow = want[0].reshape(-1, H)
    return drow if dego is None or homo else torch.cat([drow, dego])   # the row gradients


def check_contract(tag, con, rec=None, tol=K4_TOL):
    """``pagg_contract`` on the streams ``con`` (``contractions``' arguments)
    against its plain version run in float64: each gradient within ``tol``
    of its largest entry, two calls bit-equal; the float32 plain version's
    own error printed beside it (its ``torch.matmul`` sums 1.3 M rows in
    another order). Recorded under ``pagg_contract`` in ``rec``."""
    import torch
    from pathnet_tpu_torch import kernels as K

    got = K.contractions(*con)
    again = K.contractions(*con)
    want = K.contractions_plain(*(t.double() if isinstance(t, torch.Tensor)
                                   and t.is_floating_point() else t for t in con))
    plain = K.contractions_plain(*con)
    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for name, a, b, c, p in zip(("dwd", "dbd", "dw_ih", "dw_hh", "db"), got, want, again,
                                plain):
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: pagg_contract {name} of shape {tuple(a.shape)}, "
                                 f"its plain version's {tuple(b.shape)}")
        if not torch.equal(a, c):
            raise AssertionError(f"{tag}: pagg_contract {name} differs between two calls")
        if not b.numel():
            continue
        err = float((a.double() - b).abs().max())
        top = float(b.abs().max())
        if not err <= tol * top:
            raise AssertionError(f"{tag}: pagg_contract {name} max abs err {err} beyond "
                                 f"{tol} x {top}")
        worst = max(worst, err)
        parts.append(f"{name} {err / max(top, 1e-30):.1e} (f32 plain "
                     f"{float((p.double() - b).abs().max()) / max(top, 1e-30):.1e})")
    if rec is not None:
        record_err(rec, "pagg_contract", worst)
    say(f"  {tag}: pagg_contract within {tol:.3g} of its float64 plain version, two calls "
        "bit-equal (error over each max: " + ", ".join(parts) + ")")


def contraction_parts(xr, xin, hp, dsel, dg, dists, homo=False, cell="lstm", tile=4096):
    """The steps of the plain weight contractions (``contractions_plain``,
    the card path before ``pagg_contract``) as callables on the outputs of
    the steps before them, to time each alone: ``layout``, the classes,
    their ranks and each row's padded destination; ``copies``, the two
    zero-filled buffers and their ``index_copy_``; ``bmm``, the tile
    products; ``onehot``, the two one-hot class sums; ``dw_ih``, ``dw_hh``
    and ``db`` (the MLP: ``m^T d h_n`` and its row sum, no ``dw_hh``). The
    code is ``class_contractions``' and ``contractions_plain``'s, line by
    line."""
    import torch
    from pathnet_tpu_torch.kernels.pagg_encode_bwd import _step_classes

    wl, B, H = xr.shape
    x, s = xr.view(-1, H), dsel.view(-1, H)
    classes, R = wl, x.shape[0]
    ntiles = R // tile + classes

    def layout():
        d = _step_classes(dists, homo).reshape(-1)
        rank = (torch.arange(classes, device=d.device)[:, None] == d).cumsum(1)
        padded = (rank[:, -1] + tile - 1) // tile * tile
        ends = padded.cumsum(0)
        return (ends - padded)[d] + rank.gather(0, d[None])[0] - 1, ends

    dest, ends = layout()

    def copies():
        return (x.new_zeros((ntiles * tile, H)).index_copy_(0, dest, x),
                s.new_zeros((ntiles * tile, H)).index_copy_(0, dest, s).view(ntiles, tile, H))

    xp, sp = copies()

    def bmm():
        return torch.bmm(xp.view(ntiles, tile, H).transpose(1, 2), sp)

    prod = bmm()

    def onehot():
        starts = torch.arange(ntiles, device=x.device) * tile
        cls = torch.bucketize(starts, ends, right=True).clamp_(max=classes - 1)
        oh = (torch.arange(classes, device=x.device)[:, None] == cls).to(x.dtype)
        return (oh @ prod.view(ntiles, H * H)).view(classes, H, H), oh @ sp.sum(dim=1)

    parts = {"layout": layout, "copies": copies, "bmm": bmm, "onehot": onehot}
    if cell == "mlp":
        parts.update(dw_ih=lambda: hp.t() @ dg, db=lambda: dg.sum(dim=0))
    else:
        g2 = dg.view(wl * B, 4 * H)
        parts.update(dw_ih=lambda: xin.view(-1, H).t() @ g2,
                     dw_hh=lambda: hp.view(-1, H).t() @ g2, db=lambda: g2.sum(dim=0))
    return parts


def contract_bounds(xr, xin, hp, dsel, dg, dists, homo=False, cell="lstm"):
    """(bytes, operations) of ``pagg_contract`` on these streams: each stream
    and ``dists`` read once, the gradients written once; the products' flops
    three times (the 3xTF32 split), the row sums once."""
    wl, B, H = xr.shape
    G = dg.shape[-1]
    rows = dg.numel() // G
    mlp = cell == "mlp"
    out = (wl * H * H + wl * H + H * G + G + (0 if mlp else H * G)) * 4
    prods = 2 * wl * B * H * H + 2 * rows * H * G * (1 if mlp else 2)
    return (nbytes(xr, dsel, hp, dg, dists, *(() if mlp else (xin,))) + out,
            3 * prods + wl * B * H + rows * G)


def time_k4_stages(tag, g, h, paths, dists, w, mask, keep, homo=False, agg="attention",
                   cell="lstm", rec=None):
    """Each of K4's three launches and the weight contractions alone, per
    launch in a CUDA graph: the kernel ``pagg_contract`` beside the plain
    composition it replaced (``torch.matmul``, ``bmm``), whose steps
    (:func:`contraction_parts`) are each timed too; returns their ms by
    stage (the MLP's contractions take ``d h_n`` for its gate gradients).
    With ``rec``, ``pagg_contract`` is timed into it as ``timed`` does, its
    bound at the TF32 tensor cores' rate (:func:`contract_bounds`), no
    library call (no one PyTorch call computes the function; the plain
    composition's time in a graph is printed beside it)."""
    from pathnet_tpu_torch import kernels as K

    enc = (h, paths, dists, *w[:6], mask, keep, homo, cell)
    hn, xr, xin, hp, cs, gt, *ego = K.encode_walks_streams(*enc)
    ego = ego[0] if homo else None
    rec_ms = graph_ms(lambda: K.encode_walks_streams(*enc), 5)
    dhn, dego = K.attention_bwd(g, h, paths, hn, *w[6:], ego, agg)[:2]
    att_ms = graph_ms(lambda: K.attention_bwd(g, h, paths, hn, *w[6:], ego, agg), 20)
    bargs = (dhn, paths, dists, w[0], w[2], w[3], {"gru": hp, "mlp": None}.get(cell, cs), gt,
             mask, keep, (xin, ego, dego) if homo else None, cell)
    _, dg, dsel = K.bptt(*bargs)
    # each replay writes over gt again; the time does not depend on the values
    bptt_ms = graph_ms(lambda: K.bptt(*bargs), 5)
    dg = dhn if cell == "mlp" else dg
    con = (xr, xin, hp, dsel, dg, dists, homo, cell)
    con_ms = graph_ms(lambda: K.contractions(*con), 5)
    plain_ms = graph_ms(lambda: K.contractions_plain(*con), 5)
    parts = {k: graph_ms(fn, 5) for k, fn in contraction_parts(*con).items()}
    if rec is not None:
        timed(rec, "pagg_contract", lambda: K.contractions(*con),
              lambda: K.contractions_plain(*con), *contract_bounds(*con), 20,
              ops_per_s=TF32_OPS_PER_S)
    say(f"  {tag}: K4's forward recompute {rec_ms:.4f} ms, attention backward "
        f"{att_ms:.4f} ms, BPTT {bptt_ms:.4f} ms, weight contractions (pagg_contract) "
        f"{con_ms:.4f} ms beside their plain composition {plain_ms:.4f} ms (torch.matmul, "
        "bmm; its steps " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + " ms), each per launch in a CUDA graph")
    return {"recompute": rec_ms, "attention": att_ms, "bptt": bptt_ms, "contractions": con_ms,
            "contractions_plain": plain_ms, **{f"plain_{k}": v for k, v in parts.items()}}


def record_err(rec, name, err):
    rec[name]["max_abs_err"] = max(rec[name].get("max_abs_err", 0.0), err)


def homo_name(name, homo, bf16=False, cell="lstm"):
    """A kernel's record: its GRU, MLP, homo and bf16 instances' records have
    their own names."""
    return (name + ("" if cell == "lstm" else f" {cell}") + (" homo" if homo else "")
            + (" bf16" if bf16 else ""))


def check_k4(tag, got, want, tol=K4_TOL):
    """Each K4 gradient within ``tol`` of its plain version's largest entry;
    ``dattw`` and ``dattb`` (sums over all walks that cancel) against the
    larger of that and ``dh``'s largest entry. Returns the max abs error."""
    got, want = [t.float() for t in got], [t.float() for t in want]
    dh_max = float(want[0].abs().max())
    worst = 0.0
    parts = []
    for name, a, b in zip(K4_GRADS, got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: pagg_encode_bwd {name} of shape {tuple(a.shape)}, "
                                 f"its plain version's {tuple(b.shape)}")
        if not b.numel():   # the MLP's empty recurrent weights
            continue
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if name in ("dattw", "dattb"):
            scale = max(scale, dh_max)
        parts.append(f"{name} {err / max(float(b.abs().max()), 1e-30):.1e}")
        if not err <= tol * scale:
            raise AssertionError(f"{tag}: pagg_encode_bwd {name} max abs err {err} "
                                 f"beyond {tol} x {scale}")
        worst = max(worst, err)
    say(f"  {tag}: pagg_encode_bwd within {tol:.3g} (error over each plain max: "
        + ", ".join(parts) + ")")
    return worst


def unpacked(grads, cell):
    """K4's gradients, the GRU's packed weights' unpacked: the kernel leaves
    the entries of the packing's zero blocks as its contractions give them
    (autograd drops them there), the plain version zeros."""
    if cell != "gru":
        return grads
    from pathnet_tpu_torch.kernels.pagg_encode import unpack_gru
    dh, dwd, dbd, *wb, dattw, dattb = grads
    return (dh, dwd, dbd, *unpack_gru(*wb).values(), dattw, dattb)


def k3_close(agg, agg_p, bf16):
    """K3 against its plain version: f32 within atol = rtol = K3_TOL; bf16
    within BF16_TOL of the plain version's largest entry."""
    import torch
    if bf16:
        return float((agg - agg_p).abs().max()) <= BF16_TOL * float(agg_p.abs().max())
    return torch.allclose(agg, agg_p, atol=K3_TOL, rtol=K3_TOL)


def cell_flops(cell, H, wl):
    """The flops one walk needs in K3's encode and in K4 (without the
    readout's): the select 2 H^2 a step; the LSTM's gates 16 H^2 a step, the
    GRU's 12 H^2 (though the packed products run the LSTM's), the MLP's one
    product of the mean, 2 H^2 a walk; K4 three times K3's (the recompute,
    the backward products, the weight contractions)."""
    k3 = wl * {"lstm": 18, "gru": 14, "mlp": 2}[cell] * H * H + (2 * H * H if cell == "mlp"
                                                                 else 0)
    return k3, 3 * k3


def encode_bounds(h, paths, dists, m1, agg, g, w, cell="lstm"):
    """(bytes, ops) of K3 with a mask and of K4 on these inputs: each walk's
    ``cell_flops``, 6 H a walk for K3's readout and ~14 H for K4's
    attention."""
    T, nw, wl = paths.shape
    H = h.shape[1]
    walks = T * nw
    k3, k4 = cell_flops(cell, H, wl)
    b3 = nbytes(h, paths, dists, m1, agg, *w)
    o3 = walks * (k3 + 6 * H)
    b4 = nbytes(g, h, paths, dists, m1, *w) + nbytes(h, *w)
    o4 = walks * (k4 + 14 * H)
    return b3, o3, b4, o4


def check_encode_kernels(tag, ps, model, X, idx, u, gen, rec, time_segment=False,
                         kink=False, names=None):
    """K3 without and with a keep mask, K4 and the segment sum of K4's row
    gradients against their plain versions on the targets ``idx`` (the
    segment sum timed when ``time_segment``), in ``model``'s variant (a homo
    model's kernels record under ``homo_name``); returns the inputs and
    outputs for timing. ``kink`` (phase 17's bf16 hetero attention
    instances): K4 is held against the plain stages composed on the
    kernel's own forward recompute (itself held to the plain one by
    ``check_k4_stages``), not against the plain backward of the plain
    forward: the leaky ReLU's derivative jumps at a score of 0, and a score
    closer to 0 than one bf16 ulp of ``h_n`` moves can take the other
    branch, moving ``dattw``, ``dattb`` and that walk's rows of ``dh`` by
    its whole ``d score`` (``dattb`` 0.078 of a 1.83 scale at the bgp
    microbatch, PR 19's call 3); the walks whose score changes sign are
    counted and printed. ``names``: the records of K3 and K4 by kernel, in
    place of the instance's own."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.models import draw_dropout_masks

    paths, dists = ps.sample(idx, u=u)
    T, nw, wl = paths.shape
    h, w = model.encode_inputs(X)
    H = h.shape[1]
    homo, bf16 = model.homo, model.bf16
    choice = dict(agg=model.agg, cell=model.spec.rnn)
    # the records of K3's and K4's instances (the quirk's, whatever its cell,
    # under "... quirk"); the mean and sum readouts' branches record their
    # own launches' errors (check_choice_kernels); instances without a
    # record are checked alone
    names = names or {k: k + " quirk" if choice["agg"] == "quirk"
                      else homo_name(k, homo, bf16, choice["cell"])
                      if choice["agg"] == "attention" else None
                      for k in ("pagg_encode_fwd", "pagg_encode_bwd")}
    names = {k: v if v in rec else None for k, v in names.items()}
    keep = 1.0 - model.spec.dropout
    m1, _ = draw_dropout_masks(model.spec, T, nw, gen, X.device)
    for mask_args, what in (((None, 1.0), "without a mask"), ((m1, keep), "with the keep mask")):
        agg = K.pagg_encode_fwd(h, paths, dists, *w, *mask_args, homo, **choice)
        agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w, *mask_args, homo, **choice)
        torch.cuda.synchronize()
        err3 = float((agg - agg_p).abs().max())
        if not k3_close(agg, agg_p, bf16):
            raise AssertionError(f"{tag}: pagg_encode_fwd {what} max abs err {err3}")
        if names["pagg_encode_fwd"]:
            record_err(rec, names["pagg_encode_fwd"], err3)
        say(f"  {tag}: pagg_encode_fwd {what} max abs err {err3:.3e} within "
            + (f"{BF16_TOL:.4g} x max {float(agg_p.abs().max()):.3f}" if bf16 else
               f"atol = rtol = {K3_TOL}")
            + f" (T={T}, nw={nw}, wl={wl}, H={H}, keep={keep:.2f}, {h.dtype})")
    g = torch.randn((T, H), generator=gen, device=X.device)
    bwd_args = (g, h, paths, dists, *w, m1, keep, homo)
    got = K.pagg_encode_bwd(*bwd_args, **choice)
    want = K.pagg_encode_bwd_plain(*bwd_args, **choice)
    if kink and not homo and choice["agg"] == "attention":
        cell = choice["cell"]
        enc = (h, paths, dists, *w[:6], m1, keep, homo)
        hn_k, xr, xin, hp, cs, gt = K.encode_walks_streams(*enc, cell)
        hn_p = K.encode_walks_streams_plain(*enc, cell=cell)[0]
        e = h[paths[:, :, 0].reshape(-1).long()].float() @ w[6][H:] + w[7]
        flips = int(((hn_k @ w[6][:H] + e > 0) != (hn_p @ w[6][:H] + e > 0)).sum())
        say(f"  {tag}: {flips} of {T * nw} walks' scores change sign between the kernel's "
            "h_n and the plain h_n; K4 held on the kernel's forward recompute")
        dhn, dego, dattw, dattb = K.attention_bwd_plain(g, h, paths, hn_k, *w[6:])
        drow, dg, dsel = K.bptt_plain(dhn, paths, dists, w[0], w[2], w[3],
                                      {"gru": hp, "mlp": None}.get(cell, cs), gt, m1, keep,
                                      cell=cell)
        dh = K.segment_sum_plain(torch.cat([drow.reshape(-1, H), dego]), K.row_nodes(paths),
                                 h.shape[0])
        con = K.contractions(xr, xin, hp, dsel, dhn if cell == "mlp" else dg, dists, cell=cell)
        db_hh = con[4].new_zeros(0) if cell == "mlp" else con[4]
        want = (*(t.to(h.dtype) for t in (dh, *con, db_hh)), dattw, dattb)
    torch.cuda.synchronize()
    tol = BF16_TOL if bf16 else K4_TOL
    err4 = check_k4(tag, unpacked(got, choice["cell"]), unpacked(want, choice["cell"]), tol)
    if names["pagg_encode_bwd"]:
        record_err(rec, names["pagg_encode_bwd"], err4)
    if choice["agg"] in ("mean", "sum") and (got[7].any() or got[8].any()):
        raise AssertionError(f"{tag}: dattw, dattb not zero under {choice['agg']}")
    del got, want
    # the quirk's launches run on its layout (pagg_encode.quirk_layout)
    sp, sd, sm, ego_paths = paths, dists, m1, None
    if choice["agg"] == "quirk":
        from pathnet_tpu_torch.kernels.pagg_encode import quirk_layout
        sp, sd, ego_paths, perm = quirk_layout(paths, dists)
        sm = m1[:, perm].contiguous()
    rows = check_k4_stages(tag, g, h, sp, sd, w, sm, keep, homo, tol, ego_paths=ego_paths,
                           rec=rec, **choice)
    check_segment_sum(tag, sp, rows, h.shape[0], rec,
                      homo_name("segment_sum", homo) if time_segment else None, homo,
                      choice["agg"], ego_paths)
    del rows
    return paths, dists, h, w, m1, keep, agg, g, bwd_args


def check_training_kernels(ps, model, X, idx, u, gen, rec):
    """K3 with a mask, K4, K5 against their plain versions on one training
    microbatch, then the probe's shape for K5; time each."""
    import torch
    from pathnet_tpu_torch import kernels as K

    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        "bgp microbatch", ps, model, X, idx, u, gen, rec, time_segment=True)
    T, nw, wl = paths.shape
    H = h.shape[1]

    n = h.shape[0]
    probe_tbl = torch.randn((512, 128), generator=gen, device=X.device)
    probe_idx = torch.randint(0, 512, (512,), generator=gen, device=X.device,
                              dtype=torch.int32)
    for tag, tbl, ix in (("ego rows", h, idx), ("probe [512, 128]", probe_tbl, probe_idx)):
        out = K.row_gather(tbl, ix)
        if not torch.equal(out, K.row_gather_plain(tbl, ix)):
            raise AssertionError(f"row_gather differs from its plain version ({tag})")
        dout = torch.randn(out.shape, generator=gen, device=X.device)
        d = K.row_gather_bwd(dout, ix, tbl.shape[0])
        d_p = K.row_gather_bwd_plain(dout, ix, tbl.shape[0])
        err5 = float((d - d_p).abs().max())
        if not err5 <= K5_BWD_TOL * float(d_p.abs().max()):
            raise AssertionError(f"row_gather_bwd ({tag}) max abs err {err5}")
        record_err(rec, "row_gather", 0.0)
        record_err(rec, "row_gather_bwd", err5)
        say(f"  {tag}: row_gather exact, row_gather_bwd max abs err {err5:.3e} within "
            f"{K5_BWD_TOL} x max (n={tbl.shape[0]}, C={tbl.shape[1]}, m={ix.shape[0]})")

    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w)
    uniq = int(torch.unique(idx).numel())
    b5 = (uniq * H + T * H + T) * 4      # distinct rows read, rows written, idx
    b5b = (T * H + T + n * H) * 4        # dout and idx read, all of dtbl written
    idx_l = idx.long()
    dout = torch.randn((T, H), generator=gen, device=X.device)
    # K3's record keeps its serving time (phase 2); this one is printed only
    timed({"pagg_encode_fwd with keep mask": {}}, "pagg_encode_fwd with keep mask",
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=m1, keep=keep),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep), b3, o3, 20)
    time_k3_stages("pagg_encode_fwd with keep mask", h, paths, dists, w, (m1, keep))
    timed(rec, "pagg_encode_bwd", lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 5)
    rec["pagg_encode_bwd"]["stages"] = time_k4_stages("pagg_encode_bwd", g, h, paths, dists,
                                                      w, m1, keep, rec=rec)
    timed(rec, "row_gather", lambda: K.row_gather(h, idx),
          lambda: K.row_gather_plain(h, idx), b5, 0.0, 50,
          library=lambda: torch.index_select(h, 0, idx_l))
    timed(rec, "row_gather_bwd", lambda: K.row_gather_bwd(dout, idx, n),
          lambda: K.row_gather_bwd_plain(dout, idx, n), b5b, float(T * H), 50,
          library=lambda: torch.zeros((n, H), device=X.device).index_add_(0, idx_l, dout),
          kern_graph=lambda: K.row_gather_bwd(dout, idx, n, check=False))


def check_gather_probe(dev, gen, rec):
    """K6 against its plain version at the probe's shape and at bgp rows x H,
    timed; then the probe on the card, whose launches are K6's record."""
    import torch
    from pathnet_tpu_torch import gather_probe
    from pathnet_tpu_torch import kernels as K

    for n, D, lo in ((gather_probe.N, gather_probe.D, 0), (63977, HIDDEN, -63977)):
        tbl = torch.rand((n, D), generator=gen, device=dev)
        ix = torch.randint(lo, n, (n,), generator=gen, device=dev, dtype=torch.int32)
        out = K.lane_gather(tbl, ix)
        if not torch.equal(out, K.lane_gather_plain(tbl, ix)):
            raise AssertionError(f"lane_gather differs from its plain version at [{n}, {D}]")
        record_err(rec, "lane_gather", 0.0)
        say(f"  [{n}, {D}], idx in [{lo}, {n}): lane_gather exact")
        ids = torch.remainder(ix.long(), D)[:, None].expand(n, D)
        # rows written; idx and each row's selected float read
        b = (n * D + 2 * n) * 4
        name = "lane_gather" if n == gather_probe.N else f"lane_gather [{n}, {D}]"
        timed(rec if name == "lane_gather" else {name: {}}, name,
              lambda: K.lane_gather(tbl, ix), lambda: K.lane_gather_plain(tbl, ix), b, 0.0,
              50, library=lambda: torch.gather(tbl, 1, ids))
    K.reset_launch_counts()
    report = gather_probe.main([])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    calls = gather_probe.REPS + 1
    expect = {name: 0 for name in KERNELS}
    expect.update(row_gather=3 * calls, lane_gather=calls)
    say(f"  launches: {counts}")
    if counts != expect:
        raise AssertionError(f"gather probe launch counts {counts}, the probe makes {expect}")
    for case in gather_probe.case_functions():
        if not report[case]["ok"] or report[case]["max_abs_err"] != 0.0:
            raise AssertionError(f"gather probe case {case}: {report[case]}")
    rec["lane_gather"]["launches"] = counts["lane_gather"]


def make_payloads(root, dev, z):
    """Payloads from nothing in ``root``, held to the JAX package's digests
    where pinned; chameleon's MERW and the bgp stand-in's on the card."""
    import torch
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.registry import load_dataset, load_structure
    from pathnet_tpu_torch.merw import merw_graph, merw_graph_per_component

    os.makedirs(os.path.join(root, "edge_input"))
    for f in sorted(glob.glob(os.path.join(ROOT, "data", "edge_input", "*.in"))):
        shutil.copy(f, os.path.join(root, "edge_input"))
    graphs = {}
    for name in PAYLOADS:
        t0 = time.perf_counter()
        g = load_dataset(name, root, 0)[0]
        secs = time.perf_counter() - t0
        digests = {f: array_sha256(getattr(g, f))
                   for f in ("src", "dst", "prob", "features", "labels")}
        say(f"  {name}: n={g.n}, {len(g.src)} records, F={g.features.shape[1]}, made in "
            f"{secs:.3f} s; sha256 " + ", ".join(f"{k} {v[:16]}" for k, v in digests.items()))
        want = PAYLOAD_SHA256.get(name)
        if want is not None:
            bad = [k for k in want if digests[k] != want[k]]
            if bad:
                raise AssertionError(f"{name}: arrays {bad} differ from the JAX package's")
            say(f"  {name}: all five arrays equal the JAX package's")
        graphs[name] = g
    gch = graphs["chameleon"]
    t0 = time.perf_counter()
    mch = merw_graph_per_component(gch, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (np.isfinite(mch.prob).all() and (mch.prob > 0).all()):
        raise AssertionError("chameleon MERW probabilities are not finite and positive")
    say(f"  chameleon MERW (one component: the power iteration on the card): {ms:.1f} ms")
    bg = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=np.ones(len(z["src"])))
    t0 = time.perf_counter()
    mb = merw_graph(bg, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(mb.prob - z["prob"]).max())
    say(f"  bgp stand-in merw_graph on the card (n={bg.n}, {len(bg.src)} records): "
        f"{ms:.1f} ms, probs max abs err {err:.3e} against the stored ones")
    if not err <= MERW_TOL:
        raise AssertionError(f"bgp MERW probs differ from the stored ones by {err}")
    # what run_protocol pays before the first bgp round: the registry's SBM
    # stand-in is disconnected, so per-component MERW on the host (f64
    # log-space solver)
    t0 = time.perf_counter()
    gs = load_structure("bgp", root)
    t1 = time.perf_counter()
    mp = merw_graph_per_component(gs, device=dev)
    t2 = time.perf_counter()
    if not (np.isfinite(mp.prob).all() and (mp.prob > 0).all()):
        raise AssertionError("bgp per-component MERW probabilities are not finite and positive")
    say(f"  bgp SBM structure (n={gs.n}, {len(gs.src)} records): made in {t1 - t0:.2f} s; "
        f"merw_graph_per_component on the host (f64 log-space solver) {t2 - t1:.1f} s")


def check_wide_encode(root, dev, gen, rec):
    """K3 (with and without the mask) and K4 against their plain versions at
    Nba's H = 256 on all train targets of round 0, timed."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    g, train, _, _, spec_d = load_dataset("Nba", root, 0)
    ps = PathSampler.build(g, NW, WL, device=dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    model = PathNet(PaggSpec(feat_dim=X.shape[1], hidden=NBA_HIDDEN,
                             out_dim=spec_d.num_classes, walk_len=WL, dropout=0.7),
                    device=dev, generator=torch.Generator().manual_seed(3))
    idx = torch.from_numpy(np.flatnonzero(train).astype(np.int32)).to(dev)
    u = draw_uniforms(WL, idx.shape[0] * NW, gen, dev)
    smp = ps.sampler
    every = torch.arange(g.n, dtype=torch.int32, device=dev)
    ua = draw_uniforms(WL, g.n * NW, gen, dev)
    pa = K.cdf_walk_plain(smp.nbr, smp.cdf, every, ua, NW)
    check_walk_dists("Nba", smp, every, ua, NW,
                     (pa, K.membership_dists_plain(smp.nbr, smp.deg, every, pa)), rec)
    say(f"  Nba, all {g.n} nodes (D={smp.max_deg}): walk_dists exact")
    paths, dists, h, w, m1, keep, agg, gout, bwd_args = check_encode_kernels(
        f"Nba round 0, {idx.shape[0]} train targets", ps, model, X, idx, u, gen, rec)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, gout, w)
    name3, name4 = f"pagg_encode_fwd H={NBA_HIDDEN} masked", f"pagg_encode_bwd H={NBA_HIDDEN}"
    timed({name3: {}}, name3,
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, keep_mask=m1, keep=keep),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep), b3, o3, 20)
    time_k3_stages(name3, h, paths, dists, w, (m1, keep))
    timed({name4: {}}, name4, lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 10)
    time_k4_stages(name4, gout, h, paths, dists, w, m1, keep)


def step_card_vs_host(tag, spec, dev, samplers, Xs, idx, y, tol=1e-4, wl=WL):
    """One training step (dropout masks drawn on the host) on the card and on
    the host from the same weights, walks and masks: one launch of each
    training kernel on the card, and the logits and every gradient within
    ``tol`` of the host's largest entry (``attw.bias``, a sum that cancels to
    near 0, within ``tol`` of the largest entry of ``attw.weight``'s
    gradient). ``samplers`` and ``Xs`` are (card, host) pairs at walk length
    ``wl``."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.models import PathNet, draw_dropout_masks

    n = samplers[1].sampler.n
    u = torch.rand((wl - 1, n * NW), generator=torch.Generator().manual_seed(7))
    masks = draw_dropout_masks(spec, idx.shape[0], NW, torch.Generator().manual_seed(8),
                               "cpu")
    out = []
    for d, psx, Xx in zip((dev, "cpu"), samplers, Xs):
        m = PathNet(spec, device=d, generator=torch.Generator().manual_seed(2))
        K.reset_launch_counts()
        p, dd = psx.sample(u=u.to(d))
        rows = idx.long().to(d)
        logits = m(Xx, p[rows], dd[rows], idx.to(d), train=True,
                   masks=tuple(t.to(d) for t in masks))
        torch.nn.functional.cross_entropy(logits, y[idx.long()].to(d)).backward()
        if d == dev:
            torch.cuda.synchronize()
            step_counts = K.launch_counts()
        out.append({"logits": logits.detach().cpu(),
                    **{k: q.grad.cpu() for k, q in m.named_parameters()}})
    if step_counts != {name: int(name in forward_path(wl) or name in BACKWARD_PATH)
                       for name in KERNELS}:
        raise AssertionError(f"{tag} step launch counts {step_counts}, expected 1 of "
                             "each training kernel")
    parts = []
    for k, want in out[1].items():
        err = float((out[0][k] - want).abs().max())
        scale = float(want.abs().max())
        if k == "attw.bias":
            # a sum over all walks of the score gradients, which cancel
            # to near 0; its summands are those of attw.weight's gradient
            scale = max(scale, float(out[1]["attw.weight"].abs().max()))
        parts.append(f"{k} {err / max(float(want.abs().max()), 1e-30):.1e}")
        if not err <= tol * scale:
            raise AssertionError(f"{tag} step: {k} differs from the host's by {err}")
    say(f"  {tag}, {idx.shape[0]} train nodes, F = {spec.feat_dim}, {spec.variant}, "
        f"{spec.compute_dtype}, within {tol:.3g}: logits "
        f"and all {len(out[1]) - 1} gradients on the card against the host (error over "
        "the host's largest entry): " + ", ".join(parts))


def rounds_bit_equal(tag, X, y, ps, masks, classes, cfg, spec):
    """Two ``run_round`` calls with one seed give bit-equal validation
    accuracies, losses and best params."""
    import torch
    from pathnet_tpu_torch.train import run_round

    a, b = (run_round(X, y, ps, spec, cfg, *masks, classes, seed=4, track_history=True,
                      keep_params=True) for _ in range(2))
    same = {"history": np.array_equal(a.history, b.history),
            "losses": np.array_equal(a.losses, b.losses),
            "best_params": all(torch.equal(v, b.best_params[k])
                               for k, v in a.best_params.items())}
    if not all(same.values()):
        raise AssertionError(f"{tag}: two seeded rounds differ: {same}; losses "
                             f"{a.losses.tolist()} and {b.losses.tolist()}")
    say(f"  {tag}, {cfg.epochs} epochs: two rounds with seed 4 bit-equal in history, "
        f"losses and all {len(a.best_params)} best params (last loss "
        f"{float(a.losses[-1]):.6f}, best val {a.best_val_acc:.4f})")


def check_reproducible(dev, gc, Xc, X, z, psc, ps, dtype="float32", rnn="lstm"):
    """Two ``run_round`` calls with one seed give bit-equal validation
    accuracies, losses and best params: cornell at full width with dropout
    (full batch, 30 epochs) and the bgp stand-in (microbatch 8192, the last
    chunk padded, 2 epochs), at the compute dtype ``dtype``, with the
    encoder ``rnn``."""
    import torch
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data.splits import get_whole_mask, ratio_masks
    from pathnet_tpu_torch.models import PaggSpec

    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n)).to(dev)
    y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    C = int(z["y"].max()) + 1
    cases = (("cornell", Xc, yc, psc, ratio_masks(gc.n, 1000, val_size=59)[:3], 5,
              TrainConfig(epochs=30)),
             ("bgp stand-in", X, y, ps, get_whole_mask(z["y"], seed=1), C,
              TrainConfig(epochs=2, microbatch=REQUEST)))
    for tag, Xx, yy, psx, masks, classes, cfg in cases:
        spec = PaggSpec(feat_dim=Xx.shape[1], hidden=HIDDEN, out_dim=classes, walk_len=WL,
                        dropout=0.7, compute_dtype=dtype, rnn=rnn)
        rounds_bit_equal(f"{tag} {dtype} {rnn}", Xx, yy, psx, masks, classes, cfg, spec)


def run_protocol_cli(name, root, tmp, rounds, hidden, band, payload=None, dtype="float32",
                     microbatch=None, round_band=False, rnn="lstm", agg="attention", wl=WL,
                     marker="merw", quirk=False):
    """The protocol through the CLI on the card with temporary results and
    checkpoint directories (``--dtype dtype``, ``--rnn rnn``, ``--agg agg``,
    ``-wl wl``, ``-mk marker``, ``--microbatch`` where given, ``--quirk-compat``
    with ``quirk``); checks its launches (one
    sampler launch an epoch, ``walk_kernel(wl)``), checkpoints and
    accuracy, and returns the launch counts. At 10 rounds x 1000 epochs the
    mean test accuracy must lie inside the JAX ``band``, whose payload
    fingerprint (``payload``, where given) the dataset's must equal; a
    shorter run must lie above chance, or with ``round_band`` hold each
    round's test accuracy within 3 std of the band's mean. ``band`` None:
    no band (a configuration the JAX package has no run of), above chance
    only."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch import run
    from pathnet_tpu_torch.data.registry import DATASETS, load_dataset, payload_fingerprint

    if payload is not None and payload_fingerprint(DATASETS[name]) != payload:
        raise AssertionError(f"{name}: payload {payload_fingerprint(DATASETS[name])} is not "
                             f"the JAX band's {payload}")
    out = os.path.join(tmp, f"{name}_h{hidden}_{dtype}_{rnn}_{agg}_wl{wl}_{marker}"
                       + ("_quirk" if quirk else ""))
    argv = ["-data", name, "-pr", root, "-r", str(rounds), "-e", str(PROTOCOL_EPOCHS),
            "-hid", str(hidden), "--dtype", dtype, "--rnn", rnn, "--agg", agg, "-wl", str(wl),
            "-mk", marker,
            "--results-dir", os.path.join(out, "results"),
            "--ckpt-dir", os.path.join(out, "ckpt"), "--resume"] + (["--quirk-compat"]
                                                                    if quirk else [])
    chunks = (1, 1, 1)   # train, validation, test chunks an epoch
    if microbatch is not None:
        argv += ["--microbatch", str(microbatch)]
        masks = load_dataset(name, root, 0)[1:4]
        chunks = tuple(-(-int(m.sum()) // microbatch) for m in masks)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = run.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    epochs = PROTOCOL_EPOCHS * rounds
    say(f"  launches: {counts}")
    fwd = counts["pagg_encode_fwd"]
    ktr, kva, kte = chunks
    walk = walk_kernel(wl)
    idle = ("lane_gather", "membership_dists", "khop_dists",
            *(k for k in WALK_KERNELS if k != walk))
    if not (counts[walk] == epochs and counts["pagg_encode_bwd"] == counts["segment_sum"]
            == counts["row_gather_bwd"] == counts["pagg_contract"] == ktr * epochs
            and counts["row_gather"] == fwd
            and (ktr + kva) * epochs <= fwd <= (ktr + kva + kte) * epochs
            and not any(counts[k] for k in idle)):
        raise AssertionError(f"{name} protocol launch counts {counts}: {epochs} epochs make "
                             f"one {walk} launch each, {ktr} backward launches and "
                             f"{ktr + kva}-{ktr + kva + kte} forwards")
    saved = sorted(glob.glob(os.path.join(out, "ckpt", "*", "round_*", "meta.json")))
    if len(saved) != rounds or not os.path.isfile(
            os.path.join(out, "results", f"result_for_{name}.txt")):
        raise AssertionError(f"{name}: {len(saved)} rounds checkpointed, or no result line")
    if dtype != "float32" and not all(f".{dtype}/" in p for p in saved):
        raise AssertionError(f"{name}: rounds not checkpointed under the .{dtype} key: {saved}")
    if not all(f".{marker}.{rnn}.{agg}" in p for p in saved):
        raise AssertionError(f"{name}: rounds not checkpointed under the "
                             f".{marker}.{rnn}.{agg} key")
    if quirk and not all(".quirk/" in p for p in saved):
        raise AssertionError(f"{name}: rounds not checkpointed under the .quirk key: {saved}")
    accs = []
    for path in saved:
        with open(path) as f:
            accs.append(json.load(f)["metrics"]["accuracy"])
    mean, std = result["accuracy"]
    say(f"  {name}, {rounds} rounds x {PROTOCOL_EPOCHS} epochs at H = {hidden}, {dtype}, "
        f"{rnn}, {agg}, wl = {wl}, -mk {marker}" + (", --quirk-compat" if quirk else "")
        + (f", microbatch {microbatch}" if microbatch else "")
        + f": acc {mean:.4f} +- {std:.4f} ("
        + ("no JAX band" if band is None else f"JAX {band[0]:.4f} +- {band[1]:.4f}")
        + "; rounds " + ", ".join(f"{a:.4f}" for a in accs) + f"); {secs:.1f} s, "
        f"{secs / rounds:.2f} s per round, {secs / epochs * 1e3:.3f} ms per epoch (loading, "
        "MERW and the sampler build included)")
    if band is None:
        if not mean > 1.0 / DATASETS[name].num_classes:
            raise AssertionError(f"{name}: mean accuracy {mean} not above chance")
    elif rounds == 10 and PROTOCOL_EPOCHS == 1000:
        if not abs(mean - band[0]) <= band[1]:
            raise AssertionError(f"{name}: mean accuracy {mean} outside the JAX band {band}")
    elif round_band:
        bad = [a for a in accs if not abs(a - band[0]) <= 3 * band[1]]
        if bad:
            raise AssertionError(f"{name}: rounds {bad} outside 3 std of the JAX band {band}")
    elif not mean > 1.0 / DATASETS[name].num_classes:
        raise AssertionError(f"{name}: mean accuracy {mean} not above chance")
    return counts


def check_homo_kernels(root, dev, gen, rec):
    """Cora at full width (n = 2,708, F = 1,433, H = 64) in the homo
    variant: K3 (with and without the mask), K4 and its three launches,
    ``segment_sum`` and K5 against their homo plain versions on all targets,
    timed; ``predict`` and one training step on the card against the host;
    two seeded rounds bit-equal."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict

    g, train, val, test, spec_d = load_dataset("cora", root, 0)
    ps = PathSampler.build(g, NW, WL, device=dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    y = torch.from_numpy(np.array(g.labels, np.int64))
    C = spec_d.num_classes
    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL, dropout=0.7,
                    variant="homo")
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(5))
    every = torch.arange(g.n, dtype=torch.int32, device=dev)
    u = draw_uniforms(WL, g.n * NW, gen, dev)
    say(f"  cora: n={g.n}, F={X.shape[1]}, C={C}, D={ps.sampler.max_deg}, train / val / test "
        f"{int(train.sum())} / {int(val.sum())} / {int(test.sum())}")
    paths, dists, h, w, m1, keep, agg, gout, bwd_args = check_encode_kernels(
        f"cora homo, all {g.n} targets", ps, model, X, every, u, gen, rec, time_segment=True)
    n, H = h.shape
    out = K.row_gather(h, every)
    dout = torch.randn(out.shape, generator=gen, device=dev)
    d5, d5p = K.row_gather_bwd(dout, every, n), K.row_gather_bwd_plain(dout, every, n)
    err5 = float((d5 - d5p).abs().max())
    if not (torch.equal(out, K.row_gather_plain(h, every))
            and err5 <= K5_BWD_TOL * float(d5p.abs().max())):
        raise AssertionError(f"cora: row_gather differs, or row_gather_bwd err {err5}")
    record_err(rec, "row_gather", 0.0)
    record_err(rec, "row_gather_bwd", err5)
    say(f"  cora ego rows: row_gather exact, row_gather_bwd max abs err {err5:.3e} within "
        f"{K5_BWD_TOL} x max")

    b3 = nbytes(h, paths, dists, agg, *w)
    _, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, gout, w)
    timed(rec, "pagg_encode_fwd homo", lambda: K.pagg_encode_fwd(h, paths, dists, *w, homo=True),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, homo=True), b3, o3, 20)
    timed({"pagg_encode_fwd homo with keep mask": {}}, "pagg_encode_fwd homo with keep mask",
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep, homo=True),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep, homo=True),
          b3 + nbytes(m1), o3, 20)
    time_k3_stages("pagg_encode_fwd homo", h, paths, dists, w, homo=True)
    timed(rec, "pagg_encode_bwd homo", lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 5)
    time_k4_stages("pagg_encode_bwd homo", gout, h, paths, dists, w, m1, keep, homo=True)
    idx_l = every.long()
    timed({"row_gather cora": {}}, "row_gather cora", lambda: K.row_gather(h, every),
          lambda: K.row_gather_plain(h, every), (2 * n * H + n) * 4, 0.0, 50,
          library=lambda: torch.index_select(h, 0, idx_l))
    timed({"row_gather_bwd cora": {}}, "row_gather_bwd cora",
          lambda: K.row_gather_bwd(dout, every, n),
          lambda: K.row_gather_bwd_plain(dout, every, n), (2 * n * H + n) * 4, float(n * H),
          50, library=lambda: torch.zeros((n, H), device=dev).index_add_(0, idx_l, dout),
          kern_graph=lambda: K.row_gather_bwd(dout, every, n, check=False))
    del paths, dists, m1, agg, gout, bwd_args

    # serving and one training step, the card against the host
    ps_host = PathSampler.build(g, NW, WL, device="cpu")
    m_host = PathNet(spec, device="cpu")
    m_host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    K.reset_launch_counts()
    logp = predict(model, X, ps, idx=every, u=u[None])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
        raise AssertionError(f"cora request launch counts {counts}, expected 1 of each "
                             "forward kernel")
    logp_host = predict(m_host, X.cpu(), ps_host, idx=every.cpu(), u=u[None].cpu())
    err = float((logp.cpu() - logp_host).abs().max())
    say(f"  cora predict on the card vs the host (same draws, all {g.n} nodes): max abs err "
        f"{err:.3e}")
    if not torch.isfinite(logp).all() or err > K3_TOL:
        raise AssertionError(f"cora log-probs differ from the host's by {err}")
    idx = torch.from_numpy(np.flatnonzero(train).astype(np.int32))
    step_card_vs_host("cora", spec, dev, (ps, ps_host), (X, X.cpu()), idx, y)
    rounds_bit_equal("cora homo", X, y.to(dev), ps, (train, val, test), C,
                     TrainConfig(epochs=30), spec)


def check_band_kernels(name, root, dev, gen, rec, hidden, dtype="float32"):
    """K3 (without and with the keep mask), K4 with its three launches,
    ``pagg_contract`` and ``segment_sum`` against their plain versions on
    the first ``BGP_MICROBATCH`` train targets of a band's dataset, at the
    band's configuration (its variant, H and dtype, the per-component MERW
    the protocol runs): pubmed's homo instances on a microbatched graph,
    Electronics' bf16 instances at H = 32 (held on the kernel's own
    recompute, with the count of walks whose attention score flips across
    the leaky ReLU printed: ``check_encode_kernels``' ``kink``)."""
    import torch
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.merw import merw_graph_per_component
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    t0 = time.perf_counter()
    g, train, _, _, spec_d = load_dataset(name, root, 0)
    t1 = time.perf_counter()
    if not (g.prob < 1.0).any():
        g = merw_graph_per_component(g, device=dev)
    ps = PathSampler.build(g, NW, WL, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=hidden, out_dim=spec_d.num_classes, walk_len=WL,
                    dropout=0.7, variant="homo" if spec_d.variant == "homo" else "hetero",
                    compute_dtype=dtype)
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(7))
    idx = torch.from_numpy(np.flatnonzero(train)[:BGP_MICROBATCH].astype(np.int32)).to(dev)
    say(f"  {name}: n={g.n}, F={X.shape[1]}, D={ps.sampler.max_deg}, payload made or read in "
        f"{t1 - t0:.1f} s, MERW and the sampler in {t2 - t1:.1f} s; {spec.variant}, H = "
        f"{hidden}, {dtype}, {idx.shape[0]} targets")
    u = draw_uniforms(WL, idx.shape[0] * NW, gen, dev)
    check_encode_kernels(f"{name} microbatch", ps, model, X, idx, u, gen, rec,
                         kink=dtype != "float32")


def check_bf16_kernels(root, dev, gen, rec, X, ps, idx, u, C):
    """bf16 compute: K3's bf16 instance on one 8192-target bgp request, K3
    (with the keep mask) and K4 with each of its three launches on one bgp
    microbatch, and the homo bf16 instances on cora with all 2,708 targets,
    each against its plain version within BF16_TOL of its largest entry;
    timed as phases 2 and 5, each bound at bf16's tensor-core rate with the
    f32 CUDA-core bound beside it."""
    import dataclasses

    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL,
                    compute_dtype="bfloat16")
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0))
    paths, dists = ps.sample(idx, u=u)
    h, w = model.encode_inputs(X)
    agg = K.pagg_encode_fwd(h, paths, dists, *w)
    agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w)
    torch.cuda.synchronize()
    err = float((agg - agg_p).abs().max())
    if not k3_close(agg, agg_p, True):
        raise AssertionError(f"bgp request: pagg_encode_fwd bf16 max abs err {err}")
    record_err(rec, "pagg_encode_fwd bf16", err)
    say(f"  bgp request: pagg_encode_fwd bf16 ({spec.resolved_gather_mode()!r} table) max abs "
        f"err {err:.3e} within {BF16_TOL:.4g} x max {float(agg_p.abs().max()):.3f}")
    S, nw, wl = paths.shape
    b3 = nbytes(h, paths, dists, agg, *w)
    o3 = S * nw * (wl * 18 * HIDDEN * HIDDEN + 6 * HIDDEN)
    timed(rec, "pagg_encode_fwd bf16", lambda: K.pagg_encode_fwd(h, paths, dists, *w),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w), b3, o3, 50, bf16=True)
    rec["pagg_encode_fwd bf16"]["stages"] = time_k3_stages("pagg_encode_fwd bf16", h, paths,
                                                           dists, w)

    model = PathNet(dataclasses.replace(spec, dropout=0.7), device=dev,
                    generator=torch.Generator().manual_seed(0))
    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        "bgp microbatch bf16", ps, model, X, idx, u, gen, rec)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w)
    name = "pagg_encode_fwd bf16 with keep mask"
    timed({name: {}}, name, lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep), b3, o3, 20,
          bf16=True)
    time_k3_stages(name, h, paths, dists, w, (m1, keep))
    timed(rec, "pagg_encode_bwd bf16", lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 5, bf16=True)
    rec["pagg_encode_bwd bf16"]["stages"] = time_k4_stages("pagg_encode_bwd bf16", g, h,
                                                           paths, dists, w, m1, keep)
    del paths, dists, h, w, m1, agg, g, bwd_args

    gc, _, _, _, spec_d = load_dataset("cora", root, 0)
    psc = PathSampler.build(gc, NW, WL, device=dev)
    Xc = torch.from_numpy(np.array(gc.features, np.float32)).to(dev)
    spec = PaggSpec(feat_dim=Xc.shape[1], hidden=HIDDEN, out_dim=spec_d.num_classes,
                    walk_len=WL, dropout=0.7, variant="homo", compute_dtype="bfloat16")
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(5))
    every = torch.arange(gc.n, dtype=torch.int32, device=dev)
    uc = draw_uniforms(WL, gc.n * NW, gen, dev)
    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        f"cora homo bf16, all {gc.n} targets", psc, model, Xc, every, uc, gen, rec)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w)
    timed(rec, "pagg_encode_fwd homo bf16",
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, homo=True),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, homo=True),
          nbytes(h, paths, dists, agg, *w), o3, 20, bf16=True)
    timed(rec, "pagg_encode_bwd homo bf16", lambda: K.pagg_encode_bwd(*bwd_args),
          lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 5, bf16=True)
    time_k4_stages("pagg_encode_bwd homo bf16", g, h, paths, dists, w, m1, keep, homo=True)
    compare_bf16_with_f32(rec)


def compare_bf16_with_f32(rec):
    """The bf16 instances' times beside the f32 instances' at the same
    shapes in this run (phases 2, 5 and 12): K3 and its encode launch at the
    bgp request, K4 and its launches A (the recompute) and C (the BPTT) at
    the bgp microbatch, K3 and K4 homo at cora. The tensor-core products
    must make K3 and launches A and C faster than the f32 CUDA-core ones."""
    pairs = [("K3, bgp request", rec["pagg_encode_fwd"]["ms"],
              rec["pagg_encode_fwd bf16"]["ms"], True),
             ("K3's encode launch, bgp request", rec["pagg_encode_fwd"]["stages"]["encode"],
              rec["pagg_encode_fwd bf16"]["stages"]["encode"], True),
             ("K4, bgp microbatch", rec["pagg_encode_bwd"]["ms"],
              rec["pagg_encode_bwd bf16"]["ms"], False)]
    pairs += [(f"K4's launch {x} ({stage}), bgp microbatch",
               rec["pagg_encode_bwd"]["stages"][stage],
               rec["pagg_encode_bwd bf16"]["stages"][stage],
               stage != "contractions")
              for x, stage in (("A", "recompute"), ("C", "bptt"), ("", "contractions"))]
    pairs += [(f"{k} homo, cora", rec[f"{n} homo"]["ms"], rec[f"{n} homo bf16"]["ms"], False)
              for k, n in (("K3", "pagg_encode_fwd"), ("K4", "pagg_encode_bwd"))]
    for what, f32, bf16, gate in pairs:
        say(f"  {what}: bf16 {bf16:.4f} ms against f32 {f32:.4f} ms ({f32 / bf16:.2f}x)")
        if gate and not bf16 < f32:
            raise AssertionError(f"{what}: the bf16 instance ({bf16:.4f} ms) is not faster "
                                 f"than the f32 one ({f32:.4f} ms)")


def check_tensor_cores():
    """Every BF16 instance of the encode (K3, and K4's recompute) and of
    K4's BPTT multiplies on the tensor cores (HMMA in its SASS); no f32
    instance, the GRU's among them, does."""
    from pathnet_tpu_torch.kernels import build

    for kernel, flag in (("pagg_encode_walks_kernel", 4), ("pagg_bptt_kernel", 3)):
        counts = build.hmma_counts(kernel, flag)   # by the BF16 argument
        if not counts.get(1) or min(counts[1]) == 0 or any(counts.get(0, [])):
            raise AssertionError(f"{kernel}: HMMA a bf16 / f32 instance {counts}")
        say(f"  {kernel}: {len(counts[1])} bf16 instances with {min(counts[1])}-"
            f"{max(counts[1])} HMMA each, {len(counts.get(0, []))} f32 instances with none")


def check_bf16_host(dev, X, ps, z, C, gc, Xc_np, psc, ps_host):
    """bf16 compute on the card against the host: ``predict`` on cornell at
    full width (F = 1,703: the "h" table) over all nodes and on 1024 bgp
    targets (F = 8: the "x" table) with the same draws, each within BF16_TOL
    of the host's largest log-probability; one cornell training step, its
    logits and gradients within BF16_TOL of the host's largest entries."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.splits import ratio_masks
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict

    gb = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
    cases = (("cornell", torch.from_numpy(Xc_np), psc, ps_host, 5,
              torch.arange(gc.n, dtype=torch.int32)),
             ("bgp", X.cpu(), ps, PathSampler.build(gb, NW, WL, device="cpu"), C,
              torch.from_numpy(np.random.default_rng(3).permutation(gb.n)[:1024]
                               .astype(np.int32))))
    for tag, Xh, psd, psh, classes, idx in cases:
        spec = PaggSpec(feat_dim=Xh.shape[1], hidden=HIDDEN, out_dim=classes, walk_len=WL,
                        compute_dtype="bfloat16")
        m = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(6))
        m_host = PathNet(spec, device="cpu")
        m_host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        u = draw_uniforms(WL, idx.shape[0] * NW, torch.Generator().manual_seed(9), "cpu")
        K.reset_launch_counts()
        logp = predict(m, Xh.to(dev), psd, idx=idx.to(dev), u=u[None].to(dev))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
            raise AssertionError(f"{tag} bf16 request launch counts {counts}")
        logp_host = predict(m_host, Xh, psh, idx=idx, u=u[None])
        err = float((logp.cpu() - logp_host).abs().max())
        top = float(logp_host.abs().max())
        say(f"  {tag} bf16 predict ({spec.resolved_gather_mode()!r} table) on the card vs the "
            f"host (same draws, {idx.shape[0]} targets): max abs err {err:.3e}, "
            f"{err / top:.2e} of the largest |log-prob|")
        if not torch.isfinite(logp).all() or err > BF16_TOL * top:
            raise AssertionError(f"{tag} bf16 log-probs differ from the host's by {err}")
    trc = ratio_masks(gc.n, 1000, val_size=59)[0]
    idx7 = torch.from_numpy(np.flatnonzero(trc).astype(np.int32))
    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
    spec7 = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7,
                     compute_dtype="bfloat16")
    step_card_vs_host("cornell bf16", spec7, dev, (psc, ps_host),
                      (torch.from_numpy(Xc_np).to(dev), torch.from_numpy(Xc_np)), idx7, yc,
                      BF16_TOL)


def check_choice_kernels(root, dev, gen, rec, X, ps, idx, u, C):
    """The GRU and the mean and sum readouts: K3's GRU instance on one
    8192-target bgp request; the mean and sum readouts on that request's
    ``h_n`` against their plain versions and ``torch.mean``/``torch.sum``;
    K3 (with and without the keep mask) and K4 with each of its three
    launches, GRU and LSTM-mean, on one bgp microbatch, with the attention
    backward's mean and sum branches alone; the homo GRU instances on cora
    with all 2,708 targets; the bf16 instances under mean (that microbatch)
    and sum (cora, homo). Each against its plain version (the tolerances
    of phases 2 and 5), timed as phase 5 (the bf16 ones untimed)."""
    import dataclasses

    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL, rnn="gru")
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0))
    paths, dists = ps.sample(idx, u=u)
    h, w = model.encode_inputs(X)
    agg = K.pagg_encode_fwd(h, paths, dists, *w, cell="gru")
    agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w, cell="gru")
    torch.cuda.synchronize()
    err = float((agg - agg_p).abs().max())
    if not k3_close(agg, agg_p, False):
        raise AssertionError(f"bgp request: pagg_encode_fwd gru max abs err {err}")
    record_err(rec, "pagg_encode_fwd gru", err)
    say(f"  bgp request: pagg_encode_fwd gru max abs err {err:.3e} within atol = rtol = "
        f"{K3_TOL}")
    S, nw, wl = paths.shape
    H = HIDDEN
    b3 = nbytes(h, paths, dists, agg, *w)
    o3 = S * nw * (wl * 14 * H * H + 6 * H)   # what the GRU needs: 2 + 12 H^2 a step
    timed(rec, "pagg_encode_fwd gru", lambda: K.pagg_encode_fwd(h, paths, dists, *w,
                                                                cell="gru"),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, cell="gru"), b3, o3, 50)
    time_k3_stages("pagg_encode_fwd gru", h, paths, dists, w, cell="gru")

    # the mean and sum readouts of the request's h_n, and the library call
    hn = K.encode_walks(h, paths, dists, *w[:6], cell="gru")
    for red in ("mean", "sum"):
        lib = (lambda: hn.view(S, nw, H).mean(1)) if red == "mean" else (
            lambda: hn.view(S, nw, H).sum(1))
        got = K.readout(h, paths, hn, *w[6:], agg=red)
        want = K.readout_plain(h, paths, hn, *w[6:], agg=red)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_lib = float((got - lib()).abs().max())
        if not (torch.allclose(got, want, atol=1e-5, rtol=1e-5)
                and torch.allclose(got, lib(), atol=1e-5, rtol=1e-5)):
            raise AssertionError(f"bgp request: the {red} readout max abs err {err} "
                                 f"(against torch.{red} {err_lib})")
        record_err(rec, f"pagg_readout {red}", err)
        say(f"  bgp request: the {red} readout max abs err {err:.3e} against its plain "
            f"version, {err_lib:.3e} against torch.{red}, within atol = rtol = 1e-5")
        # h_n read once, the result written once; one add a value (and a division)
        timed(rec, f"pagg_readout {red}", lambda: K.readout(h, paths, hn, *w[6:], agg=red),
              lambda: K.readout_plain(h, paths, hn, *w[6:], agg=red),
              nbytes(hn, got), float(S * nw * H), 50, library=lib)
    del hn, agg, agg_p

    # the training kernels on one microbatch: the GRU, then the LSTM with
    # the mean readout
    model = PathNet(dataclasses.replace(spec, dropout=0.7), device=dev,
                    generator=torch.Generator().manual_seed(0))
    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        "bgp microbatch gru", ps, model, X, idx, u, gen, rec)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w, "gru")
    name = "pagg_encode_fwd gru with keep mask"
    timed({name: {}}, name, lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep,
                                                      cell="gru"),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep, cell="gru"), b3, o3,
          20)
    timed(rec, "pagg_encode_bwd gru", lambda: K.pagg_encode_bwd(*bwd_args, cell="gru"),
          lambda: K.pagg_encode_bwd_plain(*bwd_args, cell="gru"), b4, o4, 5)
    time_k4_stages("pagg_encode_bwd gru", g, h, paths, dists, w, m1, keep, cell="gru")
    del paths, dists, h, w, m1, agg, g, bwd_args
    model = PathNet(dataclasses.replace(spec, dropout=0.7, rnn="lstm", agg="mean"),
                    device=dev, generator=torch.Generator().manual_seed(0))
    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        "bgp microbatch mean", ps, model, X, idx, u, gen, rec)
    hn = K.encode_walks_streams(h, paths, dists, *w[:6], m1, keep)[0]
    T = paths.shape[0]
    for red in ("mean", "sum"):
        got = K.attention_bwd(g, h, paths, hn, *w[6:], agg=red)
        want = K.attention_bwd_plain(g, h, paths, hn, *w[6:], agg=red)
        torch.cuda.synchronize()
        if got[1] is not None or want[1] is not None:
            raise AssertionError(f"bgp microbatch: the {red} attention backward gave the "
                                 "ego rows a gradient")
        got, want = (got[0], *got[2:]), (want[0], *want[2:])
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        # g / nw or g, and exact zeros (torch divides by multiplying with
        # 1 / nw on the card: one rounding apart)
        if not all(torch.allclose(a, b, atol=0.0, rtol=1e-6) for a, b in zip(got, want)):
            raise AssertionError(f"bgp microbatch: the {red} attention backward differs "
                                 f"from its plain version by {err}")
        record_err(rec, f"pagg_attention_bwd {red}", err)
        # the function's bytes: g read once, d h_n written once (a division a
        # value under mean); the library call computes d h_n alone
        lib = (lambda: (g / nw).repeat_interleave(nw, 0)) if red == "mean" else (
            lambda: g.repeat_interleave(nw, 0))
        err_lib = float((got[0] - lib()).abs().max())
        if not torch.allclose(got[0], lib(), atol=0.0, rtol=1e-6):
            raise AssertionError(f"bgp microbatch: the {red} attention backward's d h_n "
                                 f"differs from repeat_interleave by {err_lib}")
        timed(rec, f"pagg_attention_bwd {red}",
              lambda: K.attention_bwd(g, h, paths, hn, *w[6:], agg=red),
              lambda: K.attention_bwd_plain(g, h, paths, hn, *w[6:], agg=red),
              nbytes(g, got[0]), float(T * nw * H) if red == "mean" else 0.0, 20,
              library=lib)
        r = rec[f"pagg_attention_bwd {red}"]
        say(f"  pagg_attention_bwd {red}: {r['ms']:.4f} ms against repeat_interleave's "
            f"{r['library_ms']:.4f} ms ({'at or under' if r['ms'] <= r['library_ms'] else 'over'}"
            " it), d h_n alone written")
    say("  bgp microbatch: the mean and sum attention backward within rtol 1e-6 of their "
        "plain versions and of repeat_interleave, dattw and dattb exact zeros, no dego")
    # K4's whole call under mean and sum (no ego rows: wl rows a walk into
    # the segment sum)
    for red in ("mean", "sum"):
        name = f"pagg_encode_bwd {red}"
        timed({name: {}}, name, lambda: K.pagg_encode_bwd(*bwd_args, agg=red),
              lambda: K.pagg_encode_bwd_plain(*bwd_args, agg=red),
              *encode_bounds(h, paths, dists, m1, agg, g, w)[2:], 5)
    time_k4_stages("pagg_encode_bwd mean", g, h, paths, dists, w, m1, keep, agg="mean")
    del paths, dists, h, w, m1, agg, g, bwd_args, hn
    # the bf16 instances under the mean readout (the sum's: on cora below)
    model = PathNet(dataclasses.replace(spec, dropout=0.7, rnn="lstm", agg="mean",
                                        compute_dtype="bfloat16"),
                    device=dev, generator=torch.Generator().manual_seed(0))
    check_encode_kernels("bgp microbatch mean bf16", ps, model, X, idx, u, gen, rec)

    gc, _, _, _, spec_d = load_dataset("cora", root, 0)
    psc = PathSampler.build(gc, NW, WL, device=dev)
    Xc = torch.from_numpy(np.array(gc.features, np.float32)).to(dev)
    spec = PaggSpec(feat_dim=Xc.shape[1], hidden=HIDDEN, out_dim=spec_d.num_classes,
                    walk_len=WL, dropout=0.7, variant="homo", rnn="gru")
    model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(5))
    every = torch.arange(gc.n, dtype=torch.int32, device=dev)
    uc = draw_uniforms(WL, gc.n * NW, gen, dev)
    paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
        f"cora homo gru, all {gc.n} targets", psc, model, Xc, every, uc, gen, rec,
        time_segment=False)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w, "gru")
    timed(rec, "pagg_encode_fwd gru homo",
          lambda: K.pagg_encode_fwd(h, paths, dists, *w, homo=True, cell="gru"),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, homo=True, cell="gru"),
          nbytes(h, paths, dists, agg, *w), o3, 20)
    timed(rec, "pagg_encode_bwd gru homo",
          lambda: K.pagg_encode_bwd(*bwd_args, cell="gru"),
          lambda: K.pagg_encode_bwd_plain(*bwd_args, cell="gru"), b4, o4, 5)
    time_k4_stages("pagg_encode_bwd gru homo", g, h, paths, dists, w, m1, keep, homo=True,
                   cell="gru")
    del paths, dists, h, w, m1, agg, g, bwd_args
    model = PathNet(dataclasses.replace(spec, rnn="lstm", agg="sum", compute_dtype="bfloat16"),
                    device=dev, generator=torch.Generator().manual_seed(5))
    check_encode_kernels(f"cora homo sum bf16, all {gc.n} targets", psc, model, Xc, every, uc,
                         gen, rec)


def check_choice_host(dev, gc, Xc_np, psc, ps_host):
    """The GRU and the mean readout on the card against the host, cornell
    at full width (F = 1,703): ``predict`` over all nodes with the same
    draws (within K3_TOL), and one training step, its logits and every
    gradient within 1e-4 of the host's largest entry (under mean ``attw``'s
    gradient exactly 0 on both)."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.splits import ratio_masks
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict

    allc = torch.arange(gc.n, dtype=torch.int32)
    trc = ratio_masks(gc.n, 1000, val_size=59)[0]
    idx7 = torch.from_numpy(np.flatnonzero(trc).astype(np.int32))
    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
    Xh = torch.from_numpy(Xc_np)
    for rnn, agg in (("gru", "attention"), ("lstm", "mean")):
        spec = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, rnn=rnn,
                        agg=agg)
        m = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(6))
        m_host = PathNet(spec, device="cpu")
        m_host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        u = draw_uniforms(WL, gc.n * NW, torch.Generator().manual_seed(9), "cpu")
        K.reset_launch_counts()
        logp = predict(m, Xh.to(dev), psc, idx=allc.to(dev), u=u[None].to(dev))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
            raise AssertionError(f"cornell {rnn} {agg} request launch counts {counts}")
        err = float((logp.cpu() - predict(m_host, Xh, ps_host, idx=allc, u=u[None])).abs().max())
        say(f"  cornell {rnn} {agg} predict on the card vs the host (same draws, all {gc.n} "
            f"nodes): max abs err {err:.3e}")
        if not torch.isfinite(logp).all() or err > K3_TOL:
            raise AssertionError(f"cornell {rnn} {agg} log-probs differ from the host's by {err}")
        step_card_vs_host(f"cornell {rnn} {agg}", PaggSpec(
            feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7, rnn=rnn,
            agg=agg), dev, (psc, ps_host), (Xh.to(dev), Xh), idx7, yc)


def check_remaining_kernels(root, dev, gen, rec, X, ps, idx, u, C, gc, Xc, uc, psc):
    """The remaining model choices' instances of K3 and K4 against their plain
    versions (phases 2 and 5's tolerances; the bf16 ones within BF16_TOL):
    the MLP's on one 8192-target bgp request (K3), one bgp microbatch (K3
    without and with the keep mask, K4, its three launches and the segment
    sum; the attention and mean readouts) and cora's 2,708 targets (homo);
    the bf16 GRU's on the same request, microbatch and cora (homo), and the
    bf16 MLP's on that microbatch; the quirk's on cornell's 183 nodes at full
    width (F = 1,703) with the LSTM, the GRU and the MLP. Each recorded
    instance timed as phase 5, its bound at the flops its cell needs
    (``cell_flops``; the bf16 ones at the tensor cores' rate)."""
    import dataclasses

    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL)
    paths, dists = ps.sample(idx, u=u)
    S, nw, wl = paths.shape
    for rnn, dtype in (("mlp", "float32"), ("gru", "bfloat16")):
        bf16 = dtype == "bfloat16"
        name = homo_name("pagg_encode_fwd", False, bf16, rnn)
        model = PathNet(dataclasses.replace(spec, rnn=rnn, compute_dtype=dtype), device=dev,
                        generator=torch.Generator().manual_seed(0))
        h, w = model.encode_inputs(X)
        agg = K.pagg_encode_fwd(h, paths, dists, *w, cell=rnn)
        agg_p = K.pagg_encode_fwd_plain(h, paths, dists, *w, cell=rnn)
        torch.cuda.synchronize()
        err = float((agg - agg_p).abs().max())
        if not k3_close(agg, agg_p, bf16):
            raise AssertionError(f"bgp request: {name} max abs err {err}")
        record_err(rec, name, err)
        say(f"  bgp request: {name} max abs err {err:.3e} within "
            + (f"{BF16_TOL:.4g} x max" if bf16 else f"atol = rtol = {K3_TOL}"))
        o3 = S * nw * (cell_flops(rnn, HIDDEN, wl)[0] + 6 * HIDDEN)
        timed(rec, name, lambda: K.pagg_encode_fwd(h, paths, dists, *w, cell=rnn),
              lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, cell=rnn),
              nbytes(h, paths, dists, agg, *w), o3, 50, bf16=bf16)
        rec[name]["stages"] = time_k3_stages(name, h, paths, dists, w, cell=rnn)
    del paths, dists, h, w, agg, agg_p

    # one training microbatch: the MLP (attention, and the mean readout),
    # the bf16 GRU, the bf16 MLP
    for rnn, dtype, agg_ in (("mlp", "float32", "attention"), ("mlp", "float32", "mean"),
                             ("gru", "bfloat16", "attention"),
                             ("mlp", "bfloat16", "attention")):
        bf16 = dtype == "bfloat16"
        model = PathNet(dataclasses.replace(spec, dropout=0.7, rnn=rnn, compute_dtype=dtype,
                                            agg=agg_),
                        device=dev, generator=torch.Generator().manual_seed(0))
        tag = f"bgp microbatch {rnn}{' ' + agg_ if agg_ != 'attention' else ''}" + (
            " bf16" if bf16 else "")
        paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
            tag, ps, model, X, idx, u, gen, rec, kink=bf16)
        name = homo_name("pagg_encode_bwd", False, bf16, rnn)
        if agg_ == "attention" and name in rec:
            b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w, rnn)
            timed({tag: {}}, tag, lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep,
                                                            cell=rnn),
                  lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep, cell=rnn),
                  b3, o3, 20, bf16=bf16)
            timed(rec, name, lambda: K.pagg_encode_bwd(*bwd_args, cell=rnn),
                  lambda: K.pagg_encode_bwd_plain(*bwd_args, cell=rnn), b4, o4, 5, bf16=bf16)
            rec[name]["stages"] = time_k4_stages(name, g, h, paths, dists, w, m1, keep,
                                                 cell=rnn)
        del paths, dists, h, w, m1, agg, g, bwd_args

    # cora's 2,708 targets, homo: the MLP and the bf16 GRU
    gcora, _, _, _, spec_d = load_dataset("cora", root, 0)
    psk = PathSampler.build(gcora, NW, WL, device=dev)
    Xk = torch.from_numpy(np.array(gcora.features, np.float32)).to(dev)
    every = torch.arange(gcora.n, dtype=torch.int32, device=dev)
    uk = draw_uniforms(WL, gcora.n * NW, gen, dev)
    speck = PaggSpec(feat_dim=Xk.shape[1], hidden=HIDDEN, out_dim=spec_d.num_classes,
                     walk_len=WL, dropout=0.7, variant="homo")
    for rnn, dtype in (("mlp", "float32"), ("gru", "bfloat16")):
        bf16 = dtype == "bfloat16"
        model = PathNet(dataclasses.replace(speck, rnn=rnn, compute_dtype=dtype), device=dev,
                        generator=torch.Generator().manual_seed(5))
        paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
            f"cora homo {rnn}{' bf16' if bf16 else ''}, all {gcora.n} targets", psk, model,
            Xk, every, uk, gen, rec)
        if not bf16:
            b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w, rnn)
            timed(rec, "pagg_encode_fwd mlp homo",
                  lambda: K.pagg_encode_fwd(h, paths, dists, *w, homo=True, cell=rnn),
                  lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, homo=True, cell=rnn),
                  nbytes(h, paths, dists, agg, *w), o3, 20)
            timed(rec, "pagg_encode_bwd mlp homo",
                  lambda: K.pagg_encode_bwd(*bwd_args, cell=rnn),
                  lambda: K.pagg_encode_bwd_plain(*bwd_args, cell=rnn), b4, o4, 5)
        del paths, dists, h, w, m1, agg, g, bwd_args

    # the quirk on cornell's nodes at full width, each cell (one record)
    every = torch.arange(gc.n, dtype=torch.int32, device=dev)
    specq = PaggSpec(feat_dim=Xc.shape[1], hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7,
                     quirk_compat=True)
    for rnn in ("lstm", "gru", "mlp"):
        model = PathNet(dataclasses.replace(specq, rnn=rnn), device=dev,
                        generator=torch.Generator().manual_seed(3))
        paths, dists, h, w, m1, keep, agg, g, bwd_args = check_encode_kernels(
            f"cornell quirk {rnn}, all {gc.n} targets", psc, model, Xc, every, uc, gen, rec)
        if rnn == "lstm":
            b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, g, w)
            timed(rec, "pagg_encode_fwd quirk",
                  lambda: K.pagg_encode_fwd(h, paths, dists, *w, agg="quirk"),
                  lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, agg="quirk"),
                  nbytes(h, paths, dists, agg, *w), o3, 50)
            timed(rec, "pagg_encode_bwd quirk",
                  lambda: K.pagg_encode_bwd(*bwd_args, agg="quirk"),
                  lambda: K.pagg_encode_bwd_plain(*bwd_args, agg="quirk"), b4, o4, 20)
        del paths, dists, h, w, m1, agg, g, bwd_args


def check_remaining_host(dev, gc, Xc_np, psc, ps_host):
    """The MLP, the quirk and the bf16 GRU on the card against the host,
    cornell at full width (F = 1,703): ``predict`` over all nodes with the
    same draws (within K3_TOL; bf16 within BF16_TOL of the largest
    log-probability), and one training step, its logits and every gradient
    within 1e-4 (bf16: BF16_TOL) of the host's largest entry."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.splits import ratio_masks
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict

    allc = torch.arange(gc.n, dtype=torch.int32)
    trc = ratio_masks(gc.n, 1000, val_size=59)[0]
    idx7 = torch.from_numpy(np.flatnonzero(trc).astype(np.int32))
    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
    Xh = torch.from_numpy(Xc_np)
    for tag, kw in (("mlp", dict(rnn="mlp")), ("quirk", dict(quirk_compat=True)),
                    ("gru bf16", dict(rnn="gru", compute_dtype="bfloat16"))):
        spec = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, **kw)
        bf16 = spec.compute_dtype == "bfloat16"
        m = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(6))
        m_host = PathNet(spec, device="cpu")
        m_host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        u = draw_uniforms(WL, gc.n * NW, torch.Generator().manual_seed(9), "cpu")
        K.reset_launch_counts()
        logp = predict(m, Xh.to(dev), psc, idx=allc.to(dev), u=u[None].to(dev))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
            raise AssertionError(f"cornell {tag} request launch counts {counts}")
        want = predict(m_host, Xh, ps_host, idx=allc, u=u[None])
        err = float((logp.cpu() - want).abs().max())
        tol = BF16_TOL * float(want.abs().max()) if bf16 else K3_TOL
        say(f"  cornell {tag} predict on the card vs the host (same draws, all {gc.n} "
            f"nodes): max abs err {err:.3e} within {tol:.3g}")
        if not torch.isfinite(logp).all() or err > tol:
            raise AssertionError(f"cornell {tag} log-probs differ from the host's by {err}")
        step_card_vs_host(f"cornell {tag}", PaggSpec(
            feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7, **kw), dev,
            (psc, ps_host), (Xh.to(dev), Xh), idx7, yc, BF16_TOL if bf16 else 1e-4)


def khop_probes(dists, levels):
    """The row probes of K7's searches on these distances: at each position
    t >= 2 of a walk whose node is not its start, levels 1..d tried (1..t-1
    where d = t, no hit), each a binary search of log2(Dk) + 1 probes."""
    import torch
    wl = dists.shape[2]
    per = [0]
    for t in levels[:max(wl - 2, 0)]:
        per.append(per[-1] + int(np.log2(t.shape[1])) + 1)
    cum = torch.tensor(per, dtype=torch.float64, device=dists.device)
    probes = 0.0
    for t in range(2, wl):
        d = dists[:, :, t].long()
        probes += float(cum[torch.where(d == t, t - 1, d)].sum())
    return probes


def khop_bounds(smp, tables, starts, u, paths, dists):
    """(bytes, ops) of K7 alone and of the fused walk-and-K7 launch: the
    start's rows of the levels the searches read (1..wl-2) once, the walks
    read or drawn, the distances written; K7's probes, and K1's compares (one
    a CDF slot and step) in the fused launch."""
    S, nw, wl = paths.shape
    rows = sum(S * t.shape[1] * 4 for t in tables.levels[:max(wl - 2, 0)])
    probes = khop_probes(dists, tables.levels)
    b7 = nbytes(starts, paths, dists) + rows
    bw = nbytes(smp.nbr, smp.cdf, starts, u, paths, dists) + rows
    return b7, probes, bw, probes + S * nw * (wl - 1) * smp.max_deg


def check_khop(root, dev, gen, rec, floor_ms):
    """Walk length 5: K7 (fused with the walk, and alone) exactly against
    its plain version on every node of cornell, Nba and cora at wl = 4, 5
    and 6 (at 4 also against K2's distances of the same walks), timed at wl
    = 5 as phase 2 times its kernels (cornell's into the record); the dense
    and host backends against khop on the same walks (cornell, Nba); K3 (with
    and without the keep mask), K4 with its three launches and
    ``segment_sum`` at wl = 5 on cornell's and Nba's nodes (hetero, H = 64)
    and cora's 2,708 targets (homo), the tolerances of phase 5, timed as
    phase 5 beside the same targets at wl = 4; ``predict`` and one training
    step at cornell wl = 5 on the card against the host."""
    import dataclasses

    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import KhopTables, PathSampler, build_khop_tables
    from pathnet_tpu_torch.sample.walk import draw_uniforms
    from pathnet_tpu_torch.train import predict

    data = {}
    for name in KHOP_DATASETS:
        g, train, _, _, spec_d = load_dataset(name, root, 0)
        t0 = time.perf_counter()
        tables = KhopTables.pack(build_khop_tables(g, WL5, device=dev))
        secs = time.perf_counter() - t0
        ps = PathSampler.build(g, NW, WL5, device=dev)
        if ps.backend != "khop":
            raise AssertionError(f"{name}: wl = {WL5} built the {ps.backend} backend, not khop")
        smp = ps.sampler
        every = torch.arange(g.n, dtype=torch.int32, device=dev)
        say(f"  {name}: n={g.n}, D={smp.max_deg}, k-hop levels 1-{WL5} widths "
            + " / ".join(str(t.shape[1]) for t in tables.levels)
            + f" ({tables.packed.numel() * 4 / 1e6:.2f} MB, built on the host and moved in "
            f"{secs:.3f} s)")
        for wl in (4, 5, 6):
            u = draw_uniforms(wl, g.n * NW, gen, dev)
            want = K.walk_khop_dists_plain(smp.nbr, smp.cdf, tables, every, u, NW)
            got = K.walk_khop_dists(smp.nbr, smp.cdf, tables, every, u, NW)
            alone = K.khop_dists(tables, every, want[0])
            torch.cuda.synchronize()
            for what, a, b in (("walk_khop_dists paths", got[0], want[0]),
                               ("walk_khop_dists dists", got[1], want[1]),
                               ("khop_dists", alone, want[1])):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} wl = {wl}: {what} differ from the plain "
                                         f"version's in {int((a != b).sum())} entries")
            extra = ""
            if wl == 4:
                k2 = K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, every, u, NW)
                torch.cuda.synchronize()
                if not (torch.equal(k2[0], want[0]) and torch.equal(k2[1], want[1])):
                    raise AssertionError(f"{name} wl = 4: K7's distances differ from K2's")
                extra = ", and equal to walk_dists' K2 distances of the same walks"
            say(f"  {name}, all {g.n} nodes, wl = {wl}: walk_khop_dists (walks and distances) "
                f"and khop_dists exact against their plain versions{extra} (max distance "
                f"{int(want[1].max())})")
        record_err(rec, "khop_dists", 0.0)
        record_err(rec, "walk_khop_dists", 0.0)
        data[name] = (g, train, spec_d, ps, tables, every)

    # K7 timed at wl = 5, every node a start (the training path's grid)
    for name, (g, _, _, ps, tables, every) in data.items():
        smp = ps.sampler
        u = draw_uniforms(WL5, g.n * NW, gen, dev)
        paths, dists = K.walk_khop_dists(smp.nbr, smp.cdf, tables, every, u, NW)
        b7, o7, bw, ow = khop_bounds(smp, tables, every, u, paths, dists)
        own = name == "cornell"
        for kname, kern, plain, b, o in (
                ("khop_dists", lambda: K.khop_dists(tables, every, paths),
                 lambda: K.khop_dists_plain(tables.levels, every, paths), b7, o7),
                ("walk_khop_dists", lambda: K.walk_khop_dists(smp.nbr, smp.cdf, tables, every,
                                                              u, NW),
                 lambda: K.walk_khop_dists_plain(smp.nbr, smp.cdf, tables, every, u, NW), bw,
                 ow)):
            tag = kname if own else f"{kname} {name}"
            timed(rec if own else {tag: {}}, tag, kern, plain, b, o, 50)
        # K7's cost over K2's: both fused launches on the same wl = 4 walks
        u4 = draw_uniforms(WL, g.n * NW, gen, dev)
        k2_ms = graph_ms(lambda: K.walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, every, u4, NW),
                         50)
        k7_ms = graph_ms(lambda: K.walk_khop_dists(smp.nbr, smp.cdf, tables, every, u4, NW), 50)
        say(f"  {name}, wl = 4: walk_dists {k2_ms:.4f} ms, walk_khop_dists {k7_ms:.4f} ms per "
            f"launch in a CUDA graph, the same walks; the launch floor is {floor_ms:.5f} ms "
            "(phase 8)")

    # the dense and host backends: the khop backend's distances on the same walks
    for name in ("cornell", "Nba"):
        g, ps = data[name][0], data[name][3]
        u = draw_uniforms(WL5, g.n * NW, gen, dev)
        want = ps.sample(u=u)
        for backend in ("dense", "host"):
            t0 = time.perf_counter()
            psb = PathSampler.build(g, NW, WL5, distance_backend=backend, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = psb.sample(u=u)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name}: the {backend} backend's walks or distances "
                                     "differ from khop's")
            say(f"  {name}, wl = {WL5}: the {backend} backend ([{g.n}, {g.n}] int8 table "
                f"built in {secs:.3f} s) gives khop's walks and distances exactly")
            del psb

    # K3, K4 and segment_sum at wl = 5 (phase 5's tolerances), timed beside
    # the same targets at wl = 4
    for name, wl in ((n, w) for n in KHOP_DATASETS for w in (WL, WL5)):
        g, _, spec_d, ps, _, every = data[name]
        if wl == WL:
            ps = PathSampler.build(g, NW, WL, device=dev)
        X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
        variant = spec_d.variant
        model = PathNet(PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=spec_d.num_classes,
                                 walk_len=wl, dropout=0.7, variant=variant),
                        device=dev, generator=torch.Generator().manual_seed(15))
        u = draw_uniforms(wl, g.n * NW, gen, dev)
        homo = variant == "homo"
        paths, dists, h, w, m1, keep, agg, gout, bwd_args = check_encode_kernels(
            f"{name} {variant}, wl = {wl}, all {g.n} targets", ps, model, X, every, u, gen, rec,
            time_segment=homo and wl == WL5)
        b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, agg, gout, w)
        name3, name4 = (f"pagg_encode_fwd wl={wl} {name} masked",
                        f"pagg_encode_bwd wl={wl} {name}")
        timed({name3: {}}, name3,
              lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep, homo),
              lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep, homo), b3, o3, 20)
        time_k3_stages(name3, h, paths, dists, w, (m1, keep), homo)
        timed({name4: {}}, name4, lambda: K.pagg_encode_bwd(*bwd_args),
              lambda: K.pagg_encode_bwd_plain(*bwd_args), b4, o4, 10)
        time_k4_stages(name4, gout, h, paths, dists, w, m1, keep, homo)
        del paths, dists, h, w, m1, agg, gout, bwd_args

    # predict and one training step at cornell wl = 5, the card against the host
    g, train, spec_d, ps, _, every = data["cornell"]
    X = torch.from_numpy(np.array(g.features, np.float32))
    y = torch.from_numpy(np.array(g.labels, np.int64))
    C = spec_d.num_classes
    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL5)
    m = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(16))
    m_host = PathNet(spec, device="cpu")
    m_host.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    ps_host = PathSampler.build(g, NW, WL5, device="cpu")
    u = draw_uniforms(WL5, g.n * NW, torch.Generator().manual_seed(17), "cpu")
    K.reset_launch_counts()
    logp = predict(m, X.to(dev), ps, idx=every, u=u[None].to(dev))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if counts != {name: int(name in forward_path(WL5)) for name in KERNELS}:
        raise AssertionError(f"cornell wl = {WL5} request launch counts {counts}")
    err = float((logp.cpu() - predict(m_host, X, ps_host, idx=every.cpu(), u=u[None])).abs().max())
    say(f"  cornell wl = {WL5} predict on the card vs the host (same draws, all {g.n} nodes): "
        f"max abs err {err:.3e}")
    if not torch.isfinite(logp).all() or err > K3_TOL:
        raise AssertionError(f"cornell wl = {WL5} log-probs differ from the host's by {err}")
    idx = torch.from_numpy(np.flatnonzero(train).astype(np.int32))
    step_card_vs_host(f"cornell wl = {WL5}", dataclasses.replace(spec, dropout=0.7), dev,
                      (ps, ps_host), (X.to(dev), X), idx, y, wl=WL5)


def alias_bounds(smp, starts, u, paths, dists=None, extra=()):
    """(bytes, ops) of K8's launch: the alias tables, ``starts`` and ``u``
    read once, the walks (and ``dists``) written once, and the tensors of
    ``extra`` that the fused distances read; K8's three operations a step
    (a product, a clamp, a compare)."""
    S, nw, wl = paths.shape
    b = nbytes(smp.lo, smp.hi, smp.split, smp.deg, starts, u, paths, *extra)
    b += 0 if dists is None else nbytes(dists)
    return b, 3.0 * S * nw * (wl - 1)


def bernstein_tol(visits_p, t):
    """Counts by which a binomial count of variance ``visits_p`` (N p (1 -
    p)) may miss its mean with probability exp(-t) at most (Bernstein)."""
    return t / 3 + (t * t / 9 + 2 * visits_p * t) ** 0.5


def check_alias_frequencies(tag, g, paths):
    """Every transition of ``paths`` against the graph's P, pair of nodes by
    pair: no transition off a record, and each pair's count within
    Bernstein's bound of ``visits x P`` at a failure rate of 1e-6 over all
    pairs (about 7.5 binomial standard errors where a pair has many
    visits)."""
    import torch

    dev = paths.device
    n = g.n
    a = paths[:, :, :-1].reshape(-1).long()
    b = paths[:, :, 1:].reshape(-1).long()
    nbr, prob, deg = g.padded_csr()
    real = np.arange(nbr.shape[1])[None, :] < np.maximum(deg, 1)[:, None]
    rows = np.nonzero(real)[0].astype(np.int64)
    pkeys, inv = np.unique(rows * n + nbr[real], return_inverse=True)
    P = torch.from_numpy(np.bincount(inv, weights=prob[real].astype(np.float64))).to(dev)
    pkeys = torch.from_numpy(pkeys).to(dev)
    keys, counts = torch.unique(a * n + b, return_counts=True)
    pos = torch.searchsorted(pkeys, keys).clamp_(max=len(pkeys) - 1)
    off = int((pkeys[pos] != keys).sum())
    if off:
        raise AssertionError(f"{tag}: {off} node pairs walked that no record joins")
    obs = torch.zeros(len(pkeys), dtype=torch.float64, device=dev)
    obs[pos] = counts.double()
    visits = torch.bincount(a, minlength=n).double()[pkeys // n]
    mean, var = visits * P, visits * P * (1 - P)
    t = float(np.log(2 * len(pkeys) / 1e-6))
    gap = (obs - mean).abs()
    tol = bernstein_tol(var, t)
    se = var.clamp(min=1e-300).sqrt()
    worst = float((gap / tol).max())
    many = visits >= 100
    freq_gap = (float(((obs - mean) / visits).abs()[many].max()) if bool(many.any())
                else float("nan"))
    say(f"  {tag}: {a.numel()} transitions over {len(pkeys)} node pairs, none off a record; "
        f"each pair's count within Bernstein's bound (t = {t:.1f}: {(2 * t) ** 0.5:.2f} "
        f"standard errors and {t / 3:.1f} counts): worst gap {worst:.3f} of its bound, "
        f"{float((gap / se).max()):.2f} standard errors; max |freq - P| over pairs of "
        f"100+ visits {freq_gap:.2e}")
    if worst > 1.0:
        raise AssertionError(f"{tag}: transition counts beyond Bernstein's bound "
                             f"({worst:.3f} of it)")


def check_sampler(root, dev, gen, rec, z, ps, idx, floor_ms):
    """The rest of the sampler: K8 (the alias walk step) in its three
    launches exactly against the plain versions given the same uniforms
    (``alias_walk_dists`` at the bgp request and every cornell node,
    ``alias_walk_khop_dists`` at cornell wl = 5, ``alias_walk`` alone), its
    transition frequencies against P over one bgp epoch; uniform walks
    (``kind="uniform"``): ``walk_dists`` on the symmetrized tables of bgp,
    cornell, Nba and cora against its plain version, K3 and K4 on cornell's
    uniform walks; K8 and the uniform tables timed beside the CDF launches
    on the same starts; a seeded cornell round on alias walks within 3 std
    of the cornell band and two seeded alias rounds bit-equal; 20-epoch
    alias rounds through the dense and khop backends, whose launches are
    ``alias_walk``'s and ``alias_walk_khop_dists``'."""
    import dataclasses

    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.train import run_round

    bg = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"], name="bgp_standin")
    t0 = time.perf_counter()
    psa = PathSampler.build(bg, NW, WL, sampler="alias", device=dev)
    say(f"  bgp alias tables (n={bg.n}, D={psa.sampler.max_deg}) built on the host and moved "
        f"in {time.perf_counter() - t0:.2f} s")
    sa = psa.sampler
    al = (sa.lo, sa.hi, sa.split, sa.deg)
    every = torch.arange(bg.n, dtype=torch.int32, device=dev)

    def exact(tag, got, want):
        torch.cuda.synchronize()
        for what, x, y in zip(("paths", "dists"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"{tag}: {what} differ from the plain version's in "
                                     f"{int((x != y).sum())} entries")

    # K8 exact: the bgp request, and every bgp node (the training grid)
    for tag, starts in (("bgp request", idx), (f"bgp, all {bg.n} nodes", every)):
        ua = psa.draw_uniforms(starts.shape[0] * NW, gen)
        want = K.alias_walk_dists_plain(*al, sa.nbr, sa.srt, starts, ua, NW)
        exact(f"{tag}: alias_walk_dists",
              K.alias_walk_dists(*al, sa.nbr, sa.srt, starts, ua, NW), want)
        exact(f"{tag}: alias_walk", (K.alias_walk(*al, starts, ua, NW),), want)
        say(f"  {tag}: alias_walk_dists and alias_walk exact against their plain versions")
    record_err(rec, "alias_walk_dists", 0.0)
    record_err(rec, "alias_walk", 0.0)

    # K8's transitions over one bgp epoch against P
    check_alias_frequencies("bgp epoch, alias walks (seeded)",
                            bg, psa.sample(generator=gen)[0])

    # cornell: K8 fused with K2 on every node, with K7 at wl = 5
    gc, trc, vac, tec, spec_c = load_dataset("cornell", root, 0)
    allc = torch.arange(gc.n, dtype=torch.int32, device=dev)
    psca = PathSampler.build(gc, NW, WL, sampler="alias", device=dev)
    sc = psca.sampler
    alc = (sc.lo, sc.hi, sc.split, sc.deg)
    uca = psca.draw_uniforms(gc.n * NW, gen)
    exact("cornell alias_walk_dists", K.alias_walk_dists(*alc, sc.nbr, sc.srt, allc, uca, NW),
          K.alias_walk_dists_plain(*alc, sc.nbr, sc.srt, allc, uca, NW))
    psc5 = PathSampler.build(gc, NW, WL5, sampler="alias", device=dev)
    if psc5.backend != "khop":
        raise AssertionError(f"cornell alias wl = {WL5}: the {psc5.backend} backend")
    uc5 = psc5.draw_uniforms(gc.n * NW, gen)
    want5 = K.alias_walk_khop_dists_plain(*alc, psc5.khop, allc, uc5, NW)
    got5 = K.alias_walk_khop_dists(*alc, psc5.khop, allc, uc5, NW)
    exact(f"cornell alias_walk_khop_dists wl = {WL5}", got5, want5)
    exact("cornell alias_walk wl = 5", (K.alias_walk(*alc, allc, uc5, NW),), want5)
    record_err(rec, "alias_walk_khop_dists", 0.0)
    say(f"  cornell, all {gc.n} nodes: alias_walk_dists (wl = {WL}), alias_walk_khop_dists "
        f"and alias_walk (wl = {WL5}) exact against their plain versions")

    # uniform walks: walk_dists on the symmetrized tables against its plain version
    uni = {}
    for name in ("bgp", "cornell", "Nba", "cora"):
        g = bg if name == "bgp" else load_dataset(name, root, 0)[0]
        t0 = time.perf_counter()
        psu = PathSampler.build(g, NW, WL, kind="uniform", device=dev)
        secs = time.perf_counter() - t0
        su = psu.sampler
        D = su.max_deg
        starts = torch.arange(g.n, dtype=torch.int32, device=dev)
        u = psu.draw_uniforms(g.n * NW, gen)
        exact(f"{name} uniform walk_dists",
              K.walk_dists(su.nbr, su.cdf, su.deg, su.srt, starts, u, NW),
              K.walk_dists_plain(su.nbr, su.cdf, su.deg, su.srt, starts, u, NW))
        say(f"  {name} uniform (symmetrized, a self-loop a node): D = {D} "
            f"({1 if D <= 32 else 16 if D <= 512 else 32} lanes a walk), sampler built in "
            f"{secs:.2f} s; walk_dists exact on all {g.n} nodes")
        uni[name] = (g, psu)
    record_err(rec, "walk_dists", 0.0)
    _, psub = uni["bgp"]
    u = psub.draw_uniforms(idx.shape[0] * NW, gen)
    sub = psub.sampler
    exact("bgp uniform request walk_dists",
          K.walk_dists(sub.nbr, sub.cdf, sub.deg, sub.srt, idx, u, NW),
          K.walk_dists_plain(sub.nbr, sub.cdf, sub.deg, sub.srt, idx, u, NW))

    # K3 and K4 on cornell's uniform walks, phase 5's tolerances
    psuc = uni["cornell"][1]
    Xc = torch.from_numpy(np.array(gc.features, np.float32)).to(dev)
    modelc = PathNet(PaggSpec(feat_dim=Xc.shape[1], hidden=HIDDEN, out_dim=spec_c.num_classes,
                              walk_len=WL, dropout=0.7),
                     device=dev, generator=torch.Generator().manual_seed(18))
    check_encode_kernels(f"cornell uniform walks, all {gc.n} targets", psuc, modelc, Xc, allc,
                         psuc.draw_uniforms(gc.n * NW, gen), gen, rec)
    del modelc

    # times: K8 beside the CDF launches on the same starts; the uniform tables
    for tag, psx, psk, starts in (("bgp request", psa, ps, idx),
                                  (f"cornell, all {gc.n} nodes", psca,
                                   PathSampler.build(gc, NW, WL, device=dev), allc)):
        sx, sk = psx.sampler, psk.sampler
        alx = (sx.lo, sx.hi, sx.split, sx.deg)
        ua = psx.draw_uniforms(starts.shape[0] * NW, gen)
        uk = psk.draw_uniforms(starts.shape[0] * NW, gen)
        own = tag == "bgp request"
        pa, da = K.alias_walk_dists(*alx, sx.nbr, sx.srt, starts, ua, NW)
        b, o = alias_bounds(sx, starts, ua, pa, da, (sx.nbr,))
        name = "alias_walk_dists" if own else "alias_walk_dists cornell"
        timed(rec if own else {name: {}}, name,
              lambda: K.alias_walk_dists(*alx, sx.nbr, sx.srt, starts, ua, NW),
              lambda: K.alias_walk_dists_plain(*alx, sx.nbr, sx.srt, starts, ua, NW),
              b, o + k2_ops(sx.deg, starts, pa, da), 50)
        b, o = alias_bounds(sx, starts, ua, pa)
        name = "alias_walk" if own else "alias_walk cornell"
        timed(rec if own else {name: {}}, name,
              lambda: K.alias_walk(*alx, starts, ua, NW),
              lambda: K.alias_walk_plain(*alx, starts, ua, NW), b, o, 50)
        cdf_fused = graph_ms(lambda: K.walk_dists(sk.nbr, sk.cdf, sk.deg, sk.srt, starts, uk,
                                                  NW), 50)
        cdf_walk = graph_ms(lambda: K.cdf_walk(sk.nbr, sk.cdf, starts, uk, NW), 50)
        say(f"  {tag}, the CDF tables on the same starts (D = {sk.max_deg}): walk_dists "
            f"{cdf_fused:.4f} ms, cdf_walk {cdf_walk:.4f} ms per launch in a CUDA graph; the "
            f"launch floor is {floor_ms:.5f} ms (phase 8)")
    # K8 with K7 at cornell wl = 5, every node, beside K1 with K7
    b, o = alias_bounds(sc, allc, uc5, got5[0], got5[1])
    rows = sum(gc.n * t.shape[1] * 4 for t in psc5.khop.levels[:WL5 - 2])
    timed(rec, "alias_walk_khop_dists",
          lambda: K.alias_walk_khop_dists(*alc, psc5.khop, allc, uc5, NW),
          lambda: K.alias_walk_khop_dists_plain(*alc, psc5.khop, allc, uc5, NW),
          b + rows, o + khop_probes(got5[1], psc5.khop.levels), 50)
    psc5c = PathSampler.build(gc, NW, WL5, device=dev)
    s5 = psc5c.sampler
    u5 = psc5c.draw_uniforms(gc.n * NW, gen)
    say(f"  cornell wl = {WL5}, the CDF tables on the same starts: walk_khop_dists "
        f"{graph_ms(lambda: K.walk_khop_dists(s5.nbr, s5.cdf, psc5c.khop, allc, u5, NW), 50):.4f}"
        " ms per launch in a CUDA graph")
    for name, starts in (("bgp", idx), ("Nba", None)):
        g, psu = uni[name]
        su = psu.sampler
        starts = torch.arange(g.n, dtype=torch.int32, device=dev) if starts is None else starts
        u = psu.draw_uniforms(starts.shape[0] * NW, gen)
        p, d = K.walk_dists(su.nbr, su.cdf, su.deg, su.srt, starts, u, NW)
        b = nbytes(su.nbr, su.cdf, su.deg, starts, u, p, d)
        o = starts.shape[0] * NW * (WL - 1) * su.max_deg + k2_ops(su.deg, starts, p, d)
        tag = f"walk_dists uniform {name}" + (" request" if name == "bgp" else ", all nodes")
        timed({tag: {}}, tag, lambda: K.walk_dists(su.nbr, su.cdf, su.deg, su.srt, starts, u,
                                                   NW),
              lambda: K.walk_dists_plain(su.nbr, su.cdf, su.deg, su.srt, starts, u, NW), b, o,
              50)

    # a seeded cornell round on alias walks (the full 1000 epochs), within 3
    # std of the cornell band; two seeded alias rounds bit-equal
    yc = torch.from_numpy(np.array(gc.labels, np.int64)).to(dev)
    spec = PaggSpec(feat_dim=Xc.shape[1], hidden=HIDDEN, out_dim=spec_c.num_classes,
                    walk_len=WL, dropout=0.7)
    masks = (trc, vac, tec)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    epochs = PROTOCOL_EPOCHS
    res = run_round(Xc, yc, psca, spec, TrainConfig(epochs=epochs), *masks,
                    spec_c.num_classes, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    if counts["alias_walk_dists"] != epochs or any(
            counts[k] for k in ("walk_dists", "cdf_walk", "alias_walk", "walk_khop_dists",
                                "alias_walk_khop_dists")):
        raise AssertionError(f"cornell alias round launch counts {counts}")
    rec["alias_walk_dists"]["launches"] = counts["alias_walk_dists"]
    acc = res.metrics["accuracy"]
    say(f"  cornell, one round of {epochs} epochs on alias walks (seed 0): test acc "
        f"{acc:.4f} (JAX band {CORNELL_BAND[0]:.4f} +- {CORNELL_BAND[1]:.4f}), "
        f"{secs:.1f} s, {secs / epochs * 1e3:.3f} ms per epoch; launches {counts}")
    if not abs(acc - CORNELL_BAND[0]) <= 3 * CORNELL_BAND[1]:
        raise AssertionError(f"cornell alias round accuracy {acc} outside 3 std of "
                             f"{CORNELL_BAND}")
    rounds_bit_equal("cornell alias walks", Xc, yc, psca, masks, spec_c.num_classes,
                     TrainConfig(epochs=30), spec)
    # the alias walks' other launches: short rounds through the dense
    # backend (the walks alone, then a table lookup) and at wl = 5 (khop)
    for kname, psx, wl in (("alias_walk", PathSampler.build(gc, NW, WL, sampler="alias",
                                                            distance_backend="dense",
                                                            device=dev), WL),
                           ("alias_walk_khop_dists", psc5, WL5)):
        K.reset_launch_counts()
        res = run_round(Xc, yc, psx, dataclasses.replace(spec, walk_len=wl),
                        TrainConfig(epochs=ALIAS_SHORT_EPOCHS), *masks, spec_c.num_classes,
                        seed=1)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        walks = {k: counts[k] for k in ("cdf_walk", "walk_dists", "walk_khop_dists",
                                        "alias_walk", "alias_walk_dists",
                                        "alias_walk_khop_dists")}
        if walks != {k: ALIAS_SHORT_EPOCHS * (k == kname) for k in walks}:
            raise AssertionError(f"cornell alias {psx.backend} round launch counts {counts}")
        if not np.isfinite(res.best_val_acc):
            raise AssertionError(f"cornell alias {psx.backend} round: no finite accuracy")
        rec[kname]["launches"] = counts[kname]
        say(f"  cornell alias walks, {psx.backend} backend at wl = {wl}, "
            f"{ALIAS_SHORT_EPOCHS} epochs: {kname} {counts[kname]} launches, test acc "
            f"{res.metrics['accuracy']:.4f}")


def run_baseline_cli(name, model, root, tmp, rounds, hidden, band, payload=None,
                     round_band=False, dtype="float32"):
    """A baseline protocol through the CLI (``--model model``, ``--dtype
    dtype``) on the card with temporary results and checkpoint directories:
    its launches (``BASELINE_LAUNCHES`` an epoch, LP's a round, nothing of
    PathNet's), its rounds checkpointed under the JAX CLI's key and its
    result line; the accuracy gated on ``band`` as :func:`run_protocol_cli`
    gates it (``band`` None: no gate but a finite accuracy). Returns the
    launch counts."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch import run
    from pathnet_tpu_torch.data.registry import DATASETS, payload_fingerprint

    fp = payload_fingerprint(DATASETS[name])
    if payload is not None and fp != payload:
        raise AssertionError(f"{name}: payload {fp} is not the JAX band's {payload}")
    out = os.path.join(tmp, f"{name}_{model}_h{hidden}_{dtype}")
    argv = ["-data", name, "-pr", root, "-r", str(rounds), "-e", str(PROTOCOL_EPOCHS),
            "-hid", str(hidden), "--model", model, "--results-dir", os.path.join(out, "results"),
            "--ckpt-dir", os.path.join(out, "ckpt"), "--resume", "--dtype", dtype]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    result = run.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    epochs = PROTOCOL_EPOCHS * rounds
    expect = {k: 0 for k in KERNELS}
    expect.update({k: v * (rounds if model == "lp" else epochs)
                   for k, v in BASELINE_LAUNCHES[model].items()})
    say(f"  launches: { {k: counts[k] for k in BASELINE_KERNELS} }")
    if counts != expect:
        raise AssertionError(f"{name} --model {model} launch counts {counts}, the path makes "
                             f"{expect}")
    key = (f"{name}.{model}.{fp}.e{PROTOCOL_EPOCHS}.h{hidden}.s0.dr0.7"
           + ("" if dtype == "float32" else f".{dtype}"))
    saved = sorted(glob.glob(os.path.join(out, "ckpt", key, "round_*", "meta.json")))
    text_path = os.path.join(out, "results", f"result_for_{name}.txt")
    if len(saved) != rounds or f"{model} Avg for {name}" not in open(text_path).read():
        raise AssertionError(f"{name} --model {model}: {len(saved)} rounds checkpointed under "
                             f"{key}, or no result line")
    accs = []
    for path in saved:
        with open(path) as f:
            accs.append(json.load(f)["metrics"]["accuracy"])
    mean, std = result["accuracy"]
    say(f"  {name} --model {model} --dtype {dtype}, {rounds} rounds x {PROTOCOL_EPOCHS} epochs "
        f"at H = {hidden}: "
        f"acc {mean:.4f} +- {std:.4f} ("
        + ("no band" if band is None else f"JAX {band[0]:.4f} +- {band[1]:.4f}")
        + "; rounds " + ", ".join(f"{a:.4f}" for a in accs) + f"); {secs:.1f} s, "
        f"{secs / epochs * 1e3:.3f} ms per epoch (loading and graph build included)")
    if not np.isfinite(mean):
        raise AssertionError(f"{name} --model {model}: accuracy {mean}")
    if band is None:
        pass
    elif rounds == 10 and PROTOCOL_EPOCHS == 1000:
        if not abs(mean - band[0]) <= band[1]:
            raise AssertionError(f"{name} --model {model}: mean accuracy {mean} outside the "
                                 f"JAX band {band}")
    elif round_band:
        bad = [a for a in accs if not abs(a - band[0]) <= 3 * band[1]]
        if bad:
            raise AssertionError(f"{name} --model {model}: rounds {bad} outside 3 std of the "
                                 f"JAX band {band}")
    elif not mean > 1.0 / DATASETS[name].num_classes:
        raise AssertionError(f"{name} --model {model}: mean accuracy {mean} not above chance")
    return counts


def heads_coo(ptr, col, w, n):
    """An ``[heads, n, n]`` sparse COO tensor whose head ``k`` holds the CSR
    pattern ``ptr``/``col`` with the values ``w[:, k]`` (``w [E, heads]``
    in CSR order)."""
    import torch

    E, heads = w.shape
    rows = torch.repeat_interleave(torch.arange(n, device=w.device),
                                   (ptr[1:] - ptr[:-1]).long())
    idx = torch.stack([torch.arange(heads, device=w.device).repeat_interleave(E),
                       rows.repeat(heads), col.long().repeat(heads)])
    return torch.sparse_coo_tensor(idx, w.t().reshape(-1), (heads, n, n)).coalesce()


def same_function(tag, got, want, tol=BASELINE_TOL):
    """A library yardstick's result against the kernel's, within ``tol`` of
    the kernel's largest entry: the yardstick computes the same function."""
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol * float(want.float().abs().max()):
        raise AssertionError(f"{tag}: the library yardstick differs from the kernel by {err}")


class InstanceCounts:
    """Launches of S1-S4 by instance: the library's four C entries wrapped
    to count each call by its type argument (``BASELINE_BF16_INSTANCES``;
    the f32 instances under their wrappers' names). Each call is one
    launch of the wrapper, which counts it too."""

    def __init__(self):
        from pathnet_tpu_torch.kernels import build

        self.lib, self.orig, self.counts = build.library(), {}, {}
        for entry, i in INSTANCE_ARG.items():
            f = getattr(self.lib, entry)
            self.orig[entry] = f

            def counted(*args, _f=f, _entry=entry, _i=i):
                key = (_entry, int(args[_i]))
                self.counts[key] = self.counts.get(key, 0) + 1
                return _f(*args)
            setattr(self.lib, entry, counted)

    def reset(self):
        self.counts.clear()

    def by_name(self) -> dict:
        return {BASELINE_BF16_INSTANCES.get(k, f"{k[0]} {k[1]}"): v
                for k, v in self.counts.items()}

    def close(self):
        for entry, f in self.orig.items():
            setattr(self.lib, entry, f)


def try_library(tag, fn, notes):
    """``fn`` if one call of it runs, else None, its refusal in ``notes``."""
    import torch
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError, TypeError) as e:
        why = f"library n/a: {str(e).splitlines()[0][:160]}"
        notes[tag] = "; ".join(filter(None, (notes.get(tag), why)))
        say(f"  {tag}: no library yardstick ({why})")
        return None


def check_bf16_baseline_kernels(z, dev, gen, rec, notes):
    """The bf16 instances of S1-S4 against their plain versions on the
    host, on the bgp stand-in's baseline graphs at the shapes the bf16 GCN,
    GAT and FAGCN give them (F = 64, 8 heads x 64, 8 heads): bit-equal where
    the sum is bf16 and rounded after each add (S1 into bf16, S2 of bf16),
    an f32 output within ``BASELINE_TOL`` of the plain version's largest
    entry, S3 within a bf16 ulp of each entry, S4 within one of its largest;
    two calls bit-equal; each timed per launch in a CUDA graph beside its
    f32 instance on the same shapes (``f32_ms``), with its byte bound and,
    where one call exists and captures, ``torch.sparse.mm`` on a bf16 CSR
    (the weights rounded to bf16) or its kin as a yardstick, held within
    ``BF16_SUM_ULPS`` bf16 ulps of the kernel's largest entry."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.models.baselines import EdgeGraph

    B = torch.bfloat16
    cpu = torch.device("cpu")
    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
    sym = EdgeGraph.from_graph(g, "sym", True, device=dev)
    raw = EdgeGraph.from_graph(g, "none", True, device=dev)
    n, E = g.n, raw.num_edges
    csr_bytes = (n + 1 + 2 * E) * 4
    h64 = torch.randn((n, 64), generator=gen, device=dev)
    g64 = torch.randn((n, 64), generator=gen, device=dev)
    h512 = torch.randn((n, 512), generator=gen, device=dev)
    g512 = torch.randn((n, 512), generator=gen, device=dev)
    w8 = torch.rand((E, 8), generator=gen, device=dev)
    rows8 = torch.randn((E, 8), generator=gen, device=dev)
    s8 = 3 * torch.randn((E, 8), generator=gen, device=dev)
    da8 = torch.randn((E, 8), generator=gen, device=dev)
    sw = sym.w[:, None].contiguous()
    D = lambda eg: (eg.dst_ptr, eg.dst_perm, eg.dst_col)   # noqa: E731
    S = lambda eg: (eg.src_ptr, eg.src_perm, eg.src_col)   # noqa: E731
    ulp16 = 2.0 ** -8

    def held(tag, kern, plain, args, kw, how):
        got, again = kern(*args, **kw), kern(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*[a.to(cpu) if isinstance(a, torch.Tensor) else a for a in args], **kw)
        got, again = got.to(cpu), again.to(cpu)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != want.dtype or not torch.equal(got, again):
            raise AssertionError(f"{tag}: dtype {got.dtype} (plain {want.dtype}), or two calls "
                                 "differ")
        if how == "bits":
            ok = torch.equal(got, want)
        elif how == "ulp":   # each entry within a bf16 ulp of its own
            w = want.float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
            ok = bool(((got.float() - w).abs() <= ulp).all())
        else:                # within ``how`` of the largest entry
            ok = err <= how * float(want.float().abs().max())
        if not ok:
            raise AssertionError(f"{tag}: max abs err {err} against the plain version ({how})")
        record_err(rec, tag, err)
        say(f"  {tag}: max abs err {err:.3e} against the plain version on the host "
            f"({'bit-equal' if how == 'bits' else how}), two calls bit-equal")

    def bf16_csr(ptr, col, vals, shape):
        return torch.sparse_csr_tensor(ptr, col, vals.to(B), size=shape)

    cases = []
    # GCN's first layer: bf16 rows, the graph's f32 weights, f32 out; its
    # input gradient: f32 terms into a bf16 per-add sum (source CSR)
    mat = bf16_csr(sym.dst_ptr, sym.dst_col, sym.w[sym.dst_perm.long()], (n, n))
    matT = bf16_csr(sym.src_ptr, sym.src_col, sym.w[sym.src_perm.long()], (n, n))
    h64b = h64.to(B)
    cases.append(("spmm bf16 rows", K.spmm, K.spmm_plain, (h64b, sw) + D(sym), {},
                  BASELINE_TOL, (h64, sw) + D(sym),
                  nbytes(h64b, sw) + csr_bytes + n * 64 * 4, 2.0 * sym.num_edges * 64,
                  (lambda m, x: lambda: torch.sparse.mm(m, x))(mat, h64b)))
    g64b = g64.to(B)
    cases.append(("spmm bf16 sum", K.spmm, K.spmm_plain, (g64, sw) + S(sym), {"out_dtype": B},
                  "bits", (g64, sw) + S(sym),
                  nbytes(g64, sw) + csr_bytes + n * 64 * 2, 2.0 * sym.num_edges * 64,
                  (lambda m, x: lambda: torch.sparse.mm(m, x))(matT, g64b)))
    # GAT at 8 heads x 64: all bf16, and its score gathers' VJP
    h512b, w8b = h512.to(B), w8.to(B)
    hm = h512b.view(n, 8, 64).transpose(0, 1).contiguous()
    coo8 = heads_coo(raw.dst_ptr, raw.dst_col, w8b[raw.dst_perm.long()], n)
    cases.append(("spmm bf16", K.spmm, K.spmm_plain, (h512b, w8b) + D(raw), {}, "bits",
                  (h512, w8) + D(raw), nbytes(h512b, w8b) + csr_bytes + n * 512 * 2,
                  2.0 * E * 512, (lambda m, x: lambda: torch.bmm(m, x))(coo8, hm)))
    rows8b = rows8.to(B)
    ones = bf16_csr(raw.src_ptr, raw.src_perm, torch.ones(E, device=dev), (n, E))
    cases.append(("spmm bf16 gather", K.spmm, K.spmm_plain,
                  (rows8b, None, raw.src_ptr, raw.src_perm, raw.src_perm), {}, "bits",
                  (rows8, None, raw.src_ptr, raw.src_perm, raw.src_perm),
                  nbytes(rows8b) + (n + 1 + E) * 4 + n * 8 * 2, 1.0 * E * 8,
                  (lambda m, x: lambda: torch.sparse.mm(m, x))(ones, rows8b)))
    g512b = g512.to(B)
    gm = g512b.view(n, 8, 64).transpose(0, 1).contiguous()
    hT = h512b.view(n, 8, 64).permute(1, 2, 0).contiguous()
    pattern = torch.sparse_csr_tensor(raw.dst_ptr.repeat(8, 1), raw.dst_col.repeat(8, 1),
                                      torch.zeros((8, E), device=dev, dtype=B), size=(8, n, n))
    cases.append(("edge_dot bf16", K.edge_dot, K.edge_dot_plain,
                  (g512b, h512b, raw.src, raw.dst, 8), {}, "bits",
                  (g512, h512, raw.src, raw.dst, 8),
                  nbytes(g512b, h512b, raw.src, raw.dst) + E * 8 * 2, 2.0 * E * 512,
                  lambda: torch.sparse.sampled_addmm(pattern, gm, hT, beta=0.0)))
    # FAGCN's weight gradient: f32 g, bf16 h, f32 dot
    cases.append(("edge_dot bf16 rows", K.edge_dot, K.edge_dot_plain,
                  (g64, h64b, sym.src, sym.dst, 1), {}, BASELINE_TOL,
                  (g64, h64, sym.src, sym.dst, 1),
                  nbytes(g64, h64b, sym.src, sym.dst) + sym.num_edges * 4,
                  2.0 * sym.num_edges * 64, None))
    s8b, da8b = s8.to(B), da8.to(B)
    coos = torch.sparse_coo_tensor(
        torch.stack([torch.arange(8, device=dev).repeat_interleave(E), raw.dst.long().repeat(8),
                     raw.src.long().repeat(8)]), s8b.t().reshape(-1), (8, n, n)).coalesce()
    cases.append(("segment_softmax bf16", K.segment_softmax, K.segment_softmax_plain,
                  (s8b, raw.dst_ptr, raw.dst_perm), {}, "ulp", (s8, raw.dst_ptr, raw.dst_perm),
                  2 * E * 8 * 2 + (n + 1 + E) * 4, 5.0 * E * 8,
                  lambda: torch.sparse.softmax(coos, 2)))
    a8b = K.segment_softmax(s8b, raw.dst_ptr, raw.dst_perm)
    a8 = K.segment_softmax(s8, raw.dst_ptr, raw.dst_perm)
    cases.append(("segment_softmax_bwd bf16", K.segment_softmax_bwd,
                  K.segment_softmax_bwd_plain, (a8b, da8b, raw.dst_ptr, raw.dst_perm), {},
                  ulp16, (a8, da8, raw.dst_ptr, raw.dst_perm),
                  3 * E * 8 * 2 + (n + 1 + E) * 4, 4.0 * E * 8, None))
    for tag, kern, plain, args, kw, how, f32_args, b, o, library in cases:
        held(tag, kern, plain, args, kw, how)
        if library is not None:
            library = try_library(tag, library, notes)
        if library is not None:
            want = kern(*args, **kw)
            if tag == "spmm bf16":
                want = want.view(n, 8, 64).transpose(0, 1)
            got = library()
            got = got.values() if got.is_sparse_csr else got
            if tag == "edge_dot bf16":
                want = want[raw.dst_perm.long()].t()
            if tag != "segment_softmax bf16":   # a sparse result in its own layout
                same_function(tag, got, want, BF16_SUM_ULPS * ulp16)
        f32_ms = graph_ms((lambda a: lambda: kern(*a))(f32_args), 50)
        timed(rec, tag, (lambda a, k: lambda: kern(*a, **k))(args, kw),
              (lambda a, k: lambda: plain(*a, **k))(args, kw), b, o, library=library)
        rec[tag]["f32_ms"] = f32_ms
        say(f"  {tag}: the f32 instance on the same shapes {f32_ms:.4f} ms per launch in a "
            "CUDA graph")
    del h64, g64, h512, g512, w8, rows8, s8, da8, coo8, coos, hm, gm, hT, pattern, mat, matT


def check_baseline_kernels(z, dev, gen, rec):
    """S1-S4 against their plain versions on the bgp stand-in's baseline
    graphs (``sym`` and ``raw``, with self-loops): S1 on both CSR orders at
    F = 8 (X), F = 64 and 8 heads x 64, S2 at 8 heads x 64, S3 and S4 at 8
    heads; within ``BASELINE_TOL`` of the plain version's largest entry (S3
    ``SOFTMAX_TOL``), two calls bit-equal; timed as phase 2 times its
    kernels, with a library yardstick where one torch call computes the
    same function: ``torch.sparse.mm`` on the CSR for one head,
    ``torch.bmm`` of an ``[8, n, n]`` COO at 8 heads,
    ``torch.sparse.sampled_addmm`` on an ``[8, n, n]`` CSR for S2 and
    ``torch.sparse.softmax`` for S3 (S4 has none)."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.models.baselines import EdgeGraph

    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"])
    t0 = time.perf_counter()
    sym = EdgeGraph.from_graph(g, "sym", True, device=dev)
    raw = EdgeGraph.from_graph(g, "none", True, device=dev)
    n, E = g.n, sym.num_edges
    say(f"  bgp stand-in baseline graphs: n = {n}, {E} edges with self-loops (sym), "
        f"{raw.num_edges} (raw); both built in {time.perf_counter() - t0:.2f} s")
    csr_bytes = (n + 1 + 2 * E) * 4
    h64 = torch.randn((n, 64), generator=gen, device=dev)
    h512 = torch.randn((n, 512), generator=gen, device=dev)
    g512 = torch.randn((n, 512), generator=gen, device=dev)
    w8 = torch.rand((E, 8), generator=gen, device=dev)
    X = torch.from_numpy(z["x"]).to(dev)

    def held(tag, kern, plain, args, tol, rel=True):
        got, again = kern(*args), kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        limit = tol * float(want.abs().max()) if rel else tol
        if not err <= limit:
            raise AssertionError(f"{tag}: max abs err {err} against the plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        record_err(rec, kern.__name__, err)
        say(f"  {tag}: max abs err {err:.3e} (limit {limit:.3e}), two calls bit-equal")
        return got

    for tag, eg, h, w in (("F = 8 (X)", sym, X, sym.w[:, None]), ("F = 64", sym, h64, sym.w[:, None]),
                          ("8 heads x 64", raw, h512, w8)):
        F_ = h.shape[1]
        w = w.contiguous()
        for side in ("forward", "transpose"):
            csr = ((eg.dst_ptr, eg.dst_perm, eg.dst_col) if side == "forward"
                   else (eg.src_ptr, eg.src_perm, eg.src_col))
            args = (h, w) + csr
            held(f"spmm {side}, {tag}", K.spmm, K.spmm_plain, args, BASELINE_TOL)
            if side == "transpose" and F_ != 64:
                continue
            name = "spmm" if (side, F_) == ("forward", 64) else f"spmm {side}, {tag}"
            ptr, perm, col = csr
            if w.shape[1] == 1:
                mat = torch.sparse_csr_tensor(ptr, col, w[perm.long(), 0], size=(n, n))
                library = (lambda m, x: lambda: torch.sparse.mm(m, x))(mat, h)
            else:
                # one batched sparse product, the heads as its batch: an
                # [8, n, n] COO of each head's edge weights times h head-major
                heads = w.shape[1]
                hm = h.view(n, heads, F_ // heads).transpose(0, 1).contiguous()
                mat = heads_coo(ptr, col, w[perm.long()], n)
                want = K.spmm(*args).view(n, heads, F_ // heads).transpose(0, 1)
                library = (lambda m, x: lambda: torch.bmm(m, x))(mat, hm)
                same_function(f"spmm {side}, {tag}", library(), want)
            timed(rec if name == "spmm" else {name: {}}, name,
                  (lambda a: lambda: K.spmm(*a))(args), (lambda a: lambda: K.spmm_plain(*a))(args),
                  nbytes(h, w) + csr_bytes + n * F_ * 4, 2.0 * E * F_, library=library)
    args = (g512, h512, raw.src, raw.dst, 8)
    dw = held("edge_dot, 8 heads x 64", K.edge_dot, K.edge_dot_plain, args, BASELINE_TOL)
    # cuSPARSE's sampled product on the destination CSR, the heads as its
    # batch: <g[dst], h[src]> per edge and head, in CSR order
    gm = g512.view(n, 8, 64).transpose(0, 1).contiguous()
    hT = h512.view(n, 8, 64).permute(1, 2, 0).contiguous()
    pattern = torch.sparse_csr_tensor(raw.dst_ptr.repeat(8, 1), raw.dst_col.repeat(8, 1),
                                      torch.zeros((8, E), device=dev), size=(8, n, n))
    sddmm = lambda: torch.sparse.sampled_addmm(pattern, gm, hT, beta=0.0)
    same_function("edge_dot", sddmm().values(), dw[raw.dst_perm.long()].t())
    timed(rec, "edge_dot", lambda: K.edge_dot(*args), lambda: K.edge_dot_plain(*args),
          nbytes(g512, h512, raw.src, raw.dst) + E * 8 * 4, 2.0 * E * 512, library=sddmm)
    s = 3 * torch.randn((E, 8), generator=gen, device=dev)
    sargs = (s, raw.dst_ptr, raw.dst_perm)
    a = held("segment_softmax, 8 heads", K.segment_softmax, K.segment_softmax_plain, sargs,
             SOFTMAX_TOL, rel=False)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.arange(8, device=dev).repeat_interleave(E), raw.dst.long().repeat(8),
                     raw.src.long().repeat(8)]), s.t().reshape(-1), (8, n, n)).coalesce()
    timed(rec, "segment_softmax", lambda: K.segment_softmax(*sargs),
          lambda: K.segment_softmax_plain(*sargs), 2 * E * 8 * 4 + (n + 1 + E) * 4, 5.0 * E * 8,
          library=lambda: torch.sparse.softmax(coo, 2))
    da = torch.randn((E, 8), generator=gen, device=dev)
    bargs = (a, da, raw.dst_ptr, raw.dst_perm)
    held("segment_softmax_bwd, 8 heads", K.segment_softmax_bwd, K.segment_softmax_bwd_plain,
         bargs, BASELINE_TOL)
    timed(rec, "segment_softmax_bwd", lambda: K.segment_softmax_bwd(*bargs),
          lambda: K.segment_softmax_bwd_plain(*bargs), 3 * E * 8 * 4 + (n + 1 + E) * 4,
          4.0 * E * 8)
    del h64, h512, g512, w8, coo, gm, hT, pattern


BN_FED_BIAS = re.compile(r"(?:lins|lin_l|lin_r|mlps|hop_lins)\.(\d+)\.(?:l2\.|\d+\.)?bias")


def feeds_batch_norm(key, params):
    """Whether ``key`` is the bias of a linear whose output the batch norm
    ``bns.<i>`` of its layer normalizes (``params``: the model's parameter
    names): the hidden linears of mlp, gcn, gat, gatjk, sage, gcnjk and
    mixhop, and gin's ``l2``. Output layers, gin's ``l1`` and the models
    without a batch norm do not."""
    m = BN_FED_BIAS.fullmatch(key)
    return m is not None and f"bns.{m.group(1)}.scale" in params


def check_baselines_host(dev, gc, Xc_np, tol=1e-4, dtype="float32"):
    """Every model of the zoo at cornell's full width (F = 1,703, H = 64, 8
    GAT heads; ``compute_dtype=dtype``) on the card against the host from
    the same weights and dropout masks: the eval forward, then one training
    forward's loss, its logits, every gradient and the running statistics
    within ``tol`` of the host's largest entry (f32: phase 7's; the bias of
    a linear that feeds a batch norm within ``tol`` of its weight
    gradient's largest entry too, :func:`feeds_batch_norm`); at f32 also
    ``label_propagation`` and ``correct_and_smooth`` within 1e-5."""
    import torch
    from pathnet_tpu_torch.data.splits import ratio_masks
    from pathnet_tpu_torch.models.baselines import (BASELINES, EXTRA_MODELS, Baseline,
                                                    BaselineSpec, EdgeGraph,
                                                    build_baseline_graphs)
    from pathnet_tpu_torch.models.baselines.cs import correct_and_smooth, label_propagation
    from pathnet_tpu_torch.train.baseline_trainer import dropout_masks

    cpu = torch.device("cpu")
    yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
    trm = ratio_masks(gc.n, 1000, val_size=59)[0]
    tr = torch.from_numpy(np.flatnonzero(trm))
    masks = dropout_masks(0, 0, 0.5)
    worst = []
    for name in BASELINES + EXTRA_MODELS:
        spec = BaselineSpec(name=name, feat_dim=Xc_np.shape[1], hidden=HIDDEN, out_dim=5,
                            dropout=0.5, n_nodes=gc.n, compute_dtype=dtype)
        Xn = (np.eye(5, dtype=np.float32)[yc.numpy()] * trm[:, None] if name == "lp" else Xc_np)
        outs = []
        for d in (dev, cpu):
            m = Baseline(spec, device=d, generator=torch.Generator().manual_seed(2))
            graphs = build_baseline_graphs(gc, name, d)
            Xd = torch.from_numpy(np.ascontiguousarray(Xn, np.float32)).to(d)
            with torch.no_grad():
                ev = m(Xd, graphs)
            logits = m(Xd, graphs, train=True,
                       masks=lambda i, shape, dd: masks(i, shape, cpu).to(dd))
            loss = torch.nn.functional.cross_entropy(logits[tr.to(d)], yc.to(d)[tr.to(d)])
            loss.backward()
            outs.append({"eval": ev, "logits": logits.detach(), "loss": loss.detach(),
                         **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for k, p in m.named_parameters()},
                         **{k: b for k, b in m.named_buffers()}})
        errs = []
        for k, want in outs[1].items():
            got = outs[0][k].cpu()
            err = float((got - want).abs().max())
            scale = max(float(want.abs().max()), 1e-30)
            if feeds_batch_norm(k, outs[1]):
                # a batch norm takes the mean over the nodes out of a bias
                # it normalizes, so the bias's gradient cancels to rounding
                # noise; its summands are those of the weight's gradient
                scale = max(scale, float(outs[1][k[:-4] + "weight"].abs().max()))
            errs.append(err / scale)
            if not err <= tol * scale:
                raise AssertionError(f"{name}: {k} on the card differs from the host's by {err} "
                                     f"(largest entry {scale})")
        worst.append(f"{name} {max(errs):.1e}")
    say(f"  every model at {dtype}, cornell F = {Xc_np.shape[1]}, card against host (eval "
        f"logits, loss, train logits, every gradient, running stats; worst error over the "
        f"host's largest entry, within {tol}): " + ", ".join(worst))
    if dtype != "float32":
        return
    y1 = np.eye(5, dtype=np.float32)[yc.numpy()]
    soft = np.random.default_rng(2).dirichlet(np.ones(5), size=gc.n).astype(np.float32)
    res = []
    for d in (dev, cpu):
        eg = EdgeGraph.from_graph(gc, "sym", True, device=d)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
        res.append((label_propagation(eg, t(y1), t(trm)).cpu(),
                    correct_and_smooth(eg, t(soft), t(y1), t(trm)).cpu()))
    for tag, a, b in zip(("label_propagation", "correct_and_smooth"), res[0], res[1]):
        err = float((a - b).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"{tag} on the card differs from the host's by {err}")
        say(f"  {tag} at cornell, card against host: max abs err {err:.3e}")


def check_baseline_training(dev, z, gc, Xc_np, dtype="float32"):
    """GCN and GAT full batch (``compute_dtype=dtype``) on the bgp stand-in:
    ms and S1-S4 launches an epoch (the difference of a 2-epoch and a ``2 +
    BGP_BASELINE_EPOCHS`` round, so the graph build and init cancel); two
    seeded rounds of each at cornell's full width,
    ``BASELINE_SEEDED_EPOCHS`` epochs with dropout 0.7, bit-equal in
    validation accuracy, loss and metrics. Returns the ms an epoch by
    model."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.data.splits import get_whole_mask, ratio_masks
    from pathnet_tpu_torch.models.baselines import BaselineSpec
    from pathnet_tpu_torch.train.baseline_trainer import run_baseline_round

    gb = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"], features=z["x"],
               labels=z["y"])
    masks = get_whole_mask(z["y"], seed=1)
    C = int(z["y"].max()) + 1
    epoch_ms = {}
    for model in ("gcn", "gat"):
        spec = BaselineSpec(name=model, feat_dim=gb.features.shape[1], hidden=HIDDEN,
                            out_dim=C, dropout=0.7, n_nodes=gb.n, compute_dtype=dtype)
        secs, counts = [], []
        for epochs in (2, 2 + BGP_BASELINE_EPOCHS):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_baseline_round(gb, spec, TrainConfig(epochs=epochs), *masks, C, seed=0,
                                     device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(K.launch_counts())
        per = {k: (counts[1][k] - counts[0][k]) / BGP_BASELINE_EPOCHS for k in BASELINE_KERNELS}
        want = {k: BASELINE_LAUNCHES[model].get(k, 0) for k in BASELINE_KERNELS}
        if per != want or not np.isfinite(res.metrics["accuracy"]):
            raise AssertionError(f"bgp {model}: launches an epoch {per}, expected {want}; "
                                 f"acc {res.metrics['accuracy']}")
        epoch_ms[model] = (secs[1] - secs[0]) / BGP_BASELINE_EPOCHS * 1e3
        say(f"  bgp stand-in --model {model} --dtype {dtype} full batch (n = {gb.n}, F = "
            f"{gb.features.shape[1]}, H = {HIDDEN}): "
            f"{epoch_ms[model]:.3f} ms per epoch; launches an "
            f"epoch {per}; rounds of 2 and {2 + BGP_BASELINE_EPOCHS} epochs took "
            f"{secs[0]:.2f} and {secs[1]:.2f} s")
    yc = np.random.default_rng(1).integers(0, 5, size=gc.n)
    gcx = Graph(n=gc.n, src=gc.src, dst=gc.dst, prob=gc.prob, features=Xc_np, labels=yc)
    cmasks = ratio_masks(gc.n, 1000, val_size=59)[:3]
    for model in ("gcn", "gat"):
        spec = BaselineSpec(name=model, feat_dim=Xc_np.shape[1], hidden=HIDDEN, out_dim=5,
                            dropout=0.7, n_nodes=gc.n, compute_dtype=dtype)
        a, b = (run_baseline_round(gcx, spec, TrainConfig(epochs=BASELINE_SEEDED_EPOCHS),
                                   *cmasks, 5, seed=4, device=dev, track_history=True)
                for _ in range(2))
        same = {"history": np.array_equal(a.history, b.history),
                "losses": np.array_equal(a.losses, b.losses),
                "metrics": a.metrics == b.metrics and a.best_val_acc == b.best_val_acc}
        if not all(same.values()):
            raise AssertionError(f"cornell --model {model} --dtype {dtype}: two seeded rounds "
                                 f"differ: {same}")
        say(f"  cornell --model {model} --dtype {dtype}, {BASELINE_SEEDED_EPOCHS} epochs, "
            f"dropout 0.7: two rounds with seed 4 bit-equal in validation accuracy, loss and "
            f"metrics (last loss {float(a.losses[-1]):.6f}, best val {a.best_val_acc:.4f})")
    return epoch_ms


def run_bf16_baselines(root, tmp):
    """One round each of cornell ``--model gcn``, ``gat`` (each within 3 std
    of its band) and ``fagcn`` (no band) at ``--dtype bfloat16`` through
    the CLI, counting the launches of each bf16 instance of S1-S4
    (:class:`InstanceCounts`, zeroed just before each round). Returns them
    summed by instance; raises if one was launched no time."""
    inst = InstanceCounts()
    launches = {name: 0 for name in BASELINE_BF16_KERNELS}
    try:
        for model in ("gcn", "gat", "fagcn"):
            band, payload, hidden = BASELINE_BF16_BANDS.get(model, (None, CORNELL_PAYLOAD, HIDDEN))
            inst.reset()
            run_baseline_cli("cornell", model, root, tmp, BASELINE_ROUNDS, hidden, band, payload,
                             round_band=band is not None, dtype="bfloat16")
            counts = inst.by_name()
            say(f"  launches by instance: {counts}")
            for name in launches:
                launches[name] += counts.get(name, 0)
    finally:
        inst.close()
    idle = [name for name, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"bf16 instances launched no time on the bf16 zoo's path: {idle}")
    return launches


def instance_name(name, wl=None, nw=None, agg=None):
    """The record of a kernel's instance at one of phase 20's shapes:
    ``"pagg_encode_fwd wl2"``, ``"pagg_encode_bwd sum nw80"``."""
    return (name + (f" {agg}" if agg else "") + (f" nw{nw}" if nw else "")
            + (f" wl{wl}" if wl else ""))


def check_instance(tag, ps, model, X, idx, gen, sub, rec, timed_=False):
    """``walk_dists`` (exact against K1 then K2's plain versions), then
    :func:`check_encode_kernels` (K3 without and with a keep mask, K4 with
    its three launches, ``pagg_contract``, ``segment_sum``) and K5 against
    their plain versions on the walks of the targets ``idx`` at the
    sampler's nw and wl and the model's readout (hetero, f32; phases 2 and
    5's tolerances). The errors go into ``sub``, a record a kernel of this
    instance (K5's into ``rec``); with ``timed_`` each kernel of ``sub`` is
    timed as phase 5 times its kernels."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.sample.walk import draw_uniforms

    smp = ps.sampler
    T, nw, wl = idx.shape[0], ps.num_walks, ps.walk_len
    u = draw_uniforms(wl, T * nw, gen, X.device)
    walk_args = (smp.nbr, smp.cdf, smp.deg, smp.srt, idx, u, nw)
    check_walk_dists(tag, smp, idx, u, nw, K.walk_dists_plain(*walk_args), sub)
    paths, dists, h, w, m1, keep, out, g, bwd_args = check_encode_kernels(
        tag, ps, model, X, idx, u, gen, sub, time_segment=timed_,
        names={k: k for k in ("pagg_encode_fwd", "pagg_encode_bwd")})
    if not torch.equal(K.row_gather(h, idx), K.row_gather_plain(h, idx)):
        raise AssertionError(f"{tag}: row_gather differs from its plain version")
    d5 = K.row_gather_bwd(g, idx, h.shape[0])
    d5_p = K.row_gather_bwd_plain(g, idx, h.shape[0])
    err5 = float((d5 - d5_p).abs().max())
    if not err5 <= K5_BWD_TOL * float(d5_p.abs().max()):
        raise AssertionError(f"{tag}: row_gather_bwd max abs err {err5}")
    record_err(rec, "row_gather", 0.0)
    record_err(rec, "row_gather_bwd", err5)
    say(f"  {tag}: walk_dists exact, row_gather exact, row_gather_bwd {err5:.3e} within "
        f"{K5_BWD_TOL} x max (T={T}, nw={nw}, wl={wl}, D={smp.max_deg}, {model.agg})")
    if not timed_:
        return
    agg = model.agg
    # walk_dists: both tables, deg, starts, u in; walks and distances out;
    # K1's compares and K2's on this data (k2_ops)
    timed(sub, "walk_dists", lambda: K.walk_dists(*walk_args),
          lambda: K.walk_dists_plain(*walk_args),
          nbytes(smp.nbr, smp.cdf, smp.deg, idx, u, paths, dists),
          T * nw * (wl - 1) * smp.max_deg + k2_ops(smp.deg, idx, paths, dists), 50)
    b3, o3, b4, o4 = encode_bounds(h, paths, dists, m1, out, g, w)
    timed(sub, "pagg_encode_fwd", lambda: K.pagg_encode_fwd(h, paths, dists, *w, m1, keep,
                                                            False, agg=agg),
          lambda: K.pagg_encode_fwd_plain(h, paths, dists, *w, m1, keep, False, agg=agg),
          b3, o3, 20)
    timed(sub, "pagg_encode_bwd", lambda: K.pagg_encode_bwd(*bwd_args, agg=agg),
          lambda: K.pagg_encode_bwd_plain(*bwd_args, agg=agg), b4, o4, 5)
    sub["pagg_encode_bwd"]["stages"] = time_k4_stages(tag, g, h, paths, dists, w, m1, keep,
                                                      agg=agg, rec=sub)


def check_new_shapes(dev, gen, rec, z, X, C, order, gc, Xc):
    """Phase 20's kernels at the runners' new shapes: every kernel of the
    hetero f32 path (:func:`check_instance`) at wl = 2 and 3 on one
    8192-target bgp microbatch (timed, the records ``... wl2``, ``...
    wl3``) and at cornell's full width (every node, F = 1703), then K3 and
    K4 under the sum readout on the path-pattern graph's 80 uniform walks a
    node, every node, at wl = 2 and 3 (wl = 3 timed, the records ``... sum
    nw80``)."""
    import torch
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.experiments.ablation_pattern import pattern_graph
    from pathnet_tpu_torch.models import PaggSpec, PathNet
    from pathnet_tpu_torch.sample import PathSampler

    bg = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"], name="bgp_standin")
    idx = torch.from_numpy(order[:REQUEST].astype(np.int32)).to(dev)
    allc = torch.arange(gc.n, dtype=torch.int32, device=dev)
    for wl in SHORT_WLS:
        sub = {k: {} for k in WL_KERNELS}
        for tag, g, Xg, out_dim, ix, timed_ in (("bgp microbatch", bg, X, C, idx, True),
                                                ("cornell", gc, Xc, 5, allc, False)):
            ps = PathSampler.build(g, NW, wl, device=dev)
            spec = PaggSpec(feat_dim=Xg.shape[1], hidden=HIDDEN, out_dim=out_dim, walk_len=wl,
                            dropout=0.7)
            model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(wl))
            check_instance(f"{tag}, wl = {wl}", ps, model, Xg, ix, gen, sub, rec, timed_)
        for k in WL_KERNELS:
            rec[instance_name(k, wl)] = sub[k]
    gp, Cp = pattern_graph(PATTERN_N)
    Xp = torch.from_numpy(gp.features).to(dev)
    allp = torch.arange(gp.n, dtype=torch.int32, device=dev)
    for wl in SHORT_WLS:
        sub = {k: {} for k in WL_KERNELS}
        ps = PathSampler.build(gp, PATTERN_NW, wl, kind="uniform", device=dev)
        spec = PaggSpec(feat_dim=8, hidden=HIDDEN, out_dim=Cp, walk_len=wl, agg="sum",
                        dropout=0.3)
        model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(wl))
        check_instance(f"pattern graph, nw = {PATTERN_NW}, sum, wl = {wl}", ps, model, Xp,
                       allp, gen, sub, rec, wl == PATTERN_WL)
        if wl == PATTERN_WL:
            for k in PATTERN_KERNELS:
                rec[instance_name(k, nw=PATTERN_NW, agg="sum")] = sub[k]


def outside_largest_component(n, src, dst):
    """Of each node, whether it lies outside the largest connected component
    of the records ``src``, ``dst``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    _, lab = connected_components(a, directed=False)
    return lab != np.bincount(lab).argmax()


def largest_component(g):
    """The subgraph of ``g``'s largest connected component, relabelled."""
    from pathnet_tpu_torch.data import Graph

    keep = ~outside_largest_component(g.n, g.src, g.dst)
    new = np.cumsum(keep) - 1
    sel = keep[g.src] & keep[g.dst]
    return Graph(n=int(keep.sum()), src=new[g.src[sel]].astype(np.int32),
                 dst=new[g.dst[sel]].astype(np.int32), prob=np.ones(int(sel.sum())))


def check_host_utils(root, tmp, dev):
    """Phase 20 (b): ``merw/extras`` on cora (n = 2,708) on the card in f32
    against the host in f64 (``EXTRAS_TOL`` absolute; ``merw_simrank`` on
    the largest component, 2,485 nodes: one global eigenvector has no
    meaning on the 77 minor components, where psi underflows), then
    ``init_rw`` on cornell and cora on the card and on the host, each into
    its own directory, read back with ``read_edge_input``: the header and
    records equal, the probabilities within ``INIT_RW_TOL`` where both are
    finite, a NaN (psi underflowed to 0, as in the JAX package and the
    reference) only outside the largest component."""
    import torch
    from pathnet_tpu_torch import init_rw
    from pathnet_tpu_torch.data import read_edge_input
    from pathnet_tpu_torch.data.registry import load_structure
    from pathnet_tpu_torch.merw import extras

    gc = load_structure("cora", root)
    lcc = largest_component(gc)
    parts = []
    for fn, g in (("compute_grw", gc), ("basic_simrank", gc), ("merw_simrank", lcc)):
        t0 = time.perf_counter()
        card = getattr(extras, fn)(g, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = getattr(extras, fn)(g, device="cpu", dtype=torch.float64)
        host_secs = time.perf_counter() - t0
        card, host = (card, host) if isinstance(card, tuple) else ((card,), (host,))
        if fn == "compute_grw":
            card += (extras.p_distance(card[0]),)
            host += (extras.p_distance(host[0]),)
        for a, b in zip(card, host):
            err = float((a.double().cpu() - b).abs().max())
            if not err <= EXTRAS_TOL:
                raise AssertionError(f"merw extras {fn} on cora: card against host max abs err "
                                     f"{err} beyond {EXTRAS_TOL}")
            parts.append(f"{fn} {err:.2e}")
        say(f"  {fn} on {'cora' if g is gc else 'cora largest component'} (n = {g.n}): "
            f"card {secs:.3f} s (f32), host {host_secs:.3f} s (f64)")
    say(f"  merw extras card (f32) against host (f64), max abs err: {', '.join(parts)} "
        f"(p_distance of compute_grw's P) within {EXTRAS_TOL}")
    for name in ("cornell", "cora"):
        got = []
        for i, where in enumerate((str(dev), "cpu")):
            path, = init_rw.main(["-data", name, "--data-root", root, "--out",
                                  os.path.join(tmp, f"init_rw_{i}"), "--device", where])
            got.append(read_edge_input(path))
        (n, src, dst, p), (hn, hsrc, hdst, hp) = got
        if not (n == hn and np.array_equal(src, hsrc) and np.array_equal(dst, hdst)):
            raise AssertionError(f"init_rw {name}: the card's records differ from the host's")
        both = np.isfinite(p) & np.isfinite(hp)
        err = float(np.abs(p[both] - hp[both]).max())
        outside = outside_largest_component(n, src, dst)
        nan_ok = all(outside[src[np.isnan(q)]].all() and not np.isinf(q).any() for q in (p, hp))
        if not (err <= INIT_RW_TOL and nan_ok):
            raise AssertionError(f"init_rw {name}: probabilities card against host max abs err "
                                 f"{err} (tolerance {INIT_RW_TOL}), NaN only outside the largest "
                                 f"component: {nan_ok}")
        say(f"  init_rw {name}: {len(src)} records equal, probabilities within {err:.2e} of "
            f"the host's ({int(both.sum())} finite in both; NaN card {int(np.isnan(p).sum())}, "
            f"host {int(np.isnan(hp).sum())}, all outside the largest component)")


def check_trace(tmp, dev):
    """Phase 20 (b): ``utils.trace`` on the card records CUDA activity: one
    ``row_gather`` launch inside it (the kernel built and warm before) leaves
    exactly one ``row_gather_kernel`` event of the ``kernel`` category in the
    Chrome trace it writes."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.utils import trace

    g = torch.Generator(device=dev).manual_seed(0)
    tbl = torch.randn(512, 128, device=dev, generator=g)
    idx = torch.randint(0, 512, (512,), device=dev, generator=g, dtype=torch.int32)
    K.row_gather(tbl, idx)
    torch.cuda.synchronize()
    log_dir = os.path.join(tmp, "trace")
    with trace(log_dir):
        K.row_gather(tbl, idx)
    files = [f for f in os.listdir(log_dir) if f.startswith("trace_") and f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"utils.trace wrote {files} into {log_dir}")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = [k for k in kernels if "row_gather_kernel" in k]
    if len(ours) != 1:
        raise AssertionError(f"utils.trace on the card: {len(ours)} row_gather_kernel events for "
                             f"one launch; kernel events {kernels[:10]}")
    say(f"  utils.trace: {len(events)} events, kernel events {len(kernels)}, one of "
        f"row_gather_kernel ({ours[0][:60]})")


def run_runners(root, tmp, dev, rec):
    """Phase 20 (c): each experiment runner on the card at a depth cut for
    time, its artifact read back: the walk-length ablation on cornell
    (1 x ``ABLATION_EPOCHS`` a length, each above chance),
    the path-pattern ablation (one round of ``PATTERN_EPOCHS`` a length,
    above chance), the cornell comparison column (one round of
    ``COMPARISON_EPOCHS`` of every column, complete) and the protocol sweep
    over texas and wisconsin (one round x ``PROTOCOL_EPOCHS`` each, within 3
    std of their bands, on the bands' payloads). Each protocol's launches
    are counted from 0 (``run_protocol`` and ``run_round`` wrapped for it):
    the wl = 2 and 3 rounds' into the ``... wl2``, ``... wl3`` records, the
    pattern's wl = 3 round's into the ``... sum nw80`` ones."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch import train
    from pathnet_tpu_torch.data.registry import DATASETS, payload_fingerprint
    from pathnet_tpu_torch.experiments import (ablation_length, ablation_pattern,
                                               comparison_table, protocol_all)

    out = os.path.join(tmp, "runners")
    common = ["--data-root", root, "--results-dir", out]

    def counted(fn, key, counts):
        def wrapper(*a, **kw):
            K.reset_launch_counts()
            result = fn(*a, **kw)
            torch.cuda.synchronize()
            counts[key(a, kw)] = K.launch_counts()
            return result
        return wrapper

    def read(name):
        with open(os.path.join(out, name)) as f:
            return json.load(f)

    def walks_launched(tag, counts, wl, epochs, backward):
        walk = walk_kernel(wl)
        if not (counts[walk] == epochs and counts["pagg_encode_bwd"] == counts["pagg_contract"]
                == counts["segment_sum"] == counts["row_gather_bwd"] == backward
                and counts["pagg_encode_fwd"] >= 2 * epochs):
            raise AssertionError(f"{tag}: launch counts {counts}: {epochs} epochs make one "
                                 f"{walk} launch each and {backward} backward launches")

    counts = {}
    run_protocol = train.run_protocol
    train.run_protocol = counted(run_protocol, lambda a, kw: kw["walk_len"], counts)
    t0 = time.perf_counter()
    try:
        rows = ablation_length.main(["cornell", "1", str(ABLATION_EPOCHS)] + common)
    finally:
        train.run_protocol = run_protocol
    art = read("ablation_length_cornell.json")
    chance = 1.0 / DATASETS["cornell"].num_classes
    if not (sorted(rows) == [2, 3, 4, 5] and art["platform"] == dev.type
            and art["payload"] == payload_fingerprint(DATASETS["cornell"])
            and all(m > chance for m, _ in rows.values())):
        raise AssertionError(f"ablation_length: {art}")
    for wl in rows:
        walks_launched(f"ablation_length wl = {wl}", counts[wl], wl, ABLATION_EPOCHS,
                       ABLATION_EPOCHS)
    for wl in SHORT_WLS:
        for k in WL_KERNELS:
            rec[instance_name(k, wl)]["launches"] = counts[wl][k]
    say(f"  ablation_length cornell (1 x {ABLATION_EPOCHS} a length): "
        + ", ".join(f"wl {wl} {m:.4f}" for wl, (m, _) in sorted(rows.items()))
        + f"; {time.perf_counter() - t0:.1f} s")

    counts = {}
    run_round = train.run_round
    train.run_round = counted(run_round, lambda a, kw: a[3].walk_len, counts)
    t0 = time.perf_counter()
    try:
        art = ablation_pattern.main(["--rounds", "1", "--epochs", str(PATTERN_EPOCHS)] + common)
    finally:
        train.run_round = run_round
    chance = 1.0 / art["num_classes"]
    accs = {int(wl): v["mean"] for wl, v in art["lengths"].items()}
    if not (sorted(accs) == [2, 3, 4, 5] and art["num_walks"] == PATTERN_NW
            and all(a > chance for a in accs.values())):
        raise AssertionError(f"ablation_pattern: {art}")
    for wl in accs:
        # the sum readout of uniform walks: one train chunk, so one backward an epoch
        walks_launched(f"ablation_pattern wl = {wl}", counts[wl], wl, PATTERN_EPOCHS,
                       PATTERN_EPOCHS)
    for k in PATTERN_KERNELS:
        rec[instance_name(k, nw=PATTERN_NW, agg="sum")]["launches"] = counts[PATTERN_WL][k]
    say(f"  ablation_pattern (n = {art['n']}, nw = {PATTERN_NW}, sum, 1 x {PATTERN_EPOCHS} a "
        "length): " + ", ".join(f"wl {wl} {a:.4f}" for wl, a in sorted(accs.items()))
        + f" ({art['num_classes']} classes); {time.perf_counter() - t0:.1f} s")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        col = comparison_table.main(["cornell", "1", str(COMPARISON_EPOCHS)] + common)
    except SystemExit as e:
        raise AssertionError(f"comparison_table exited with {e.code}: a column is missing")
    torch.cuda.synchronize()
    zoo = {k: v for k, v in K.launch_counts().items() if k in BASELINE_KERNELS}
    art = read("comparison_cornell.json")
    chance = 1.0 / DATASETS["cornell"].num_classes
    low = {m: a for m, (a, _) in col.items()
           if not (a > chance or m in COMPARISON_NEAR_CHANCE and 0.0 <= a <= 1.0)}
    if not (len(col) == len(art["accuracy"]) == 18 and not any(zoo[k] == 0 for k in zoo)
            and {"PathNet", "mlp"} <= set(col) and not low):
        raise AssertionError(f"comparison_table: {art}, launches {zoo}, at or below chance "
                             f"{chance}: {low}")
    say(f"  comparison_table cornell (1 x {COMPARISON_EPOCHS}), complete: "
        + ", ".join(f"{m} {a:.4f}" for m, (a, _) in col.items())
        + f"; S1-S4 launches {zoo}; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    status = protocol_all.main(list(SWEEP_BANDS) + ["--rounds", "1", "--epochs",
                                                    str(PROTOCOL_EPOCHS)] + common)
    if not all(status[name]["ok"] for name in SWEEP_BANDS):
        raise AssertionError(f"protocol_all: {status}")
    with open(os.path.join(out, "results.jsonl")) as f:
        sweep = {r["name"]: r for r in map(json.loads, f) if r["name"] in SWEEP_BANDS}
    for name, (band, payload) in SWEEP_BANDS.items():
        r = sweep[name]
        acc = r["metrics"]["accuracy"]["mean"]
        if not (r["config"]["payload"] == payload and abs(acc - band[0]) <= 3 * band[1]):
            raise AssertionError(f"protocol_all {name}: accuracy {acc} on payload "
                                 f"{r['config']['payload']}, band {band} on {payload}")
        say(f"  protocol_all {name} (1 x {PROTOCOL_EPOCHS}, H = {r['config']['hidden_size']}): "
            f"acc {acc:.4f}, within 3 std of the JAX band {band[0]:.4f} +- {band[1]:.4f}; "
            f"{status[name]['seconds']:.1f} s")
    say(f"  protocol_all: {time.perf_counter() - t0:.1f} s")


def _copies(out):
    """A wrapper's result copied (autograd may hand views of it to ``.grad``,
    which the step then divides in place)."""
    if isinstance(out, tuple):
        return tuple(_copies(t) for t in out)
    return out.detach().clone() if hasattr(out, "detach") else out


class Taps:
    """Record the first call at each of ``TAPS``' call sites while the
    context is open: the wrapper's bound arguments (copied) and its result."""

    def __enter__(self):
        import importlib
        import inspect

        import torch

        self.calls, self._undo = {}, []
        for name, module, attr in TAPS:
            mod = importlib.import_module(module)
            real = getattr(mod, attr)

            def tap(*args, _real=real, _site=(name, module), **kwargs):
                out = _real(*args, **kwargs)
                if _site not in self.calls:
                    # copies: some arguments are parameters that Adam moves later
                    bound = inspect.signature(_real).bind(*args, **kwargs)
                    for k, v in bound.arguments.items():
                        if isinstance(v, torch.Tensor):
                            bound.arguments[k] = v.detach().clone()
                    self.calls[_site] = (bound, _copies(out))
                return out

            setattr(mod, attr, tap)
            self._undo.append((mod, attr, real))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self._undo:
            setattr(mod, attr, real)
        return False


def hold_taps(tag, calls):
    """Each recorded call's result against its plain version on the same
    arguments, at the tolerances of phases 2 and 5: ``walk_dists`` and
    ``row_gather`` exact, K3 within atol = rtol = K3_TOL, K4 as
    ``check_k4``, ``pagg_contract`` as ``check_contract``, ``segment_sum``
    within SEGMENT_TOL and ``row_gather_bwd`` within K5_BWD_TOL of the plain
    float64 maximum. Returns the max abs error by kernel."""
    import inspect

    import torch
    from pathnet_tpu_torch import kernels as K

    plains = {"walk_dists": K.walk_dists_plain, "pagg_encode_fwd": K.pagg_encode_fwd_plain,
              "pagg_encode_bwd": K.pagg_encode_bwd_plain,
              "pagg_contract": K.contractions_plain, "segment_sum": K.segment_sum_plain,
              "row_gather": K.row_gather_plain, "row_gather_bwd": K.row_gather_bwd_plain}
    errs = {}
    for (name, module), (bound, out) in sorted(calls.items()):
        site = f"{tag}, {name} from {module.rsplit('.', 1)[-1]}"
        plain = plains[name]
        kw = {k: v for k, v in bound.arguments.items()
              if k in inspect.signature(plain).parameters}
        if name == "pagg_contract":
            check_contract(site, list(bound.args))
            continue
        if name in ("segment_sum", "row_gather_bwd"):
            kw = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point()
                      else v) for k, v in kw.items()}
        want = plain(**kw)
        torch.cuda.synchronize()
        if name == "walk_dists":
            ok, err = all(torch.equal(a, b) for a, b in zip(out, want)), 0.0
        elif name == "row_gather":
            ok, err = torch.equal(out, want), 0.0
        elif name == "pagg_encode_fwd":
            ok, err = k3_close(out, want, False), float((out - want).abs().max())
        elif name == "pagg_encode_bwd":
            ok, err = True, check_k4(site, out, want)
        else:
            tol = SEGMENT_TOL if name == "segment_sum" else K5_BWD_TOL
            err = float((out.double() - want).abs().max())
            ok = err <= tol * float(want.abs().max())
        if not ok:
            raise AssertionError(f"{site}: differs from its plain version (max abs err {err})")
        errs[name] = max(errs.get(name, 0.0), err)
        shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in bound.arguments.items()
                           if isinstance(v, torch.Tensor) and v.dim() and v.numel() > 4096)
        say(f"  {site}: against its plain version, max abs err {err:.3e} ({shapes})")
    return errs


def one_process_step(model, X, y, ps, tr, va, u, masks, lr=0.005, weight_decay=0.0005):
    """The port's one-process step on the sharded step's batch, walks and
    masks: loss, summed gradients, validation accuracy after Adam."""
    import torch
    from pathnet_tpu_torch.parallel.mesh import walk_starts
    from pathnet_tpu_torch.train.trainer import make_optimizer, weighted_ce

    opt = make_optimizer(model.parameters(), lr, weight_decay)
    walk = lambda starts: walk_starts(ps, u, starts)
    paths, dists = walk(tr)
    model.zero_grad(set_to_none=True)
    logits = model(X, paths, dists, tr, train=True, masks=masks)
    loss = weighted_ce(logits, y[tr.long()], torch.ones(tr.shape[0], device=X.device))
    (loss / tr.shape[0]).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step()
    vp, vd = walk(va)
    with torch.no_grad():
        acc = float((model(X, vp, vd, va).argmax(-1) == y[va.long()]).float().mean())
    return loss.item() / tr.shape[0], grads, acc


def compare_step(tag, res, want):
    """A sharded step's loss and gradients against the one-process step's."""
    loss, grads, _ = want
    if not abs(res.loss - loss) <= LOSS_TOL:
        raise AssertionError(f"{tag}: loss {res.loss} against the one-process {loss}")
    worst = 0.0
    for k, g in grads.items():
        d = (res.grads[k] - g).abs()
        if not bool((d <= STEP_ATOL + STEP_RTOL * g.abs()).all()):
            raise AssertionError(f"{tag}: gradient {k} differs by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def step_ms(fn, reps=3):
    """Median host ms of ``fn`` (ending in a synchronize) after a warm call,
    with the peak device memory of the last call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 2 ** 20


def bgp_rank_setup(dev):
    """The bgp stand-in on the rank's card: the graph, sampler, X, y and a
    model at full width with a seeded dropout."""
    import torch
    from pathnet_tpu_torch.data import Graph
    from pathnet_tpu_torch.kernels import build
    from pathnet_tpu_torch.models import PaggSpec
    from pathnet_tpu_torch.sample import PathSampler

    if not build.library_path().is_file():
        raise AssertionError("a rank found no built kernel library: ranks build nothing")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    z = np.load(BGP)
    g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"], name="bgp_standin")
    ps = PathSampler.build(g, NW, WL, device=dev)
    X = torch.from_numpy(z["x"]).to(dev)
    y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=int(z["y"].max()) + 1,
                    walk_len=WL, dropout=0.7)
    return g, ps, X, y, spec


def mesh_nccl_rank(grid):
    """Phase 21, one NCCL rank on the card at the bgp stand-in's full width:
    the sharded step through each exchange with row-sharded X against the
    one-process step, ``make_sharded_predict`` against ``predict``, the
    sharded path's launches, and each kernel of it held against its plain
    version on the inputs the ring exchange gave it."""
    import torch
    import torch.distributed as dist
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.models import PathNet, draw_dropout_masks
    from pathnet_tpu_torch.parallel import shard_rows, sharded_train_step
    from pathnet_tpu_torch.train import make_sharded_predict, predict

    dev = grid.device
    g, ps, X, y, spec = bgp_rank_setup(dev)
    say(f"  rank {grid.rank}: {grid.backend} on {dev} ({torch.cuda.get_device_name(dev)}), "
        f"grid {grid.data} x {grid.model}")
    gen = torch.Generator(device=dev).manual_seed(21)
    order = torch.from_numpy(np.random.default_rng(21).permutation(g.n).astype(np.int32)).to(dev)
    tr, va = order[:REQUEST], order[REQUEST:2 * REQUEST]
    u = ps.draw_uniforms(g.n * NW, gen)
    masks = draw_dropout_masks(spec, REQUEST, NW, gen, dev)
    init = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0)).state_dict()

    def fresh():
        m = PathNet(spec, device=dev)
        m.load_state_dict(init)
        return m

    ones = torch.ones(1, device=dev)
    dist.all_reduce(ones)    # NCCL itself runs: a world of one rank skips the layer's calls
    if float(ones) != grid.world:
        raise AssertionError(f"NCCL all_reduce gave {float(ones)}")
    Xb = shard_rows(X, grid.data_axis)
    want = one_process_step(fresh(), X, y, ps, tr, va, u, masks)
    m1 = fresh()
    torch.cuda.empty_cache()
    out = {"one_ms": step_ms(lambda: one_process_step(m1, X, y, ps, tr, va, u, masks))}
    K.reset_launch_counts()
    with Taps() as taps:
        for ex in ("ring",) + tuple(e for e in EXCHANGES if e != "ring"):
            step = sharded_train_step(grid, fresh(), spec.out_dim, shard_features=True,
                                      exchange=ex)
            res = step(Xb, y, ps, tr, va, u, masks)
            out[ex] = compare_step(f"sharded step, {ex}", res, want)
        fn = make_sharded_predict(grid)
        ureq = ps.draw_uniforms(REQUEST * NW, gen)[None]
        logp = fn(fresh(), Xb, ps, va, u=ureq)
        torch.cuda.synchronize()
    counts = K.launch_counts()
    missing = [k for k in SHARDED_PATH if not counts[k]]
    if missing:
        raise AssertionError(f"the sharded path launched no {missing}: {counts}")
    logp_one = predict(fresh(), X, ps, idx=va, u=ureq)
    perr = float((logp - logp_one).abs().max())
    if not torch.isfinite(logp).all() or perr > LOSS_TOL:
        raise AssertionError(f"make_sharded_predict differs from predict by {perr}")
    out["errs"] = hold_taps("sharded (ring, one rank)", taps.calls)
    del taps, logp, logp_one       # the copies the holds read: not in the peaks below
    torch.cuda.empty_cache()
    for ex in EXCHANGES:
        st = sharded_train_step(grid, fresh(), spec.out_dim, shard_features=True, exchange=ex)
        out[f"{ex}_ms"] = step_ms(lambda: st(Xb, y, ps, tr, va, u, masks))
    out["predict_ms"] = step_ms(lambda: fn(m1, Xb, ps, va, u=ureq))
    out["plain_predict_ms"] = step_ms(lambda: predict(m1, X, ps, idx=va, u=ureq))
    out.update(counts=counts, predict_err=perr, loss=want[0])
    return out


def mesh_gloo_rank(grid, root):
    """Phase 21, two gloo ranks on one card (staged through the host), on
    cornell at full width: one sharded step per exchange against this rank's
    own one-process step, then one seeded round with row-sharded X twice."""
    import torch
    from pathnet_tpu_torch import kernels as K
    from pathnet_tpu_torch.config import TrainConfig
    from pathnet_tpu_torch.data.registry import load_dataset
    from pathnet_tpu_torch.kernels import build
    from pathnet_tpu_torch.models import PaggSpec, PathNet, draw_dropout_masks
    from pathnet_tpu_torch.parallel import shard_rows, sharded_train_step
    from pathnet_tpu_torch.sample import PathSampler
    from pathnet_tpu_torch.train import run_round
    from pathnet_tpu_torch.train.trainer import epoch_uniforms

    if not build.library_path().is_file():
        raise AssertionError("a rank found no built kernel library: ranks build nothing")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = grid.device
    g, trm, vam, tem, _ = load_dataset("cornell", root, 0)
    ps = PathSampler.build(g, NW, WL, device=dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    y = torch.from_numpy(np.array(g.labels, np.int64)).to(dev)
    spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7)
    gen = torch.Generator(device=dev).manual_seed(21)
    even = lambda m: torch.from_numpy(np.flatnonzero(m)[:int(m.sum()) // 2 * 2]
                                      .astype(np.int32)).to(dev)
    tr, va = even(trm), even(vam)
    u = epoch_uniforms(ps, 0, 0)
    masks = draw_dropout_masks(spec, tr.shape[0], NW, gen, dev)
    init = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(1)).state_dict()

    def fresh():
        m = PathNet(spec, device=dev)
        m.load_state_dict(init)
        return m

    want = one_process_step(fresh(), X, y, ps, tr, va, u, masks)
    out = {}
    for ex in EXCHANGES:
        step = sharded_train_step(grid, fresh(), 5, shard_features=True, exchange=ex)
        out[ex] = compare_step(f"rank {grid.rank}, cornell step, {ex}",
                               step(shard_rows(X, grid.data_axis), y, ps, tr, va, u, masks),
                               want)
    cfg = TrainConfig(epochs=MESH_ROUND_EPOCHS)
    runs = []
    for i in range(2):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_round(X, y, ps, spec, cfg, trm, vam, tem, 5, seed=0, track_history=True,
                        mesh=grid, shard_features=True)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0, K.launch_counts()))
    (a, ta, counts), (b, tb, _) = runs
    same = (np.array_equal(a.history, b.history) and np.array_equal(a.losses, b.losses)
            and a.metrics == b.metrics)
    out.update(same=same, metrics=a.metrics, best_val=a.best_val_acc, seconds=(ta, tb),
               counts=counts, final_loss=float(a.losses[-1]))
    return out


def check_mesh(root):
    """Phase 21: the multi-device layer on the card (parts 1 and 2)."""
    import torch
    from pathnet_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()    # the ranks share the card with this process

    say("  part 1: one NCCL rank on cuda:0, the bgp stand-in at full width "
        f"(H = {HIDDEN}, nw = {NW}, wl = {WL}, {REQUEST}-target step and request)")
    r = spawn(mesh_nccl_rank, 1, device="cuda", timeout_s=RANK_TIMEOUT_S)[0]
    say(f"  sharded path launches: {r['counts']}")
    say(f"  loss {r['loss']:.6f}; gradients within atol {STEP_ATOL} + rtol {STEP_RTOL} of "
        "the one-process step's, max abs diff " + ", ".join(
            f"{ex} {r[ex]:.3e}" for ex in EXCHANGES))
    say(f"  step ms (host clock, median of 3; peak MiB): one-process {r['one_ms'][0]:.2f} "
        f"({r['one_ms'][1]:.0f}), " + ", ".join(
            f"{ex} {r[ex + '_ms'][0]:.2f} ({r[ex + '_ms'][1]:.0f})" for ex in EXCHANGES))
    say(f"  make_sharded_predict, {REQUEST} targets: {r['predict_ms'][0]:.2f} ms "
        f"({r['predict_ms'][1]:.0f} MiB) against predict {r['plain_predict_ms'][0]:.2f} ms "
        f"({r['plain_predict_ms'][1]:.0f} MiB); max abs diff of the log-probs "
        f"{r['predict_err']:.3e}")
    say("  part 2: two gloo ranks on cuda:0, staged through host memory; cornell at full "
        f"width, {MESH_ROUND_EPOCHS}-epoch rounds with row-sharded X")
    rs = spawn(mesh_gloo_rank, 2, device="cuda", backend="gloo", timeout_s=RANK_TIMEOUT_S,
               args=(root,))
    for i, q in enumerate(rs):
        say(f"  rank {i}: step gradients within tolerance of its one-process step, max abs "
            "diff " + ", ".join(f"{ex} {q[ex]:.3e}" for ex in EXCHANGES)
            + f"; rounds {q['seconds'][0]:.1f} s and {q['seconds'][1]:.1f} s, "
            f"bit-equal {q['same']}, best val {q['best_val']:.4f}, test acc "
            f"{q['metrics']['accuracy']:.4f}, launches {q['counts']}")
        if not q["same"]:
            raise AssertionError(f"rank {i}: two seeded rounds differ")
        missing = [k for k in SHARDED_PATH if not q["counts"][k]]
        if missing:
            raise AssertionError(f"rank {i}: the round launched no {missing}")
    if rs[0]["metrics"] != rs[1]["metrics"]:
        raise AssertionError("the two ranks ended the round with different metrics")
    acc = rs[0]["metrics"]["accuracy"]
    mean, std = CORNELL_BAND
    if not abs(acc - mean) <= 3 * std:
        raise AssertionError(f"cornell round on two ranks: test acc {acc:.4f} outside "
                             f"{mean:.4f} +- 3 x {std:.4f}")
    say(f"  cornell test acc {acc:.4f} within {mean:.4f} +- 3 x {std:.4f}")
    return r["errs"]


def cards_rank(grid):
    """One NCCL rank of :func:`check_cards`: the steps and the request."""
    import torch
    from pathnet_tpu_torch.models import PathNet, draw_dropout_masks
    from pathnet_tpu_torch.parallel import shard_rows, sharded_train_step
    from pathnet_tpu_torch.parallel.comm import regrid
    from pathnet_tpu_torch.train import make_sharded_predict, predict

    dev = grid.device
    g, ps, X, y, spec = bgp_rank_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    order = torch.from_numpy(np.random.default_rng(21).permutation(g.n).astype(np.int32)).to(dev)
    tr, va = order[:REQUEST], order[REQUEST:2 * REQUEST]
    u = ps.draw_uniforms(g.n * NW, gen)
    masks = draw_dropout_masks(spec, REQUEST, NW, gen, dev)
    init = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0)).state_dict()

    def fresh():
        m = PathNet(spec, device=dev)
        m.load_state_dict(init)
        return m

    want = one_process_step(fresh(), X, y, ps, tr, va, u, masks)
    m1 = fresh()
    out = {"one_ms": step_ms(lambda: one_process_step(m1, X, y, ps, tr, va, u, masks))}
    runs = [(grid, ex, True, False) for ex in EXCHANGES] + [(grid, "gspmd", False, False)]
    if grid.world % 2 == 0:
        g2 = regrid(grid, grid.world // 2, 2)
        runs += [(g2, "gspmd", True, True), (g2, "sparse", True, True)]
    for gr, ex, sf, sp in runs:
        st = sharded_train_step(gr, fresh(), spec.out_dim, shard_features=sf, exchange=ex,
                                shard_params=sp)
        Xr = shard_rows(X, gr.data_axis) if sf else X
        key = f"{gr.data}x{gr.model} {ex}{' X' if sf else ''}{' P' if sp else ''}"
        err = compare_step(key, st(Xr, y, ps, tr, va, u, masks), want)
        out[key] = (err, step_ms(lambda: st(Xr, y, ps, tr, va, u, masks)))
    fn = make_sharded_predict(grid)
    ureq = ps.draw_uniforms(REQUEST * NW, gen)[None]
    Xb = shard_rows(X, grid.data_axis)
    err = float((fn(m1, Xb, ps, va, u=ureq) - predict(m1, X, ps, idx=va, u=ureq)).abs().max())
    if not err <= LOSS_TOL:
        raise AssertionError(f"make_sharded_predict differs from predict by {err}")
    out.update(predict_err=err, predict_ms=step_ms(lambda: fn(m1, Xb, ps, va, u=ureq)),
               plain_predict_ms=step_ms(lambda: predict(m1, X, ps, idx=va, u=ureq)))
    return out


def check_cards(n: int) -> int:
    """Phase 21's sharded step on ``n`` cards, NCCL between them, one card a
    rank (``python3 chip_smoke.py --cards N``), the bgp stand-in at full
    width and phase 21's draws and masks:

    - the sharded step on an ``n x 1`` grid through each exchange with
      row-sharded X and through ``gspmd`` with X replicated, and (even
      ``n``) on an ``n/2 x 2`` grid with the parameters sharded over the
      model axis, each against the one-process step every rank also runs on
      its own card (loss within 1e-5, gradients within atol 1e-5 + rtol
      1e-4), each timed (host clock after a synchronize, median of 3) with
      its peak device memory. The model axis splits only the optimizer's
      state and update (``parallel/mesh.py``): its ranks each run the whole
      forward and backward of their data share;
    - ``make_sharded_predict`` against ``predict`` on one request (within
      1e-5), both timed;
    - the CLI's ``--mesh n --shard-features`` on cornell, one round of
      ``CARDS_CLI_EPOCHS`` epochs, its test accuracy within 3 std of the
      cornell band.

    Each rank's numbers are printed as one JSON line and written with the
    CLI's output under ``chiprun_out/chip_smoke_cards.log``. Returns 1 on
    any failure."""
    import torch
    from pathnet_tpu_torch.kernels import build
    from pathnet_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < n:
        print(f"chip_smoke: {n} ranks need {n} CUDA cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    log_path = os.path.join(ROOT, "chiprun_out", "chip_smoke_cards.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as log:
        def note(msg):
            say(msg)
            log.write(msg + "\n")

        note(nvidia_smi_line())
        t0 = time.time()
        build.build()
        note(f"build {time.time() - t0:.1f} s")
        t0 = time.time()
        for i, r in enumerate(spawn(cards_rank, n, device="cuda", timeout_s=900)):
            note(f"rank {i}: " + json.dumps(r))
        note(f"{n} ranks {time.time() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            r = subprocess.run([sys.executable, "-m", "pathnet_tpu_torch.run", "-data", "cornell",
                                "--mesh", str(n), "--shard-features", "-e",
                                str(CARDS_CLI_EPOCHS), "-r", "1", "-pr", os.path.join(tmp, "data"),
                                "--results-dir", os.path.join(tmp, "res"), "--ckpt-dir",
                                os.path.join(tmp, "ck")],
                               capture_output=True, text=True, timeout=900, cwd=ROOT)
            note(r.stdout + r.stderr)
            note(f"CLI --mesh {n} --shard-features: rc {r.returncode}, {time.time() - t0:.1f} s")
            if r.returncode:
                return 1
            with open(os.path.join(tmp, "res", "results.jsonl")) as f:
                acc = json.loads(f.readlines()[-1])["metrics"]["accuracy"]["mean"]
        mean, std = CORNELL_BAND
        note(f"cornell test acc {acc:.4f} (band {mean:.4f} +- 3 x {std:.4f})")
        return 0 if abs(acc - mean) <= 3 * std else 1


def main() -> int:
    faulthandler.dump_traceback_later(1185, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from pathnet_tpu_torch import kernels as K
        from pathnet_tpu_torch.data import Graph
        from pathnet_tpu_torch.kernels import build
        from pathnet_tpu_torch.models import PaggSpec, PathNet
        from pathnet_tpu_torch.sample import PathSampler
        from pathnet_tpu_torch.sample.walk import draw_uniforms
        from pathnet_tpu_torch.config import TrainConfig
        from pathnet_tpu_torch.data.splits import get_whole_mask, ratio_masks
        from pathnet_tpu_torch.models import draw_dropout_masks
        from pathnet_tpu_torch.train import predict, run_round
        from pathnet_tpu_torch.train.trainer import (STREAM_INIT, chunk_index,
                                                     chunked_grads, make_generator)
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rec = {name: {} for name in KERNELS + tuple(homo_name(n, True) for n in HOMO_KERNELS)
           + BF16_KERNELS + CHOICE_KERNELS + REMAINING_KERNELS + BASELINE_BF16_KERNELS}
    meta = {
        "cdf_walk": ("pathnet_tpu_torch/csrc/walk_dists.cu", "pathnet_tpu/sample/alias.py:142"),
        "membership_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                             "pathnet_tpu/sample/distance.py:77"),
        "pagg_encode_fwd": ("pathnet_tpu_torch/csrc/pagg_encode.cu",
                            "pathnet_tpu/models/pagg.py:235"),
        "pagg_encode_bwd": ("pathnet_tpu_torch/csrc/pagg_encode_bwd.cu",
                            "pathnet_tpu/models/pagg.py:235"),
        "row_gather": ("pathnet_tpu_torch/csrc/row_gather.cu",
                       "scripts/pallas_gather_probe.py:68"),
        "row_gather_bwd": ("pathnet_tpu_torch/csrc/row_gather.cu",
                           "scripts/pallas_gather_probe.py:68"),
        "lane_gather": ("pathnet_tpu_torch/csrc/lane_gather.cu",
                        "scripts/pallas_gather_probe.py:68"),
        "segment_sum": ("pathnet_tpu_torch/csrc/segment_sum.cu",
                        "pathnet_tpu/models/pagg.py:83"),
        "walk_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                       "pathnet_tpu/sample/alias.py:142, pathnet_tpu/sample/distance.py:77"),
        "khop_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                       "pathnet_tpu/sample/distance.py:194"),
        "walk_khop_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                            "pathnet_tpu/sample/alias.py:142, pathnet_tpu/sample/distance.py:194"),
        "alias_walk": ("pathnet_tpu_torch/csrc/walk_dists.cu", "pathnet_tpu/sample/alias.py:93"),
        "alias_walk_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                             "pathnet_tpu/sample/alias.py:93, pathnet_tpu/sample/distance.py:77"),
        "alias_walk_khop_dists": ("pathnet_tpu_torch/csrc/walk_dists.cu",
                                  "pathnet_tpu/sample/alias.py:93, "
                                  "pathnet_tpu/sample/distance.py:194"),
        "spmm": ("pathnet_tpu_torch/csrc/spmm.cu", "pathnet_tpu/models/baselines/ops.py:68"),
        "edge_dot": ("pathnet_tpu_torch/csrc/spmm.cu",
                     "pathnet_tpu/models/baselines/ops.py:68 (its VJP)"),
        "segment_softmax": ("pathnet_tpu_torch/csrc/segment_softmax.cu",
                            "pathnet_tpu/models/baselines/ops.py:76"),
        "segment_softmax_bwd": ("pathnet_tpu_torch/csrc/segment_softmax.cu",
                                "pathnet_tpu/models/baselines/ops.py:76 (its VJP)"),
        "pagg_contract": ("pathnet_tpu_torch/csrc/pagg_contract.cu",
                          "pathnet_tpu/models/pagg.py:235 (its VJP in the weights: :150, :185, "
                          "pathnet_tpu/nn/cells.py:22, :49)"),
    }
    meta.update({name: meta[name.split()[0]] for name in BASELINE_BF16_KERNELS})
    meta.update({homo_name(n, True): meta[n] for n in HOMO_KERNELS})
    meta.update({homo_name(n, v, True): meta[n] for n in HOMO_KERNELS for v in (False, True)})
    # the GRU instances are built in translation units of their own
    meta.update({homo_name(n, v, cell="gru"): (meta[n][0].replace(".cu", "_gru.cu"),
                                               meta[n][1])
                 for n in HOMO_KERNELS for v in (False, True)})
    # so are the MLP's; the bf16 GRU's sit beside the f32 GRU's
    meta.update({homo_name(n, v, cell="mlp"): (meta[n][0].replace(".cu", "_mlp.cu"),
                                               "pathnet_tpu/models/pagg.py:180")
                 for n in HOMO_KERNELS for v in (False, True)})
    meta.update({homo_name(n, False, True, "gru"): meta[homo_name(n, False, cell="gru")]
                 for n in HOMO_KERNELS})
    meta.update({f"{n} quirk": (meta[n][0], "pathnet_tpu/models/pagg.py:316")
                 for n in HOMO_KERNELS})
    meta.update({f"pagg_readout {a}": ("pathnet_tpu_torch/csrc/pagg_encode.cu",
                                       "pathnet_tpu/models/pagg.py:304")
                 for a in ("mean", "sum")})
    meta.update({f"pagg_attention_bwd {a}": ("pathnet_tpu_torch/csrc/pagg_encode_bwd.cu",
                                             "pathnet_tpu/models/pagg.py:304")
                 for a in ("mean", "sum")})
    notes = dict(NOTES)
    notes.update({homo_name(n, v, True): f"{k}'s bf16 instances (BF16 = true)"
                  + (", homo" if v else "")
                  for n, k in zip(HOMO_KERNELS, ("K3", "K4")) for v in (False, True)})
    notes.update({homo_name(n, v, cell="gru"): f"{k}'s GRU instances (GRU = true, "
                  "nn/cells.py:49-68), the bound at the 14 H^2 (K3) or 42 H^2 (K4) a walk "
                  "step the GRU needs" + (", homo" if v else "")
                  for n, k in zip(HOMO_KERNELS, ("K3", "K4")) for v in (False, True)})
    notes.update({homo_name(n, v, cell="mlp"): f"{k}'s MLP instances (CELL = MLP_CELL, "
                  "pagg.py:180-188), the bound at the 2.5 H^2 (K3) or 7.5 H^2 (K4) a walk "
                  "step the MLP needs at wl = 4" + (", homo" if v else "")
                  for n, k in zip(HOMO_KERNELS, ("K3", "K4")) for v in (False, True)})
    notes.update({homo_name(n, False, True, "gru"): f"{k}'s bf16 GRU instances (BF16 and "
                  "CELL = GRU_CELL), the bound at the GRU's flops at bf16's rate"
                  for n, k in zip(HOMO_KERNELS, ("K3", "K4"))})
    notes.update({f"{n} quirk": f"{k} under the quirk readout (AGG = QUIRK, "
                  "pagg.py:316-338: the hetero launches on quirk_layout's walks, explicit "
                  "ego nodes, the softmax's mean), timed at cornell's 183 targets"
                  for n, k in zip(HOMO_KERNELS, ("K3", "K4"))})
    notes.update({f"pagg_readout {a}": f"K3's second launch, AGG = {a.upper()}; launches "
                  "are K3's in the run" for a in ("mean", "sum")})
    notes.update({f"pagg_attention_bwd {a}": f"K4's second launch, AGG = {a.upper()}; "
                  "launches are K4's in the run" for a in ("mean", "sum")})
    notes.update({
        "alias_walk": "K8 alone, the alias tables' walks under the dense, host and none "
                      "backends; launches from phase 16's 20-epoch dense-backend round",
        "alias_walk_dists": "K8 with K2, the alias sampler's path at wl <= 4; launches from "
                            "phase 16's 1000-epoch cornell alias round",
        "alias_walk_khop_dists": "K8 with K7, the alias sampler's path past wl = 4; launches "
                                 "from phase 16's 20-epoch wl = 5 round"})
    notes.update({name: f"{what}; launches from phase 18's cornell --model gat round "
                        f"({BASELINE_ROUNDS} x {PROTOCOL_EPOCHS}), timed {where} on the bgp "
                        "stand-in's baseline graph (703,633 edges)"
                  for name, what, where in (
                      ("spmm", "S1, the zoo's message passing and its input gradient",
                       "forward at F = 64"),
                      ("edge_dot", "S2, the edge weights' gradient", "at 8 heads x 64"),
                      ("segment_softmax", "S3, GAT's per-destination softmax", "at 8 heads"),
                      ("segment_softmax_bwd", "S4, its VJP", "at 8 heads"))})
    notes.update({name: f"{what} (bf16); launches from phase 19's cornell --dtype bfloat16 "
                        f"rounds ({BASELINE_ROUNDS} x {PROTOCOL_EPOCHS} each of gcn, gat, fagcn), "
                        f"timed {where} on the bgp stand-in's baseline graphs beside its f32 "
                        "instance (f32_ms)"
                  for name, what, where in (
                      ("spmm bf16 rows", "S1 on bf16 rows with f32 weights, f32 out: JAX's "
                       "promotion of spmm on a bf16 h (GCN's first layer)", "at F = 64"),
                      ("spmm bf16 sum", "S1 of f32 terms into a bf16 sum rounded after each "
                       "add: spmm's input gradient on a bf16 h", "at F = 64"),
                      ("spmm bf16", "S1 all bf16, each product and each add rounded: GAT's "
                       "messages and their input gradient", "at 8 heads x 64"),
                      ("spmm bf16 gather", "S1 summing bf16 edge rows by node: the VJP of "
                       "a gather of bf16 rows (GAT's scores, FAGCN's cat)", "at 8 heads"),
                      ("edge_dot bf16", "S2 all bf16, per add: GAT's attention gradient",
                       "at 8 heads x 64"),
                      ("edge_dot bf16 rows", "S2 of f32 g and bf16 h, f32 dot: FAGCN's "
                       "first-layer weight gradient", "at F = 64"),
                      ("segment_softmax bf16", "S3 on bf16 scores, rounded where JAX "
                       "rounds", "at 8 heads"),
                      ("segment_softmax_bwd bf16", "S4 on bf16 a and da, f32 inside, "
                       "rounded once", "at 8 heads"))})
    notes["edge_dot bf16 rows"] += "; library n/a: no torch call takes f32 g with bf16 h"
    notes["pagg_contract"] = (
        "K4's weight contractions (dwd, dbd, dw_ih, dw_hh, db) from its streams, one count a "
        "K4 call in every instance; timed at the bgp microbatch, f32 LSTM; its bound at 3 x "
        "the function's flops on the TF32 tensor cores (3xTF32) or its bytes; library n/a: no "
        "one torch call computes it (the plain composition, torch.matmul and bmm over padded "
        "index_copy_, is printed beside it in a graph)")
    notes["segment_softmax_bwd bf16"] += "; library n/a: torch has no sparse softmax VJP call"
    for wl in SHORT_WLS:
        for k in WL_KERNELS:
            meta[instance_name(k, wl)] = meta[k]
            notes[instance_name(k, wl)] = (
                f"{k} at walk length {wl} (the walk-length ablation), timed at the bgp "
                f"microbatch (8192 targets, H = 64) and held at cornell's full width too; "
                f"launches from phase 20's ablation_length cornell round at wl = {wl}")
    for k in PATTERN_KERNELS:
        name = instance_name(k, nw=PATTERN_NW, agg="sum")
        meta[name] = meta[k]
        notes[name] = (f"{k} under the sum readout (AGG = SUM) on {PATTERN_NW} uniform walks a "
                       f"node at wl = {PATTERN_WL}, the path-pattern graph's {PATTERN_N} nodes "
                       "(H = 64); launches from phase 20's ablation_pattern round at wl = "
                       f"{PATTERN_WL}")

    with Phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        say(f"  device: {kind}; count {torch.cuda.device_count()}")
        say(smi)
        say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}")

    with Phase("1 build"):
        path, report = build.build()
        say(f"  library: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line or line.startswith("==")):
                say("  " + line.strip())
        build.library()
        for H in (HIDDEN, NBA_HIDDEN):
            say(f"  K3 tile at H = {H}: " + ", ".join(
                f"{k} {v}" for k, v in K.encode_tile(H).items()))
        say(f"  K3 bf16 tile at H = {HIDDEN}: " + ", ".join(
            f"{k} {v}" for k, v in K.encode_tile(HIDDEN, True).items()))
        check_tensor_cores()

    gen = torch.Generator(device=dev).manual_seed(0)
    with Phase("2 kernels vs plain (bgp, one 8192-target request)"):
        z = np.load(BGP)
        g = Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], prob=z["prob"],
                  name="bgp_standin")
        X = torch.from_numpy(z["x"]).to(dev)
        C = int(z["y"].max()) + 1
        ps = PathSampler.build(g, NW, WL, device=dev)
        spec = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL)
        model = PathNet(spec, device=dev, generator=torch.Generator().manual_seed(0))
        order = np.random.default_rng(0).permutation(g.n)
        idx = torch.from_numpy(order[:REQUEST].astype(np.int32)).to(dev)
        u = draw_uniforms(WL, REQUEST * NW, gen, dev)
        check_kernels("bgp", ps, model, X, idx, u, rec, timed=True)
        # the training path's grid: every node a start, once an epoch
        every = torch.arange(g.n, dtype=torch.int32, device=dev)
        ua = draw_uniforms(WL, g.n * NW, gen, dev)
        check_walk_dists(f"bgp, all {g.n} nodes", ps.sampler, every, ua, NW,
                         K.walk_dists_plain(ps.sampler.nbr, ps.sampler.cdf, ps.sampler.deg,
                                            ps.sampler.srt, every, ua, NW), rec)
        say(f"  bgp, all {g.n} nodes as starts: walk_dists exact")
        del every, ua

    with Phase("3 serve bgp stand-in"):
        requests = np.resize(order, 8 * REQUEST).reshape(8, REQUEST)
        if len(np.unique(requests)) != g.n:
            raise AssertionError("the requests do not cover every node")
        K.reset_launch_counts()
        times = []
        for r in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logp = predict(model, X, ps, gen, idx=r)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if logp.shape != (REQUEST, C) or not torch.isfinite(logp).all():
                raise AssertionError("non-finite or misshapen log-probs")
            dev_lse = float(torch.logsumexp(logp, dim=-1).abs().max())
            if dev_lse > 1e-5:
                raise AssertionError(f"rows do not normalise: |logsumexp| {dev_lse}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp = predict(model, X, ps, gen, idx=order[:1024], num_ensemble=4)
        torch.cuda.synchronize()
        ens_ms = (time.perf_counter() - t0) * 1e3
        if not torch.isfinite(logp).all() or float(
                torch.logsumexp(logp, dim=-1).abs().max()) > 1e-5:
            raise AssertionError("ensemble log-probs are not finite or do not normalise")
        counts = K.launch_counts()
        say(f"  launches: {counts}")
        serving = {name: 8 + 4 if name in FORWARD_PATH else 0 for name in KERNELS}
        if counts != serving:
            raise AssertionError(f"serving launch counts {counts}, the path makes {serving}")
        med = float(np.median(times))
        say(f"  8 x {REQUEST}-target requests: ms " + ", ".join(f"{t:.2f}" for t in times)
            + f"; median {med:.2f} ms, {REQUEST / med * 1e3:.0f} targets/s "
            "(first request included)")
        say(f"  1024 targets x num_ensemble 4: {ens_ms:.2f} ms")

    with Phase("4 cornell at full width"):
        gc = Graph.from_edge_input(CORNELL, name="cornell")
        Xc_np = np.random.default_rng(0).normal(size=(gc.n, 1703)).astype(np.float32)
        Xc = torch.from_numpy(Xc_np).to(dev)
        psc = PathSampler.build(gc, NW, WL, device=dev)
        specc = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL)
        mc = PathNet(specc, device=dev, generator=torch.Generator().manual_seed(1))
        allc = torch.arange(gc.n, dtype=torch.int32, device=dev)
        uc = draw_uniforms(WL, gc.n * NW, gen, dev)
        check_kernels("cornell", psc, mc, Xc, allc, uc, rec, timed=False)
        K.reset_launch_counts()
        logp = predict(mc, Xc, psc, idx=allc, u=uc[None])
        torch.cuda.synchronize()
        counts = K.launch_counts()
        if counts != {name: int(name in FORWARD_PATH) for name in KERNELS}:
            raise AssertionError(f"cornell request launch counts {counts}, expected 1 "
                                 "of each forward kernel")
        ps_host = PathSampler.build(gc, NW, WL, device="cpu")
        m_host = PathNet(specc, device="cpu")
        m_host.load_state_dict({k: v.cpu() for k, v in mc.state_dict().items()})
        logp_host = predict(m_host, torch.from_numpy(Xc_np), ps_host,
                            idx=allc.cpu(), u=uc[None].cpu())
        err = float((logp.cpu() - logp_host).abs().max())
        say(f"  predict on the card vs the host (same draws): max abs err {err:.3e}")
        if not torch.isfinite(logp).all() or err > K3_TOL:
            raise AssertionError(f"cornell log-probs differ from the host's by {err}")

    with Phase("5 training kernels vs plain (bgp, one 8192-target microbatch)"):
        spec5 = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL,
                         dropout=0.7)
        model5 = PathNet(spec5, device=dev, generator=torch.Generator().manual_seed(0))
        check_training_kernels(ps, model5, X, idx, u, gen, rec)
        del model5

    with Phase(f"6 train bgp stand-in ({EPOCHS} epochs)"):
        y = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
        masks = get_whole_mask(z["y"], seed=1)
        chunks = [-(-int(m.sum()) // REQUEST) for m in masks]
        say(f"  train / val / test nodes {[int(m.sum()) for m in masks]}, "
            f"{chunks} microbatches of {REQUEST}")
        cfg = TrainConfig(epochs=EPOCHS, microbatch=REQUEST)
        spec6 = PaggSpec(feat_dim=X.shape[1], hidden=HIDDEN, out_dim=C, walk_len=WL,
                         dropout=0.7)
        K.reset_launch_counts()
        res = run_round(X, y, ps, spec6, cfg, *masks, C, seed=0, track_history=True,
                        keep_params=True)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        best, improved = 0.0, 0
        for acc in res.history:
            if acc > best:
                best, improved = float(acc), improved + 1
        fwd = EPOCHS * (chunks[0] + chunks[1]) + improved * chunks[2]
        expect = {"cdf_walk": 0, "membership_dists": 0, "walk_dists": EPOCHS,
                  "pagg_encode_fwd": fwd, "row_gather": fwd,
                  "pagg_encode_bwd": EPOCHS * chunks[0], "segment_sum": EPOCHS * chunks[0],
                  "row_gather_bwd": EPOCHS * chunks[0], "lane_gather": 0, "khop_dists": 0,
                  "walk_khop_dists": 0, "alias_walk": 0, "alias_walk_dists": 0,
                  "alias_walk_khop_dists": 0, "spmm": 0, "edge_dot": 0, "segment_softmax": 0,
                  "segment_softmax_bwd": 0, "pagg_contract": EPOCHS * chunks[0]}
        say(f"  launches: {counts} ({improved} epochs improved on validation)")
        if counts != expect:
            raise AssertionError(f"training launch counts {counts}, the path makes {expect}")
        for name, c in counts.items():
            rec[name]["launches"] = c
        if not np.isfinite(res.losses).all():
            raise AssertionError(f"non-finite training loss {res.losses}")
        if res.best_val_acc != float(res.history.max()):
            raise AssertionError("best_val_acc is not the best validation accuracy")
        init = PathNet(spec6, device=dev, generator=make_generator(0, 0, STREAM_INIT))
        moved = [k for k, v in init.state_dict().items()
                 if not torch.equal(v, res.best_params[k])]
        if not moved:
            raise AssertionError("no parameter moved")
        say(f"  loss per epoch {res.losses.tolist()}, val acc {res.history.tolist()}, "
            f"best {res.best_val_acc:.4f}, test acc {res.metrics['accuracy']:.4f}")
        epoch_ms = [t * 1e3 for t in res.epoch_seconds]
        say(f"  ms per epoch {', '.join(f'{t:.2f}' for t in epoch_ms)}; median of "
            f"epochs 2-{EPOCHS}: {float(np.median(epoch_ms[1:])):.2f} ms")
        paths6, dists6 = ps.sample(generator=gen)
        ic, wc, total = chunk_index(masks[0], REQUEST, dev)
        grad_ms = time_ms(lambda: chunked_grads(init, X, y, paths6, dists6, ic[:1], wc[:1],
                                                total, dropout_gen=lambda i: gen), 5)
        say(f"  one {REQUEST}-target microbatch grad (forward K3 + K5, backward K4 + "
            f"K5, weight contractions): {grad_ms:.2f} ms")
        # the last train microbatch: its padding targets' walks and ego rows
        # are one long run to node 0
        pad = int((wc[-1] == 0).sum())
        p_last = ps.sample(ic[-1], u=draw_uniforms(WL, REQUEST * NW, gen, dev))[0]
        rows_last = torch.randn(((WL + 1) * REQUEST * NW, HIDDEN), generator=gen, device=dev)
        check_segment_sum(f"bgp last train microbatch ({pad} padding targets at node 0)",
                          p_last, rows_last, g.n, rec, "segment_sum, padded microbatch")
        del res, init, paths6, dists6, p_last, rows_last

    with Phase("7 cornell training step at full width"):
        trc = ratio_masks(gc.n, 1000, val_size=59)[0]
        idx7 = torch.from_numpy(np.flatnonzero(trc).astype(np.int32))
        yc = torch.from_numpy(np.random.default_rng(1).integers(0, 5, size=gc.n))
        spec7 = PaggSpec(feat_dim=1703, hidden=HIDDEN, out_dim=5, walk_len=WL, dropout=0.7)
        step_card_vs_host("cornell", spec7, dev, (psc, ps_host), (Xc, torch.from_numpy(Xc_np)),
                          idx7, yc)
        pc = psc.sample(u=uc)[0]
        rows7 = torch.randn(((WL + 1) * gc.n * NW, HIDDEN), generator=gen, device=dev)
        check_segment_sum(f"cornell, all {gc.n} nodes", pc, rows7, gc.n, rec)

    with Phase("7b seeded rounds twice (cornell 30 epochs, bgp stand-in 2 epochs)"):
        check_reproducible(dev, gc, Xc, X, z, psc, ps)

    with Phase("8 gather probe and the launch floor"):
        floor_ms = graph_ms(lambda: build.empty_launch(dev), 200)
        say(f"  launch floor: an empty kernel, {floor_ms:.5f} ms per launch in a CUDA graph")
        check_gather_probe(dev, gen, rec)

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        with Phase("9 payloads and MERW"):
            make_payloads(root, dev, z)

        with Phase(f"10 cornell protocol ({CORNELL_ROUNDS} x {PROTOCOL_EPOCHS})"):
            run_protocol_cli("cornell", root, tmp, CORNELL_ROUNDS, HIDDEN, CORNELL_BAND,
                             round_band=True)

        with Phase(f"11 Nba at H = {NBA_HIDDEN} ({NBA_ROUNDS} x {PROTOCOL_EPOCHS})"):
            check_wide_encode(root, dev, gen, rec)
            run_protocol_cli("Nba", root, tmp, NBA_ROUNDS, NBA_HIDDEN, NBA_BAND,
                             round_band=True)

        with Phase(f"12 homo: cora kernels, cora {CORA_ROUNDS} x {PROTOCOL_EPOCHS}, citeseer "
                   f"{CITESEER_ROUNDS} x {PROTOCOL_EPOCHS}"):
            check_homo_kernels(root, dev, gen, rec)
            counts = run_protocol_cli("cora", root, tmp, CORA_ROUNDS, HIDDEN, CORA_BAND,
                                      HOMO_PAYLOADS["cora"], round_band=True)
            for name in HOMO_KERNELS:
                rec[homo_name(name, True)]["launches"] = counts[name]
            run_protocol_cli("citeseer", root, tmp, CITESEER_ROUNDS, HIDDEN, CITESEER_BAND,
                             HOMO_PAYLOADS["citeseer"], round_band=True)

        with Phase(f"13 bf16: kernels (bgp, cora), card vs host, seeded rounds, bgp "
                   f"{BGP_ROUNDS} x {PROTOCOL_EPOCHS}, cora {CORA_BF16_ROUNDS} x "
                   f"{PROTOCOL_EPOCHS}"):
            check_bf16_kernels(root, dev, gen, rec, X, ps, idx, u, C)
            check_bf16_host(dev, X, ps, z, C, gc, Xc_np, psc, ps_host)
            check_reproducible(dev, gc, Xc, X, z, psc, ps, "bfloat16")
            counts = run_protocol_cli("bgp", root, tmp, BGP_ROUNDS, HIDDEN, BGP_BAND,
                                      BGP_PAYLOAD, "bfloat16", BGP_MICROBATCH,
                                      round_band=True)
            for name in HOMO_KERNELS:
                rec[homo_name(name, False, True)]["launches"] = counts[name]
            counts = run_protocol_cli("cora", root, tmp, CORA_BF16_ROUNDS, HIDDEN, CORA_BAND,
                                      HOMO_PAYLOADS["cora"], "bfloat16")
            for name in HOMO_KERNELS:
                rec[homo_name(name, True, True)]["launches"] = counts[name]

        with Phase(f"14 GRU and mean/sum readouts: kernels (bgp, cora), card vs host, seeded "
                   f"GRU rounds, cora and citeseer --agg mean, cornell --rnn gru, cornell "
                   f"--agg sum, cora --rnn gru"):
            check_choice_kernels(root, dev, gen, rec, X, ps, idx, u, C)
            check_choice_host(dev, gc, Xc_np, psc, ps_host)
            check_reproducible(dev, gc, Xc, X, z, psc, ps, rnn="gru")
            counts = run_protocol_cli("cora", root, tmp, CORA_MEAN_ROUNDS, HIDDEN,
                                      CORA_MEAN_BAND, HOMO_PAYLOADS["cora"], agg="mean",
                                      round_band=True)
            rec["pagg_readout mean"]["launches"] = counts["pagg_encode_fwd"]
            rec["pagg_attention_bwd mean"]["launches"] = counts["pagg_encode_bwd"]
            run_protocol_cli("citeseer", root, tmp, CITESEER_MEAN_ROUNDS, HIDDEN,
                             CITESEER_MEAN_BAND, HOMO_PAYLOADS["citeseer"], agg="mean",
                             round_band=True)
            counts = run_protocol_cli("cornell", root, tmp, CORNELL_GRU_ROUNDS, HIDDEN,
                                      CORNELL_GRU_BAND, CORNELL_PAYLOAD, rnn="gru",
                                      round_band=True)
            for name in HOMO_KERNELS:
                rec[homo_name(name, False, cell="gru")]["launches"] = counts[name]
            counts = run_protocol_cli("cornell", root, tmp, 1, HIDDEN, None, agg="sum")
            rec["pagg_readout sum"]["launches"] = counts["pagg_encode_fwd"]
            rec["pagg_attention_bwd sum"]["launches"] = counts["pagg_encode_bwd"]
            counts = run_protocol_cli("cora", root, tmp, 1, HIDDEN, None, rnn="gru")
            for name in HOMO_KERNELS:
                rec[homo_name(name, True, cell="gru")]["launches"] = counts[name]

        with Phase(f"15 walk length {WL5}: K7 (cornell, Nba, cora), the dense and host "
                   f"backends, K3 and K4 at wl = {WL5}, card vs host, cornell -wl {WL5} "
                   f"{CORNELL_WL5_ROUNDS} x {PROTOCOL_EPOCHS}"):
            check_khop(root, dev, gen, rec, floor_ms)
            counts = run_protocol_cli("cornell", root, tmp, CORNELL_WL5_ROUNDS, HIDDEN,
                                      CORNELL_WL5_BAND, CORNELL_PAYLOAD, round_band=True,
                                      wl=WL5)
            for name in KHOP_KERNELS:
                rec[name]["launches"] = counts[name]

        with Phase(f"16 the sampler: K8 (bgp, cornell), its transitions, uniform walks (bgp, "
                   f"cornell, Nba, cora), a cornell alias round, cornell -mk uniform "
                   f"{CORNELL_UNIFORM_ROUNDS} x {PROTOCOL_EPOCHS}"):
            check_sampler(root, dev, gen, rec, z, ps, idx, floor_ms)
            run_protocol_cli("cornell", root, tmp, CORNELL_UNIFORM_ROUNDS, HIDDEN,
                             CORNELL_UNIFORM_BAND, CORNELL_PAYLOAD, round_band=True,
                             marker="uniform")

        with Phase(f"17 the remaining model choices: MLP, bf16 GRU and quirk kernels (bgp, "
                   f"cora, cornell), card vs host, seeded MLP rounds, cornell --rnn mlp, "
                   f"--quirk-compat and --rnn gru --dtype bfloat16 {REMAINING_ROUNDS} x "
                   f"{PROTOCOL_EPOCHS} each, cora --rnn mlp"):
            check_remaining_kernels(root, dev, gen, rec, X, ps, idx, u, C, gc, Xc, uc, psc)
            check_remaining_host(dev, gc, Xc_np, psc, ps_host)
            check_reproducible(dev, gc, Xc, X, z, psc, ps, rnn="mlp")
            for band, kw, names in (
                    (CORNELL_MLP_BAND, dict(rnn="mlp"),
                     [homo_name(n, False, cell="mlp") for n in HOMO_KERNELS]),
                    (CORNELL_QUIRK_BAND, dict(quirk=True), [f"{n} quirk" for n in HOMO_KERNELS]),
                    (CORNELL_GRU_BF16_BAND, dict(rnn="gru", dtype="bfloat16"),
                     [homo_name(n, False, True, "gru") for n in HOMO_KERNELS])):
                counts = run_protocol_cli("cornell", root, tmp, REMAINING_ROUNDS, HIDDEN, band,
                                          CORNELL_PAYLOAD, round_band=True, **kw)
                for name, kernel in zip(names, HOMO_KERNELS):
                    rec[name]["launches"] = counts[kernel]
            counts = run_protocol_cli("cora", root, tmp, 1, HIDDEN, None, rnn="mlp")
            for name in HOMO_KERNELS:
                rec[homo_name(name, True, cell="mlp")]["launches"] = counts[name]

        with Phase(f"18 the baseline zoo: S1-S4 (bgp stand-in), every model card vs host "
                   f"(cornell), bgp GCN and GAT epochs, seeded GCN and GAT rounds, cornell "
                   f"--model mlp, gcn, gat {BASELINE_ROUNDS} x {PROTOCOL_EPOCHS} each, --model lp"):
            check_baseline_kernels(z, dev, gen, rec)
            check_baselines_host(dev, gc, Xc_np)
            f32_epoch_ms = check_baseline_training(dev, z, gc, Xc_np)
            for model in ("mlp", "gcn", "gat"):
                band, payload, hidden = BASELINE_BANDS[("cornell", model)]
                counts = run_baseline_cli("cornell", model, root, tmp, BASELINE_ROUNDS, hidden,
                                          band, payload, round_band=True)
            for name in BASELINE_KERNELS:
                rec[name]["launches"] = counts[name]   # the GAT round's
            run_baseline_cli("cornell", "lp", root, tmp, 1, HIDDEN, None, CORNELL_PAYLOAD)

        with Phase(f"19 the bf16 zoo: S1-S4's bf16 instances (bgp stand-in), every model at "
                   f"bf16 card vs host (cornell), bgp GCN and GAT bf16 epochs, seeded bf16 GCN "
                   f"and GAT rounds, cornell --model gcn, gat, fagcn --dtype bfloat16 "
                   f"{BASELINE_ROUNDS} x {PROTOCOL_EPOCHS} each"):
            check_bf16_baseline_kernels(z, dev, gen, rec, notes)
            check_baselines_host(dev, gc, Xc_np, BF16_HOST_TOL, "bfloat16")
            bf16_epoch_ms = check_baseline_training(dev, z, gc, Xc_np, "bfloat16")
            say("  bgp stand-in ms per epoch, bf16 against f32: " + ", ".join(
                f"{m} {bf16_epoch_ms[m]:.3f} against {f32_epoch_ms[m]:.3f}" for m in bf16_epoch_ms))
            launches = run_bf16_baselines(root, tmp)
            for name in BASELINE_BF16_KERNELS:
                rec[name]["launches"] = launches[name]

        with Phase(f"20 host utilities and runners: kernels at wl = {SHORT_WLS} (bgp, cornell) "
                   f"and nw = {PATTERN_NW} sum (the pattern graph), merw extras and init_rw "
                   f"(cora, cornell), utils.trace, ablation_length, ablation_pattern, comparison_table, "
                   f"protocol_all ({', '.join(SWEEP_BANDS)}), "
                   f"{', '.join(b[0] for b in BAND_PROTOCOLS)} 1 x {PROTOCOL_EPOCHS} each"):
            check_new_shapes(dev, gen, rec, z, X, C, order, gc, Xc)
            check_host_utils(root, tmp, dev)
            check_trace(tmp, dev)
            run_runners(root, tmp, dev, rec)
            for name, hidden, band, payload, dtype, mb in BAND_PROTOCOLS:
                if name in BAND_KERNEL_CHECKS:
                    check_band_kernels(name, root, dev, gen, rec, hidden, dtype)
                run_protocol_cli(name, root, tmp, 1, hidden, band, payload, dtype, mb,
                                 round_band=True)

        with Phase(f"21 the multi-device layer: one NCCL rank (bgp stand-in: the sharded "
                   f"step through {', '.join(EXCHANGES)}, make_sharded_predict, the kernels "
                   f"on sharded inputs), two gloo ranks on one card (cornell steps, two "
                   f"seeded {MESH_ROUND_EPOCHS}-epoch rounds)"):
            for name, err in check_mesh(root).items():
                record_err(rec, name, err)

    say(smi)
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         **({"library_eager": True} if r.get("library_eager") else {}),
         **({"f32_bound_ms": r["f32_bound_ms"]} if "f32_bound_ms" in r else {}),
         **({"f32_ms": r["f32_ms"]} if "f32_ms" in r else {}),
         **({"note": notes[name]} if name in notes else {})}
        for name, r in rec.items()]}))
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--cards"]:
            rc = check_cards(int(sys.argv[2]))
        elif sys.argv[1:]:
            print(f"chip_smoke: unknown arguments {sys.argv[1:]} (--cards N or none)",
                  file=sys.stderr)
            rc = 2
        else:
            rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
