"""``correct`` for the lossless cells, from the files' bytes and the
reference alone.  Every file of the window is read back:

* ``unreadable_files``: files whose container or arithmetic streams do not
  parse, or whose header disagrees with what was served (exact: 0);
* ``pixel_errors``: 8-bit pixels that the reference's decode (latents
  replayed from seed and indices, the generative pass, the residual) gets
  wrong against the served image (exact: 0);
* ``recon_gap``: the widest gap between the reference's reconstruction
  and the encoder's own: the sample the encoder coded is the replay of the
  indices it chose, so the file must hold those indices;
* ``search_gap`` and ``count_gap`` (``reference/search.py``): the
  reference's posteriors of the served image, given the blocks before,
  against what the file codes: per latent block, how far the objective of
  the file's sample falls short of a plain beam search's at the stated B,
  S and Omega, and whether the block's partition count (the code length)
  is the one its KL gives.

The container's header must state the configuration's S (``max_index``).
"""

from __future__ import annotations

import numpy as np
import torch


def check_files(drv) -> dict:
    from reference import ac, beam, rvae, search

    rvae.full_precision()
    dev = drv.devs[0]
    c = drv.coder_cfg
    mc = drv.config["model"]
    n_blocks = mc["num_res_blocks"]
    H, W = drv.shape[:2]
    cfg = beam.BeamConfig(c["kl_per_partition"], c["n_beams"],
                          c["extra_samples"], c["block_size"],
                          c["max_partitions"], c["stream"])
    unreadable, recs, picked = 0, [], []
    for d in drv.done:
        try:
            rec = ac.read_rec(d["bytes"], c["max_partitions"])
        except ac.FormatError:
            unreadable += 1
            continue
        if (rec.seed != d["seed"] or rec.shape != tuple(drv.shape)
                or rec.max_index != cfg.n_samples or rec.residual is None
                or len(rec.latents) != n_blocks):
            unreadable += 1
            continue
        recs.append(rec)
        picked.append(d)

    p = {k: v.to(dev) for k, v in drv.weights.items()}
    example, noise = drv.ddi_inputs(dev)
    rvae.data_dependent_init(p, n_blocks, example, noise)

    tally = search.Tally()

    def replay(g, priors, posteriors, seeds):
        ind = np.stack([r.latents[g][0] for r in recs])
        cnt = np.stack([r.latents[g][1] for r in recs])
        judged = search.judge(cfg, posteriors, priors, ind, cnt, seeds)
        tally.add(judged)
        return judged["sample"]

    pixel_errors, recon_gap, bad_images = 0, 0.0, 0
    if recs:
        images = torch.as_tensor(np.stack([d["image"] for d in picked]),
                                 dtype=torch.float32, device=dev)
        with torch.no_grad():
            recons = rvae.decode(p, n_blocks, replay, (H, W),
                                 [r.seed for r in recs], images)
        for k, (rec, d) in enumerate(zip(recs, picked)):
            recon = recons[k][0].cpu().numpy()
            recon_gap = max(recon_gap, float(np.max(np.abs(
                recon - d["enc_recon"]))))
            try:
                levels = ac.decode_residual(rec.residual, recon)
                wrong = int(np.sum(levels != ac.quantize(d["image"] + 0.5)))
            except ac.FormatError:
                wrong = int(np.prod(drv.shape))
            pixel_errors += wrong
            bad_images += wrong > 0
    numbers = {
        "unreadable_files": unreadable,
        "pixel_errors": pixel_errors,
        "recon_gap": recon_gap if recs else 1.0,
        **tally.numbers(),
    }
    return {"numbers": numbers, "checked": len(drv.done),
            "failed": unreadable + bad_images}
