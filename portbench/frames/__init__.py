"""Frame families: the port's frame functions the benchmark drives, one
file each, found by the name a configuration gives as ``"frame"`` (``miso``
without one; see ``spec.py``). A family module gives the harness:

* ``build(link_cfg, n_iters, device, **frame_args) -> frame_fn(snr_db,
  draws)``: the port's own frame function, on its normal path;
* ``draw_round(link, frames, seed, idx, device, **frame_args) -> dict``:
  one round's draws from a generator seeded by ``traffic.round_seed(seed,
  idx)``, every tensor with the frame axis first (``traffic.make_pool`` and
  ``traffic.gather`` take them as they are);
* ``to_draws(draws)``: the port's draw tuple of such a dict;
* ``counters(frame_counters) -> [B, ..., n_iters + 2]``: the frame's
  counters ``[clean, pass 0 .. pass n_iters]``, in one launch.

``frame_args`` are the family's fixed arguments, from the configuration's
``"frame_args"``; the reference's ``frame_counters`` takes them too.
"""
