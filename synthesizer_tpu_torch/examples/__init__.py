"""Runnable examples of the port, each with a ``main()`` and a ``--device``
option (the card by default):

    python -m synthesizer_tpu_torch.examples.fm_bell [outdir]
    python -m synthesizer_tpu_torch.examples.midi_demo [outdir]
    python -m synthesizer_tpu_torch.examples.render_server_demo [outdir]
    python -m synthesizer_tpu_torch.examples.sharded_mixdown [out.wav]

Add ``--device cpu`` on a machine without a card.  The demo and tracker
kits are ``bench_song.make_demo_kit`` / ``make_tracker_kit``."""
