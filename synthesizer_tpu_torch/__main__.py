"""``python -m synthesizer_tpu_torch out.wav``: render config 5 on the GPU."""

import sys

from .bench_song import main

if __name__ == "__main__":
    sys.exit(main())
