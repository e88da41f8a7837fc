"""jukebox — playlist music player (the port's copy of the repo's
``jukebox/``)."""
