"""The port's applications: the trackmixer CLI, the keyboard synthesizer
and the jukebox (counterparts of the repo's ``trackmixer.py``,
``keyboard_gui.py`` and ``jukebox/``).  Each renders on the device it is
given, the card unless the caller asks for the CPU."""
