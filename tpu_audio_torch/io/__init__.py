"""Host I/O: settings files, WAV files and IR index files."""
