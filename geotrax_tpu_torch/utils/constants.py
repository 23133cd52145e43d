"""Global constants: the port's copy of ``geotrax_tpu/utils/constants.py``
(platform flags, the video and result formats the stages recognise, the
plotting stage's data-quality alert thresholds, the bundled detector's
class taxonomy)."""

import sys

IS_LINUX = sys.platform.startswith("linux")
IS_MACOS = sys.platform == "darwin"
IS_WINDOWS = sys.platform in ("win32", "cygwin")

# Video containers the pipeline will ingest.
VIDEO_FORMATS = {".mp4", ".mov", ".avi", ".mkv"}

# Result-file extensions recognized when scanning output folders.
RESULTS_FORMATS = {".txt", ".csv"}

# Data-quality alert thresholds used by the plotting stage.
SPEED_ALERT_KMH = 90.0
ACCELERATION_ALERT_MS2 = 5.0

# Vehicle classes (fixed taxonomy of the bundled detector).
CLASS_NAMES = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
