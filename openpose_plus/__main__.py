import sys

from openpose_plus.cli import main

sys.exit(main())
