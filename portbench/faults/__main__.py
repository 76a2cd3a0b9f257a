import sys

from portbench.faults import main

sys.exit(main())
