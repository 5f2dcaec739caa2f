import sys

from nice_tpu_torch.client.main import main

sys.exit(main())
