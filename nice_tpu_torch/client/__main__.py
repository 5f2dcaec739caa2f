import sys

from nice_tpu_torch.client.main import main
from nice_tpu_torch.obs import flight

flight.install()  # the process's crash and SIGUSR2 dumps
sys.exit(main())
