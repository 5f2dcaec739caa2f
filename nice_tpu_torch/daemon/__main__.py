from nice_tpu_torch.daemon.main import main
from nice_tpu_torch.obs import flight

if __name__ == "__main__":
    flight.install()  # the process's crash and SIGUSR2 dumps
    raise SystemExit(main())
