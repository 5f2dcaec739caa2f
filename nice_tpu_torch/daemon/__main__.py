from nice_tpu_torch.daemon.main import main

if __name__ == "__main__":
    raise SystemExit(main())
