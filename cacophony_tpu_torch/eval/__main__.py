from cacophony_tpu_torch.eval.cli import main

if __name__ == "__main__":
    main()
